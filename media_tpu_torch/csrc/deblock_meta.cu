// The deblocking filter's per-MB meta (strengths, tc0, alpha and beta of
// every edge) of one picture, for sm_90a.
//
// Replaces the strength-and-threshold build that the JAX package compiles
// with XLA inside its frame deblocking function,
// media_tpu/pipeline/deblock_apply.py:_deblock_frame_wavemajor (:209-266,
// fed by :583 deblock_pframe_from_symbols and :606 deblock_iframe; no
// Pallas kernel), whose plain PyTorch twin is
// media_tpu_torch/pipeline/deblock_apply.py:build_meta over pframe_bs_grids
// or intra_bs_grids: some 80 eager device activities a 1080p picture, and an
// int32 copy of the whole symbol tensor. Its output is what kernels 1 and 2
// (csrc/deblock_wave.cu, csrc/deblock_wave_step.cu) read. The arithmetic
// per MB is deblock_meta.cuh's.
//
// Bound on the card: at 1080p the kernel reads the MV and the 256 luma
// levels of every MB once (int16, about 4.2 MB, the neighbours' blocks a
// second time from the caches) and writes the (R C, 120) int32 meta (3.9
// MB): some 2.4 us at the memory rate; its arithmetic, a few compares and
// a table lookup a column, is far less. The design is the simple one: a
// block of 128 threads per MB, a thread per block flag and MV in the first
// stage, a thread per meta column in the second (each warp writes 128
// consecutive bytes).

#include <cuda_runtime.h>
#include <stdint.h>

#include "deblock_meta.cuh"

namespace {

using namespace media_dmeta;

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) deblock_meta_kernel(Args a) {
  __shared__ Smem s;
  mb_meta(a, blockIdx.x, s, threadIdx.x, blockDim.x);
}

}  // namespace

// The (R C, 120) int32 meta of an (R, C) MB picture; see deblock_meta.cuh's
// Args for the pointers (device memory). Enqueues one kernel on `stream`;
// returns a cudaError_t.
extern "C" int deblock_meta_launch(const int16_t* symbols, const int32_t* qp,
                                   int qp_value, const int32_t* qp_c,
                                   int qp_c_value, const int32_t* qp_map,
                                   const uint8_t* slice_start,
                                   const int32_t* tab, int32_t* meta, int R,
                                   int C, int intra, void* stream) {
  if (R <= 0 || C <= 0 || (!intra && !symbols))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.symbols = symbols;
  a.qp = qp, a.qp_value = qp_value, a.qp_c = qp_c, a.qp_c_value = qp_c_value;
  a.qp_map = qp_map, a.slice_start = slice_start, a.tab = tab, a.meta = meta;
  a.R = R, a.C = C, a.intra = intra;
  deblock_meta_kernel<<<(unsigned)(R * C), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
