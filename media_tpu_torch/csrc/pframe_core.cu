// The P-frame core of the encoder (motion search, sub-pel refinement, chroma
// MC, transform, quant, reconstruction) for sm_90a.
//
// Replaces the P core that the JAX package compiles with XLA,
// media_tpu/pipeline/pframe_core.py:local_pframe_core (no Pallas kernel: XLA
// fuses it into the P batch's program), whose plain PyTorch twin is
// media_tpu_torch/pipeline/pframe_core.py:local_pframe_core_plain. That twin
// runs as some 770 eager launches a 1080p frame; this is one memset and one
// kernel. The arithmetic per MB is pframe_core.cuh's.
//
// Bound on the card: at 1080p the core reads the uint8 current and
// reference planes once (about 6 MB; 25 MB as int32 extended planes, which
// callers that hand int32 still use) and writes the int16 symbols and the
// uint8 recon (about 9 MB): some 0.005 ms at the memory rate; its absolute
// differences, (2rs+1)^2 + 49 candidates of 256 samples a MB, are about
// 7e8 operations, 0.01-0.03 ms at the ALU rate. The encoder and the row
// tiles hand their uint8 planes as they are, and the encoder its reference
// without a halo, whose rows the kernel clamps: no cast or pad runs before
// it. The design is the
// simple one: a block of 256 threads per MB, the MB's window of the
// reference in shared memory (each sample read once from device memory
// and some 300 times from shared memory), a thread per candidate in both
// searches, a thread per 4x4 block in the transforms. The search alone
// (search_refine_luma, also the B core's) is the same kernel with the
// coding stages off.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pframe_core.cuh"

namespace {

using namespace media_pcore;

constexpr int kThreads = 256;

template <typename Pix>
__global__ void __launch_bounds__(kThreads) pframe_core_kernel(Args<Pix> a) {
  extern __shared__ int smem[];
  const Smem s(smem, a.rs);
  mb_pframe(a, blockIdx.x, s, threadIdx.x, blockDim.x);
}

template <typename Pix>
int launch(const Args<Pix>& a, void* stream) {
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (a.sad_total) {
    const cudaError_t err = cudaMemsetAsync(a.sad_total, 0, 4, cs);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = sizeof(int) * (size_t)Smem::ints(a.rs);
  pframe_core_kernel<Pix><<<(unsigned)(a.R * a.C), kThreads, smem, cs>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The P core of an (R, C) MB grid on int32 planes, the reference extended;
// see pframe_core.cuh's Args for the pointers and strides (device memory;
// the tables those of transform._tables). Enqueues a memset of sad_total
// and one kernel on `stream`; returns a cudaError_t.
extern "C" int pframe_core_launch(
    const int32_t* cur_y, const int32_t* cur_u, const int32_t* cur_v,
    const int32_t* ref_y, const int32_t* ref_u, const int32_t* ref_v,
    const int64_t* strides, const int32_t* qp, int qp_stride, int qp_value,
    const int32_t* qp_c, int qp_c_stride, int qp_c_value, const int32_t* mf,
    const int32_t* v, const int64_t* zz, int16_t* symbols, uint8_t* recon_y,
    uint8_t* recon_u, uint8_t* recon_v, int32_t* sad_total, int R, int C,
    int rs, void* stream) {
  if (R <= 0 || C <= 0 || rs < 0 || rs > kMaxRange)
    return (int)cudaErrorInvalidValue;
  return launch(core_args(cur_y, cur_u, cur_v, ref_y, ref_u, ref_v, strides,
                          qp, qp_stride, qp_value, qp_c, qp_c_stride,
                          qp_c_value, mf, v, zz, symbols, recon_y, recon_u,
                          recon_v, sad_total, R, C, rs, 0),
                stream);
}

// The same on uint8 planes: the reference extended (whole = 0) or the
// picture alone, its rows clamped (whole = 1).
extern "C" int pframe_core_u8_launch(
    const uint8_t* cur_y, const uint8_t* cur_u, const uint8_t* cur_v,
    const uint8_t* ref_y, const uint8_t* ref_u, const uint8_t* ref_v,
    const int64_t* strides, const int32_t* qp, int qp_stride, int qp_value,
    const int32_t* qp_c, int qp_c_stride, int qp_c_value, const int32_t* mf,
    const int32_t* v, const int64_t* zz, int16_t* symbols, uint8_t* recon_y,
    uint8_t* recon_u, uint8_t* recon_v, int32_t* sad_total, int R, int C,
    int rs, int whole, void* stream) {
  if (R <= 0 || C <= 0 || rs < 0 || rs > kMaxRange)
    return (int)cudaErrorInvalidValue;
  return launch(core_args(cur_y, cur_u, cur_v, ref_y, ref_u, ref_v, strides,
                          qp, qp_stride, qp_value, qp_c, qp_c_stride,
                          qp_c_value, mf, v, zz, symbols, recon_y, recon_u,
                          recon_v, sad_total, R, C, rs, whole),
                stream);
}

// Full-pel search and quarter-pel refinement of (N = R C, 16, 16) current
// MBs against an extended luma plane (row stride ref_row). Enqueues one
// kernel on `stream`; returns a cudaError_t.
extern "C" int pframe_search_launch(const int32_t* cur, const int32_t* ref_y,
                                    long long ref_row, int32_t* qmv,
                                    int32_t* pred, int32_t* cost, int R, int C,
                                    int rs, void* stream) {
  if (R <= 0 || C <= 0 || rs < 0 || rs > kMaxRange)
    return (int)cudaErrorInvalidValue;
  return launch(search_args(cur, ref_y, ref_row, qmv, pred, cost, R, C, rs),
                stream);
}
