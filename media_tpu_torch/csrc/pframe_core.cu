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
// uint8 recon (about 9 MB): some 0.005 ms at the memory rate. Its absolute
// differences, (2rs+1)^2 + 49 candidates of 256 samples a MB, about 7e8 at
// rs 8, are the work: packed four to a word, one integer instruction a
// word (and one a word for the 40 averaged quarter-pel candidates), about
// 2e8 instructions, 0.012 ms at 64 integer lanes an SM a clock.
// The first design took them a sample at a time from int32 shared memory
// (two loads, a subtract, an absolute value and an add each), a thread a
// candidate, 289 candidates on 256 threads: on an H100 the search was 90%
// of its time, bound by shared-memory loads and ALU issue. This one keeps
// the samples as bytes, four to a word (pframe_core.cuh): a quad of four
// neighbouring candidates loads each window word once for all four, one
// VABSDIFF4.U8.ACC takes the SAD of four samples, a funnel shift aligns a
// word to any byte, and a quarter-pel prediction word is one __vavgu4. The
// full-pel items (quad, dy) lie on a warp's lanes in order: the lanes read
// one row of the current MB (a broadcast) and, the window's row pitch equal
// to the quads a row modulo 32, consecutive banks of the window. The loads
// are cp.async, issued all before one wait; the transforms are passes of
// 96 (block, row or column) items over the four warps. A block of 128
// threads takes an MB, its window and work areas in shared memory (14 KB
// at rs 8); __launch_bounds__ holds the uint8 instance to 40 registers, so
// that 12 blocks stay resident on an SM. The measured split (by stage, and
// of the rejected variants) is in PERF.md, from pcore_tune.py, which builds
// patched copies of these sources. The encoder and the row tiles hand their
// uint8 planes as they are, and the encoder its reference without a halo,
// whose rows the kernel clamps: no cast or pad runs before it. The search
// alone (search_refine_luma, also the B core's) is the same kernel with the
// coding stages off.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pframe_core.cuh"

namespace {

using namespace media_pcore;

constexpr int kThreads = 128;  // a multiple of 32

// The blocks an SM that __launch_bounds__ asks registers for: 12 (40
// registers) for the uint8 instance, which keeps them without a spill; 8
// (64) for the int32 one, whose loads spill at 48.
template <typename Pix>
constexpr int min_blocks() {
  return sizeof(Pix) == 1 ? 12 : 8;
}

template <typename Pix>
__global__ void __launch_bounds__(kThreads, min_blocks<Pix>())
    pframe_core_kernel(Args<Pix> a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Smem s(smem, a.rs);
  mb_pframe(a, blockIdx.x, s, threadIdx.x, blockDim.x);
}

size_t smem_bytes(int rs) { return sizeof(uint32_t) * (size_t)Smem::words(rs); }

template <typename Pix>
int launch(const Args<Pix>& a, void* stream) {
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (a.sad_total) {
    const cudaError_t err = cudaMemsetAsync(a.sad_total, 0, 4, cs);
    if (err != cudaSuccess) return (int)err;
  }
  pframe_core_kernel<Pix>
      <<<(unsigned)(a.R * a.C), kThreads, smem_bytes(a.rs), cs>>>(a);
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

// What the kernel's uint8 (u8 = 1) or int32 instance holds at range rs:
// out = {registers a thread, static shared bytes, dynamic shared bytes,
// local bytes a thread (stack and spills), threads a block, resident blocks
// an SM}. Returns a cudaError_t.
extern "C" int pframe_core_occupancy(int rs, int u8, int* out) {
  if (rs < 0 || rs > kMaxRange) return (int)cudaErrorInvalidValue;
  const void* fn = u8 ? (const void*)pframe_core_kernel<uint8_t>
                      : (const void*)pframe_core_kernel<int32_t>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                      smem_bytes(rs));
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = (int)smem_bytes(rs);
  out[3] = (int)attr.localSizeBytes;
  out[4] = kThreads;
  out[5] = blocks;
  return 0;
}
