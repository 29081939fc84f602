// One wave step of H.264 in-loop deblocking (spec 8.7) on N gathered
// macroblock patches, for sm_90a.
//
// Replaces media_tpu/ops/deblock_pallas.py:deblock_wave_pallas (body
// _wave_kernel). It computes the same function as its plain PyTorch twin,
// media_tpu_torch/ops/deblock_pallas.py:deblock_wave_step_plain: for each of
// the N independent MBs of one wave, a 20x20 luma patch and two 12x12 chroma
// patches (own MB at [4:, 4:], 4 samples of the left and top neighbours
// around it) are filtered across the 4 vertical then 4 horizontal luma
// edges and the 2 + 2 edges of each chroma plane, in the normative order,
// with the per-edge bS, tc0, alpha and beta of the MB's meta row (120 int32,
// layout in ops/deblock.py:META_COLS). Patches in, filtered patches out.
//
// Bound: nothing on the card. A patch set is 688 bytes of samples plus 480
// of meta in and 688 out per MB, at most 60 MBs per 1080p wave: about
// 110 KB, some 0.03 us of memory time. The cost is the launch itself and
// the gathers and scatters around it (254 waves per 1080p picture).
//
// Design: one thread block per MB patch, so nothing is shared between
// blocks. A block is one warp of 32 threads: the patches and the meta row
// are staged in shared memory, thread t < 16 filters luma line t, threads
// 16-23 / 24-31 the 8 lines of U / V. Phase A: each thread runs the vertical
// edges of its row left to right; barrier; phase B: the horizontal edges of
// its column top to bottom; barrier; write back. Lines of one phase touch
// disjoint samples, so the only ordering needed is the barrier between the
// phases.

#include <cuda_runtime.h>
#include <stdint.h>

#include "deblock_filters.cuh"

namespace {

using media_deblock::filter_chroma_line;
using media_deblock::filter_luma_line;
using media_deblock::kMetaCols;

constexpr int kThreads = 32;
constexpr int kLuma = 20, kChroma = 12;
constexpr int kLumaBytes = kLuma * kLuma, kChromaBytes = kChroma * kChroma;

__global__ void __launch_bounds__(kThreads)
deblock_wave_step_kernel(const uint8_t* __restrict__ yp,
                         const uint8_t* __restrict__ up,
                         const uint8_t* __restrict__ vp,
                         const int* __restrict__ meta,
                         uint8_t* __restrict__ yo, uint8_t* __restrict__ uo,
                         uint8_t* __restrict__ vo) {
  __shared__ uint8_t sy[kLumaBytes];
  __shared__ uint8_t sc[2][kChromaBytes];
  __shared__ int m[kMetaCols];
  const int mb = blockIdx.x, t = threadIdx.x;

  for (int i = t; i < kLumaBytes; i += kThreads) sy[i] = yp[mb * kLumaBytes + i];
  for (int i = t; i < kChromaBytes; i += kThreads) {
    sc[0][i] = up[mb * kChromaBytes + i];
    sc[1][i] = vp[mb * kChromaBytes + i];
  }
  for (int i = t; i < kMetaCols; i += kThreads) m[i] = meta[mb * kMetaCols + i];
  __syncthreads();

  const bool luma = t < 16;
  const int cl = (t - 16) & 7;           // chroma line of threads 16-31
  uint8_t* plane = sc[t < 24 ? 0 : 1];   // U for 16-23, V for 24-31

  // Phase A: vertical edges, left to right.
  if (luma) {
    uint8_t* row = sy + (4 + t) * kLuma + 4;
    for (int e = 0; e < 4; ++e) {
      const int bs = m[e * 4 + t / 4];
      if (bs == 0) continue;
      filter_luma_line(row + 4 * e, 1, bs, m[96 + 2 * e], m[97 + 2 * e],
                       m[32 + e * 4 + t / 4]);
    }
  } else {
    uint8_t* row = plane + (4 + cl) * kChroma + 4;
    for (int e = 0; e < 2; ++e) {
      const int bs = m[64 + e * 4 + cl / 2];
      if (bs == 0) continue;
      filter_chroma_line(row + 4 * e, 1, bs, m[112 + 2 * e], m[113 + 2 * e],
                         m[80 + e * 4 + cl / 2]);
    }
  }
  __syncthreads();

  // Phase B: horizontal edges, top to bottom.
  if (luma) {
    uint8_t* col = sy + 4 * kLuma + 4 + t;
    for (int e = 0; e < 4; ++e) {
      const int bs = m[16 + e * 4 + t / 4];
      if (bs == 0) continue;
      filter_luma_line(col + 4 * e * kLuma, kLuma, bs, m[104 + 2 * e],
                       m[105 + 2 * e], m[48 + e * 4 + t / 4]);
    }
  } else {
    uint8_t* col = plane + 4 * kChroma + 4 + cl;
    for (int e = 0; e < 2; ++e) {
      const int bs = m[72 + e * 4 + cl / 2];
      if (bs == 0) continue;
      filter_chroma_line(col + 4 * e * kChroma, kChroma, bs, m[116 + 2 * e],
                         m[117 + 2 * e], m[88 + e * 4 + cl / 2]);
    }
  }
  __syncthreads();

  for (int i = t; i < kLumaBytes; i += kThreads) yo[mb * kLumaBytes + i] = sy[i];
  for (int i = t; i < kChromaBytes; i += kThreads) {
    uo[mb * kChromaBytes + i] = sc[0][i];
    vo[mb * kChromaBytes + i] = sc[1][i];
  }
}

}  // namespace

extern "C" int deblock_wave_step_launch(const uint8_t* yp, const uint8_t* up,
                                        const uint8_t* vp, const int32_t* meta,
                                        uint8_t* yo, uint8_t* uo, uint8_t* vo,
                                        int n, void* stream) {
  if (n > 0) {
    deblock_wave_step_kernel<<<n, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        yp, up, vp, meta, yo, uo, vo);
  }
  return static_cast<int>(cudaGetLastError());
}
