// Whole-frame H.264 in-loop deblocking (spec 8.7) in one launch, for sm_90a.
//
// Replaces media_tpu/ops/deblock_wave_pallas.py:deblock_wavemajor_pallas.
// It computes the same function as its plain PyTorch twin,
// media_tpu_torch/ops/deblock_wave.py:deblock_wave_plain: uint8 planes
// filtered in place, given a per-MB meta row of 120 int32 (bS, tc0 and
// alpha/beta per edge; layout in ops/deblock.py:META_COLS).
//
// Bound: the latency of the 2R+C-2 dependent waves (254 at 1080p), not
// bytes (a 1080p frame is 3 MB and stays in L2) or arithmetic. One thread
// block walks the waves in order; MB (r, c) of wave k = 2r + c is indexed
// directly in the raster planes. Thread t of a wave serves MB lane t / 32
// and line t % 32: lines 0-15 are luma rows (phase A, vertical edges) or
// luma columns (phase B, horizontal edges), lines 16-31 the 8 U then 8 V
// chroma rows / columns. A thread runs all edges of its line in order, so
// only the barrier between phase A and B, and the one after B, are needed
// per wave. Edges with bS 0 are skipped before any load, and the left edge
// of column 0 and the top edge of row 0 are never read.

#include <cuda_runtime.h>
#include <stdint.h>

#include "deblock_filters.cuh"

namespace {

using media_deblock::filter_chroma_line;
using media_deblock::filter_luma_line;
using media_deblock::kMetaCols;

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
deblock_wave_kernel(uint8_t* __restrict__ y, uint8_t* __restrict__ u,
                    uint8_t* __restrict__ v, const int* __restrict__ meta,
                    int R, int C) {
  const int wy = C * 16, wc = C * 8;
  const int n_waves = 2 * (R - 1) + C;
  for (int k = 0; k < n_waves; ++k) {
    const int lo = max(0, (k - C + 2) / 2);  // ceil((k - C + 1) / 2), >= 0
    const int hi = min(R - 1, k / 2);
    const int items = (hi - lo + 1) * 32;

    // Phase A: vertical edges, left to right.
    for (int t = threadIdx.x; t < items; t += blockDim.x) {
      const int r = lo + t / 32, c = k - 2 * r, line = t % 32;
      const int* m = meta + (r * C + c) * kMetaCols;
      if (line < 16) {
        uint8_t* row = y + (r * 16 + line) * wy + c * 16;
        for (int e = 0; e < 4; ++e) {
          const int bs = m[e * 4 + line / 4];
          if (bs == 0 || (e == 0 && c == 0)) continue;
          filter_luma_line(row + 4 * e, 1, bs, m[96 + 2 * e], m[97 + 2 * e],
                           m[32 + e * 4 + line / 4]);
        }
      } else {
        const int cl = (line - 16) % 8;
        uint8_t* row = (line < 24 ? u : v) + (r * 8 + cl) * wc + c * 8;
        for (int e = 0; e < 2; ++e) {
          const int bs = m[64 + e * 4 + cl / 2];
          if (bs == 0 || (e == 0 && c == 0)) continue;
          filter_chroma_line(row + 4 * e, 1, bs, m[112 + 2 * e],
                             m[113 + 2 * e], m[80 + e * 4 + cl / 2]);
        }
      }
    }
    __syncthreads();

    // Phase B: horizontal edges, top to bottom.
    for (int t = threadIdx.x; t < items; t += blockDim.x) {
      const int r = lo + t / 32, c = k - 2 * r, line = t % 32;
      const int* m = meta + (r * C + c) * kMetaCols;
      if (line < 16) {
        uint8_t* col = y + (r * 16) * wy + c * 16 + line;
        for (int e = 0; e < 4; ++e) {
          const int bs = m[16 + e * 4 + line / 4];
          if (bs == 0 || (e == 0 && r == 0)) continue;
          filter_luma_line(col + 4 * e * wy, wy, bs, m[104 + 2 * e],
                           m[105 + 2 * e], m[48 + e * 4 + line / 4]);
        }
      } else {
        const int cl = (line - 16) % 8;
        uint8_t* col = (line < 24 ? u : v) + (r * 8) * wc + c * 8 + cl;
        for (int e = 0; e < 2; ++e) {
          const int bs = m[72 + e * 4 + cl / 2];
          if (bs == 0 || (e == 0 && r == 0)) continue;
          filter_chroma_line(col + 4 * e * wc, wc, bs, m[116 + 2 * e],
                             m[117 + 2 * e], m[88 + e * 4 + cl / 2]);
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int deblock_wave_launch(uint8_t* y, uint8_t* u, uint8_t* v,
                                   const int32_t* meta, int R, int C,
                                   void* stream) {
  if (R > 0 && C > 0) {
    deblock_wave_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        y, u, v, meta, R, C);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* media_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
