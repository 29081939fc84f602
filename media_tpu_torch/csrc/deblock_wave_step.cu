// One wave step of H.264 in-loop deblocking (spec 8.7) on the independent
// macroblocks of one wave, for sm_90a.
//
// Replaces media_tpu/ops/deblock_pallas.py:deblock_wave_pallas (body
// _wave_kernel). For each MB of the wave, a 20x20 luma patch and two 12x12
// chroma patches (own MB at [4:, 4:], 4 samples of the left and top
// neighbours around it) are filtered across the 4 vertical then 4 horizontal
// luma edges and the 2 + 2 edges of each chroma plane, in the normative
// order, with the per-edge bS, tc0, alpha and beta of the MB's meta row
// (120 int32, layout in ops/deblock.py:META_COLS). Two entries share one
// device body:
//   - patches in, filtered patches out, on N gathered patches: the form of
//     the TPU kernel and of the plain PyTorch twin,
//     media_tpu_torch/ops/deblock_pallas.py:deblock_wave_step_plain;
//   - in place on the raster planes: the MBs (r, c) of wave k = 2r + c are
//     read from and written back to the planes by the kernel itself.
//
// Bound: nothing on the card. A wave is at most 60 MBs at 1080p, 688 bytes
// of samples in and out and 480 of meta per MB: about 110 KB, some 0.03 us of
// memory time. What costs is the launch, 254 times per 1080p picture, and
// whatever the host does around each launch. So the in-place entry leaves
// the host nothing to do: no gather, no scatter, no padding (row 0 and
// column 0 are guarded: their missing neighbours are neither read nor
// written, and their edges are skipped) and no allocation, only a launch
// that a CUDA graph can replay. The MBs of one wave touch disjoint samples
// (the patch of (r, c) ends 28 columns before that of (r-1, c+2) begins), so
// filtering in place is safe within a launch; launches on one stream order
// the waves.
//
// Design: one thread block of one warp per MB, so nothing is shared between
// blocks. The patches and the meta row are staged in shared memory (samples
// as 4-byte words: patch rows start at sample columns 16c-4 and 8c-4),
// thread t < 16 filters luma line t, threads 16-23 / 24-31 the 8 lines of
// U / V. Vertical edges of its row, barrier, horizontal edges of its column,
// barrier, write back (all but the corner above and left of the MB, which
// no edge of this MB touches).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "deblock_filters.cuh"

namespace {

using media_deblock::chroma_horizontal;
using media_deblock::chroma_vertical;
using media_deblock::kChroma;
using media_deblock::kLuma;
using media_deblock::kMetaCols;
using media_deblock::luma_horizontal;
using media_deblock::luma_vertical;

constexpr int kThreads = 32;
constexpr int kLumaBytes = kLuma * kLuma, kChromaBytes = kChroma * kChroma;
constexpr int kLumaWords = kLuma / 4, kChromaWords = kChroma / 4;

struct alignas(16) Patches {
  uint8_t y[kLumaBytes];
  uint8_t c[2][kChromaBytes];  // U, V
  int meta[kMetaCols];
};

// Both passes of one MB on its staged patches; every thread of the block
// calls it, after a barrier behind the staging.
__device__ __forceinline__ void filter_mb(Patches& s, int t, bool has_left,
                                          bool has_top) {
  const int cl = (t - 16) & 7;              // chroma line of threads 16-31
  uint8_t* plane = s.c[t < 24 ? 0 : 1];     // U for 16-23, V for 24-31
  if (t < 16)
    luma_vertical(s.y, s.meta, t, has_left);
  else
    chroma_vertical(plane, s.meta, cl, has_left);
  __syncthreads();
  if (t < 16)
    luma_horizontal(s.y, s.meta, t, has_top);
  else
    chroma_horizontal(plane, s.meta, cl, has_top);
  __syncthreads();
}

__device__ __forceinline__ void stage_meta(Patches& s, const int* meta, int mb,
                                           int t) {
  const int4* src = reinterpret_cast<const int4*>(meta + mb * kMetaCols);
  if (t < kMetaCols / 4) reinterpret_cast<int4*>(s.meta)[t] = src[t];
}

__global__ void __launch_bounds__(kThreads)
deblock_wave_step_kernel(const uint8_t* __restrict__ yp,
                         const uint8_t* __restrict__ up,
                         const uint8_t* __restrict__ vp,
                         const int* __restrict__ meta,
                         uint8_t* __restrict__ yo, uint8_t* __restrict__ uo,
                         uint8_t* __restrict__ vo) {
  __shared__ Patches s;
  const int mb = blockIdx.x, t = threadIdx.x;

  for (int i = t; i < kLumaBytes; i += kThreads) s.y[i] = yp[mb * kLumaBytes + i];
  for (int i = t; i < kChromaBytes; i += kThreads) {
    s.c[0][i] = up[mb * kChromaBytes + i];
    s.c[1][i] = vp[mb * kChromaBytes + i];
  }
  stage_meta(s, meta, mb, t);
  __syncthreads();

  filter_mb(s, t, true, true);

  for (int i = t; i < kLumaBytes; i += kThreads) yo[mb * kLumaBytes + i] = s.y[i];
  for (int i = t; i < kChromaBytes; i += kThreads) {
    uo[mb * kChromaBytes + i] = s.c[0][i];
    vo[mb * kChromaBytes + i] = s.c[1][i];
  }
}

// One patch of `words` words a row between shared memory and its place in a
// plane of `pitch` bytes, whose word (row 0, word 0) is at `at`. Rows above
// the picture, words left of it and the corner are left alone.
template <bool kStore>
__device__ __forceinline__ void move_patch(uint8_t* smem, uint8_t* at,
                                           int pitch, int words, int t,
                                           bool has_left, bool has_top) {
  uint32_t* s = reinterpret_cast<uint32_t*>(smem);
  for (int i = t; i < 4 * words * words; i += kThreads) {
    const int row = i / words, w = i % words;
    if ((row < 4 && (!has_top || w == 0)) || (w == 0 && !has_left)) continue;
    uint32_t* g = reinterpret_cast<uint32_t*>(at + row * pitch + 4 * w);
    if (kStore)
      *g = s[i];
    else
      s[i] = *g;
  }
}

__global__ void __launch_bounds__(kThreads)
deblock_wave_step_inplace_kernel(uint8_t* y, uint8_t* u, uint8_t* v,
                                 const int* __restrict__ meta, int C, int k,
                                 int lo) {
  __shared__ Patches s;
  const int t = threadIdx.x;
  const int r = lo + blockIdx.x, c = k - 2 * r;
  const bool has_left = c > 0, has_top = r > 0;
  const int wy = 16 * C, wc = 8 * C;
  // The patches' first words; never dereferenced where they lie outside.
  uint8_t* ay = y + (16 * r - 4) * wy + 16 * c - 4;
  uint8_t* au = u + (8 * r - 4) * wc + 8 * c - 4;
  uint8_t* av = v + (8 * r - 4) * wc + 8 * c - 4;

  move_patch<false>(s.y, ay, wy, kLumaWords, t, has_left, has_top);
  move_patch<false>(s.c[0], au, wc, kChromaWords, t, has_left, has_top);
  move_patch<false>(s.c[1], av, wc, kChromaWords, t, has_left, has_top);
  stage_meta(s, meta, r * C + c, t);
  __syncthreads();

  filter_mb(s, t, has_left, has_top);

  move_patch<true>(s.y, ay, wy, kLumaWords, t, has_left, has_top);
  move_patch<true>(s.c[0], au, wc, kChromaWords, t, has_left, has_top);
  move_patch<true>(s.c[1], av, wc, kChromaWords, t, has_left, has_top);
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

// Wave k = 2r + c of the (R, C) macroblock grid, in place on the planes.
extern "C" int deblock_wave_step_inplace_launch(uint8_t* y, uint8_t* u,
                                                uint8_t* v,
                                                const int32_t* meta, int R,
                                                int C, int k, void* stream) {
  const int lo = std::max(0, (k - C + 2) / 2);  // ceil((k - C + 1) / 2), >= 0
  const int hi = std::min(R - 1, k / 2);
  if (k >= 0 && hi >= lo) {
    deblock_wave_step_inplace_kernel<<<hi - lo + 1, kThreads, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
        y, u, v, meta, C, k, lo);
  }
  return static_cast<int>(cudaGetLastError());
}
