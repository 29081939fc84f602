// H.264 deblocking filters (spec 8.7.2.3 / 8.7.2.4), shared by the
// whole-frame kernel (deblock_wave.cu) and the per-wave kernel
// (deblock_wave_step.cu) so the two cannot drift apart.
//
// The line filters each filter one line of 8-bit samples across one edge in
// place; the caller has already skipped edges with bS 0. They are the
// per-line form of media_tpu_torch/ops/deblock.py:filter_luma_taps /
// filter_chroma_taps.
//
// The macroblock passes below them run all edges of one direction of one
// sample line of a macroblock patch held in shared memory: a 20x20 luma
// patch (pitch 20) or a 12x12 chroma patch (pitch 12), the MB's own samples
// at [4:, 4:] and 4 samples of its left and top neighbours around them, with
// the MB's meta row (ops/deblock.py:META_COLS). With these pitches the 16
// (8) threads of a vertical pass hit distinct banks. The vertical pass must
// be complete for the whole patch before the horizontal pass starts.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace media_deblock {

constexpr int kMetaCols = 120;  // ops/deblock.py:META_COLS
constexpr int kLuma = 20, kChroma = 12;  // patch sizes and pitches

__device__ __forceinline__ int clip3(int lo, int hi, int x) {
  return min(max(x, lo), hi);
}

// One line across a luma edge; q points at q0, `step` crosses the edge.
__device__ __forceinline__ void filter_luma_line(uint8_t* q, int step, int bs,
                                                 int alpha, int beta,
                                                 int tc0) {
  const int p0 = q[-step], p1 = q[-2 * step], p2 = q[-3 * step];
  const int q0 = q[0], q1 = q[step], q2 = q[2 * step];
  if (!(abs(p0 - q0) < alpha && abs(p1 - p0) < beta && abs(q1 - q0) < beta))
    return;
  const int ap = abs(p2 - p0), aq = abs(q2 - q0);
  if (bs < 4) {
    const int tc = tc0 + (ap < beta) + (aq < beta);
    const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    const int avg = (p0 + q0 + 1) >> 1;
    q[-step] = clip3(0, 255, p0 + delta);
    q[0] = clip3(0, 255, q0 - delta);
    if (ap < beta) q[-2 * step] = p1 + clip3(-tc0, tc0, (p2 + avg - 2 * p1) >> 1);
    if (aq < beta) q[step] = q1 + clip3(-tc0, tc0, (q2 + avg - 2 * q1) >> 1);
    return;
  }
  const bool strong = abs(p0 - q0) < ((alpha >> 2) + 2);
  if (strong && ap < beta) {
    const int p3 = q[-4 * step];
    q[-step] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
    q[-2 * step] = (p2 + p1 + p0 + q0 + 2) >> 2;
    q[-3 * step] = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
  } else {
    q[-step] = (2 * p1 + p0 + q1 + 2) >> 2;
  }
  if (strong && aq < beta) {
    const int q3 = q[3 * step];
    q[0] = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3;
    q[step] = (q2 + q1 + q0 + p0 + 2) >> 2;
    q[2 * step] = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
  } else {
    q[0] = (2 * q1 + q0 + p1 + 2) >> 2;
  }
}

// One line across a chroma edge; q points at q0.
__device__ __forceinline__ void filter_chroma_line(uint8_t* q, int step,
                                                   int bs, int alpha, int beta,
                                                   int tc0) {
  const int p0 = q[-step], p1 = q[-2 * step];
  const int q0 = q[0], q1 = q[step];
  if (!(abs(p0 - q0) < alpha && abs(p1 - p0) < beta && abs(q1 - q0) < beta))
    return;
  if (bs < 4) {
    const int tc = tc0 + 1;
    const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    q[-step] = clip3(0, 255, p0 + delta);
    q[0] = clip3(0, 255, q0 - delta);
  } else {
    q[-step] = (2 * p1 + p0 + q1 + 2) >> 2;
    q[0] = (2 * q1 + q0 + p1 + 2) >> 2;
  }
}

// Luma row `t` (0-15) of the MB: its 4 vertical edges, left to right. The
// MB's left edge is filtered only where the MB has a left neighbour.
__device__ __forceinline__ void luma_vertical(uint8_t* sy, const int* m, int t,
                                              bool has_left) {
  uint8_t* row = sy + (4 + t) * kLuma + 4;
  for (int e = 0; e < 4; ++e) {
    const int bs = m[e * 4 + t / 4];
    if (bs == 0 || (e == 0 && !has_left)) continue;
    filter_luma_line(row + 4 * e, 1, bs, m[96 + 2 * e], m[97 + 2 * e],
                     m[32 + e * 4 + t / 4]);
  }
}

// Luma column `t` (0-15) of the MB: its 4 horizontal edges, top to bottom.
__device__ __forceinline__ void luma_horizontal(uint8_t* sy, const int* m,
                                                int t, bool has_top) {
  uint8_t* col = sy + 4 * kLuma + 4 + t;
  for (int e = 0; e < 4; ++e) {
    const int bs = m[16 + e * 4 + t / 4];
    if (bs == 0 || (e == 0 && !has_top)) continue;
    filter_luma_line(col + 4 * e * kLuma, kLuma, bs, m[104 + 2 * e],
                     m[105 + 2 * e], m[48 + e * 4 + t / 4]);
  }
}

// Chroma row `cl` (0-7) of one chroma plane of the MB: 2 vertical edges.
__device__ __forceinline__ void chroma_vertical(uint8_t* sc, const int* m,
                                                int cl, bool has_left) {
  uint8_t* row = sc + (4 + cl) * kChroma + 4;
  for (int e = 0; e < 2; ++e) {
    const int bs = m[64 + e * 4 + cl / 2];
    if (bs == 0 || (e == 0 && !has_left)) continue;
    filter_chroma_line(row + 4 * e, 1, bs, m[112 + 2 * e], m[113 + 2 * e],
                       m[80 + e * 4 + cl / 2]);
  }
}

// Chroma column `cl` (0-7) of one chroma plane: 2 horizontal edges.
__device__ __forceinline__ void chroma_horizontal(uint8_t* sc, const int* m,
                                                  int cl, bool has_top) {
  uint8_t* col = sc + 4 * kChroma + 4 + cl;
  for (int e = 0; e < 2; ++e) {
    const int bs = m[72 + e * 4 + cl / 2];
    if (bs == 0 || (e == 0 && !has_top)) continue;
    filter_chroma_line(col + 4 * e * kChroma, kChroma, bs, m[116 + 2 * e],
                       m[117 + 2 * e], m[88 + e * 4 + cl / 2]);
  }
}

}  // namespace media_deblock
