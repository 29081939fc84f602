// H.264 deblocking line filters (spec 8.7.2.3 / 8.7.2.4), shared by the
// whole-frame kernel (deblock_wave.cu) and the per-wave kernel
// (deblock_wave_step.cu) so the two cannot drift apart. Each filters one
// line of 8-bit samples across one edge in place; the caller has already
// skipped edges with bS 0. They are the per-line form of
// media_tpu_torch/ops/deblock.py:filter_luma_taps / filter_chroma_taps.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace media_deblock {

constexpr int kMetaCols = 120;  // ops/deblock.py:META_COLS

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

}  // namespace media_deblock
