// The arithmetic of the deblocking meta kernel (csrc/deblock_meta.cu), as
// functions of one macroblock (MB) that compile for the card (nvcc,
// __host__ __device__) and for the host (any C++17 compiler), so that the
// CPU tests run the kernel's own arithmetic through
// csrc/deblock_meta_emu.cpp. The plain PyTorch version it must equal, column
// for column, is media_tpu_torch/pipeline/deblock_apply.py:build_meta applied
// to pframe_bs_grids (a P picture) or to ops/deblock.py:intra_bs_grids (an I
// picture), with the slice-start rows zeroed.
//
// mb_meta runs one MB on a block of `nt` threads, thread `tid` taking the
// items tid, tid + nt, ... of each stage, with a barrier between the two
// stages; the host build runs it with nt = 1, where the barrier is empty.
//   1. items 0-15: whether each 4x4 luma block of the MB holds a nonzero
//      level; 16-19: the same for the left MB's blocks of column 3 (rows
//      0-3); 20-23: the top MB's blocks of row 3 (columns 0-3); 24-29: the
//      MVs of the MB, its left and its top neighbour (the MB's own where the
//      neighbour is outside the picture).
//   2. items 0-119: the meta columns in build_meta's order (ops/deblock.py
//      META_COLS):
//        0:16 bS of the vertical luma edges [edge e, block row b], 16:32 of
//        the horizontal ones [e, block column b], 32:48 and 48:64 their tc0,
//        64:72 and 72:80 the chroma edges' bS (luma edges 0 and 2), 80:88
//        and 88:96 their tc0, 96:112 luma (alpha, beta) of the edges v0-v3,
//        h0-h3, 112:120 chroma (alpha, beta) of v0, v1, h0, h1.
//
// Strengths (ops/deblock.py inter_bs_grids, intra_bs_grids): a P picture has
// bS 2 where either 4x4 block has a nonzero luma level, else 1 on an MB edge
// whose two MVs differ by 4 quarter-pels or more in a component, else 0; an I
// picture 4 on MB edges and 3 inside. The picture's left column and top row,
// and the top edges of the slice-start rows, have bS 0. tc0 is the table's
// for bS 1, 2, 3 and 0 otherwise. QPs index the tables clipped to 0..51; with
// a per-MB QP map an MB edge takes qPav = (QPp + QPq + 1) >> 1 of the two MBs
// (chroma averages the two MBs' QPc, each the table's QPc of the MB's QP
// clipped to 0..51), the MB being its own neighbour at the picture's left
// column and top row; internal edges take the MB's own QP.

#pragma once

#include <stdint.h>

#ifndef MTPU_HD
#ifdef __CUDACC__
#define MTPU_HD __host__ __device__ __forceinline__
#else
#define MTPU_HD inline
#endif
#endif

#ifndef MTPU_SYNC
#ifdef __CUDA_ARCH__
#define MTPU_SYNC() __syncthreads()
#else
#define MTPU_SYNC() ((void)0)
#endif
#endif

namespace media_dmeta {

constexpr int kMetaCols = 120;      // ops/deblock.py META_COLS
constexpr int kSymbolsPerMb = 386;  // pipeline/pframe_core.py SYMBOLS_PER_MB
constexpr int kOffLuma = 2;
constexpr int kTabCols = 6;  // alpha, beta, tc0 for bS 1, 2, 3, chroma QP
constexpr int kStage1Items = 30;

// One call. QP: qp[0] where qp is not null (a 0-d tensor on the device),
// else the value; qp_map (R, C) replaces both where it is not null.
struct Args {
  const int16_t* symbols;  // (R, C, 386), or null for an I picture
  const int32_t *qp, *qp_c;
  int qp_value, qp_c_value;
  const int32_t* qp_map;       // (R, C) luma QP per MB, or null
  const uint8_t* slice_start;  // (R) 1 at a slice's first MB row, or null
  const int32_t* tab;          // (52, kTabCols)
  int32_t* meta;               // (R C, kMetaCols)
  int R, C, intra;
};

// What stage 1 leaves for stage 2.
struct Smem {
  int nz[24];  // own blocks 0-15, left column 16-19, top row 20-23
  int mv[6];   // own x, y, left x, y, top x, y
};

MTPU_HD int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
MTPU_HD int iabs(int x) { return x < 0 ? -x : x; }

// Whether raster 4x4 block `blk` of the MB at `sym` has a nonzero level.
MTPU_HD int block_nz(const int16_t* sym, int blk) {
  const int16_t* lv = sym + kOffLuma + 16 * blk;
  int any = 0;
  for (int k = 0; k < 16; ++k) any |= lv[k];
  return any != 0;
}

MTPU_HD void stage1_item(const Args& a, int r, int c, Smem& s, int t) {
  const int16_t* own = a.symbols + ((int64_t)r * a.C + c) * kSymbolsPerMb;
  const int16_t* left = c ? own - kSymbolsPerMb : own;
  const int16_t* top = r ? own - (int64_t)a.C * kSymbolsPerMb : own;
  if (t < 16) {
    s.nz[t] = block_nz(own, t);
  } else if (t < 20) {
    s.nz[t] = c ? block_nz(left, 4 * (t - 16) + 3) : 0;
  } else if (t < 24) {
    s.nz[t] = r ? block_nz(top, 12 + (t - 20)) : 0;
  } else {
    const int k = t - 24;
    s.mv[k] = (k < 2 ? own : k < 4 ? left : top)[k & 1];
  }
}

MTPU_HD int qp_at(const int32_t* p, int value) { return p ? p[0] : value; }

// bS of vertical edge e (0-3), block row b, of MB (r, c).
MTPU_HD int bs_vertical(const Args& a, const Smem& s, int r, int c, int e,
                        int b) {
  (void)r;
  if (e == 0 && c == 0) return 0;
  if (a.intra) return e == 0 ? 4 : 3;
  const int q = s.nz[4 * b + e], p = e ? s.nz[4 * b + e - 1] : s.nz[16 + b];
  if (p | q) return 2;
  return e == 0 && (iabs(s.mv[0] - s.mv[2]) >= 4 ||
                    iabs(s.mv[1] - s.mv[3]) >= 4);
}

// bS of horizontal edge e (0-3), block column b, of MB (r, c).
MTPU_HD int bs_horizontal(const Args& a, const Smem& s, int r, int c, int e,
                          int b) {
  (void)c;
  if (e == 0 && (r == 0 || (a.slice_start && a.slice_start[r]))) return 0;
  if (a.intra) return e == 0 ? 4 : 3;
  const int q = s.nz[4 * e + b], p = e ? s.nz[4 * (e - 1) + b] : s.nz[20 + b];
  if (p | q) return 2;
  return e == 0 && (iabs(s.mv[0] - s.mv[4]) >= 4 ||
                    iabs(s.mv[1] - s.mv[5]) >= 4);
}

// The table row (QP clipped to 0..51) of luma edge i (v0-v3, h0-h3), or of
// chroma edge i (v0, v1, h0, h1) where `chroma`.
MTPU_HD int edge_row(const Args& a, int r, int c, int i, bool chroma) {
  if (!a.qp_map) {
    return clampi(chroma ? qp_at(a.qp_c, a.qp_c_value)
                         : qp_at(a.qp, a.qp_value), 0, 51);
  }
  const int32_t* m = a.qp_map + (int64_t)r * a.C + c;
  // The MB edges: chroma v0 and h0 (items 0 and 2), luma v0 and h0 (0, 4).
  const bool vertical = i == 0, horizontal = chroma ? i == 2 : i == 4;
  const int own = m[0];
  const int other = vertical ? (c ? m[-1] : own)
                             : horizontal ? (r ? m[-a.C] : own) : own;
  if (!chroma) {
    return clampi(vertical || horizontal ? (other + own + 1) >> 1 : own, 0,
                  51);
  }
  const int qc_own = a.tab[clampi(own, 0, 51) * kTabCols + 5];
  const int qc_other = a.tab[clampi(other, 0, 51) * kTabCols + 5];
  return clampi(vertical || horizontal ? (qc_other + qc_own + 1) >> 1 : qc_own,
                0, 51);
}

MTPU_HD int tc0_of(const Args& a, int bs, int row) {
  return bs >= 1 && bs <= 3 ? a.tab[row * kTabCols + 1 + bs] : 0;
}

// Meta column k (0-119) of MB (r, c).
MTPU_HD int meta_col(const Args& a, const Smem& s, int r, int c, int k) {
  if (k < 32) {
    const int e = (k & 15) >> 2, b = k & 3;
    return k < 16 ? bs_vertical(a, s, r, c, e, b)
                  : bs_horizontal(a, s, r, c, e, b);
  }
  if (k < 64) {
    const int e = (k & 15) >> 2, b = k & 3;
    return k < 48
               ? tc0_of(a, bs_vertical(a, s, r, c, e, b),
                        edge_row(a, r, c, e, false))
               : tc0_of(a, bs_horizontal(a, s, r, c, e, b),
                        edge_row(a, r, c, 4 + e, false));
  }
  if (k < 96) {
    // Chroma edge ce (0, 1) sits on luma edge 2 ce.
    const int ce = (k & 7) >> 2, b = k & 3, group = (k - 64) >> 3;
    const bool vertical = (group & 1) == 0;
    const int bs = vertical ? bs_vertical(a, s, r, c, 2 * ce, b)
                            : bs_horizontal(a, s, r, c, 2 * ce, b);
    if (group < 2) return bs;
    return tc0_of(a, bs, edge_row(a, r, c, vertical ? ce : 2 + ce, true));
  }
  const bool chroma = k >= 112;
  const int i = (k - (chroma ? 112 : 96)) >> 1;
  return a.tab[edge_row(a, r, c, i, chroma) * kTabCols + (k & 1)];
}

MTPU_HD void mb_meta(const Args& a, int mb, Smem& s, int tid, int nt) {
  const int r = mb / a.C, c = mb % a.C;
  if (!a.intra)
    for (int t = tid; t < kStage1Items; t += nt) stage1_item(a, r, c, s, t);
  MTPU_SYNC();
  int32_t* out = a.meta + (int64_t)mb * kMetaCols;
  for (int k = tid; k < kMetaCols; k += nt) out[k] = meta_col(a, s, r, c, k);
}

}  // namespace media_dmeta
