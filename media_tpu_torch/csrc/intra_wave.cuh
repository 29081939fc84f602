// The arithmetic of the intra wavefront kernels (csrc/intra_wave.cu), as
// functions of one macroblock (MB) that compile for the card (nvcc,
// __host__ __device__) and for the host (any C++17 compiler), so that the
// CPU tests run the kernels' own arithmetic through csrc/intra_wave_emu.cpp.
// The plain PyTorch versions they must equal, value for value, are
// media_tpu_torch/pipeline/encoder.py:intra_encode_plain (the IDR: the
// I_16x16 and chroma mode decisions, with `i4x4` the I_4x4 chain and the
// per-MB I_4x4 / I_16x16 decision) and
// media_tpu_torch/pipeline/decoder_tpu.py:intra_recon_plain (the I picture's
// reconstruction from given modes and levels).
//
// mb_intra_encode and mb_intra_recon run one MB on a block of `nt` threads,
// thread `tid` taking the items tid, tid + nt, ... of every loop, with a
// barrier between the stages; the host build runs them with nt = 1. Every
// argmin (4 luma modes, 4 chroma modes, 9 modes a 4x4 block) is one thread
// scanning in mode order, so the first minimum wins; a mode that may not be
// signalled costs kUnavailable. The neighbours of an MB are read from the
// recon planes, which earlier waves wrote: the row above (and, for I_4x4,
// the first four samples of the MB above and to the right), the column to
// the left and the corner, each only where it is available and 0
// elsewhere; the availability rules keep those zeros out of every output,
// as they keep the plain version's clamped reads out.
//
// Integer ranges: a residual is within +-255, so a 4x4 forward transform's
// output is within +-9180 and |w| MF within 2^27; the luma DC Hadamard's
// within +-65280, times MF0 (at most 13107) under 2^30, with 4f under 2^24:
// every product stays in int32, as in the plain version. Levels of a
// conformant stream keep the decoder's dequantisation in range too.

#pragma once

#include <stdint.h>

#include "pframe_core.cuh"

namespace media_intra {

using media_pcore::clip255;
using media_pcore::dequant;
using media_pcore::dequant_dc2;
using media_pcore::forward4x4;
using media_pcore::hadamard2x2;
using media_pcore::iabs;
using media_pcore::inverse4x4;
using media_pcore::kMaxLevel;
using media_pcore::sgn;

constexpr int kUnavailable = 1 << 30;  // encoder.py's `unavailable` cost
constexpr int kTapCols = 8;            // i4 table: 3 indices, 3 weights, rnd, sh
constexpr int kTapInts = 9 * 16 * kTapCols;
// Whether the 4x4 block above and to the right of raster block b = 4 by + bx
// (by > 0) is decoded before it: encoder.py's _TR_OK as a bit mask.
constexpr unsigned kTrOkMask = (1u << 4) | (1u << 6) | (1u << 8) | (1u << 9) |
                               (1u << 10) | (1u << 12) | (1u << 14);

// z-scan index -> raster index 4 by + bx of a 4x4 block in its MB
// (encoder.py ZSCAN_TO_RASTER).
MTPU_HD int zscan_to_raster(int z) {
  const int bx = (z & 1) | ((z >> 1) & 2);
  const int by = ((z >> 1) & 1) | ((z >> 2) & 2);
  return 4 * by + bx;
}

// The encoder's call. Planes y (16R, 16C), u, v (8R, 8C) int32 with unit
// column stride and the given row strides; has_top (R) 0/1: row r has a top
// neighbour (false at row 0 and every slice start); the tables are
// transform._tables' "mf", "v" (6, 16) and "zz" (16), and intra_wave.i4_taps
// (9, 16, 8). Outputs, every element written: mode16, chroma_mode (R, C);
// dc (R, C, 16) zig-zag; ac (R, C, 16, 15) raster blocks, zig-zag [1:];
// cdc (R, C, 2, 4); cac (R, C, 2, 4, 15); with i4x4 also is_i4 (R, C) 0/1,
// modes4 (R, C, 16) z-scan, luma4 (R, C, 16, 16) raster blocks, zig-zag;
// recon planes uint8 (16R, 16C), (8R, 8C) x 2, contiguous.
struct EncArgs {
  const int32_t *y, *u, *v;
  int64_t y_row, u_row, v_row;
  const uint8_t* has_top;
  int qp, qp_c;
  const int32_t *mf, *vt;
  const int64_t* zz;
  const int32_t* taps;
  int32_t *mode16, *chroma_mode, *dc, *ac, *cdc, *cac;
  uint8_t* is_i4;
  int32_t *modes4, *luma4;
  uint8_t *recon_y, *recon_u, *recon_v;
  int R, C;
};

// The decoder's call: the same symbol arrays as inputs (is_i4, modes4,
// luma4 null for a picture with no I_4x4 MB), has_top and the tables as
// above, the recon planes as outputs.
struct RecArgs {
  const int32_t *mode16, *chroma_mode, *dc, *ac, *cdc, *cac;
  const uint8_t* is_i4;
  const int32_t *modes4, *luma4;
  const uint8_t* has_top;
  int qp, qp_c;
  const int32_t *mf, *vt;
  const int64_t* zz;
  const int32_t* taps;
  uint8_t *recon_y, *recon_u, *recon_v;
  int R, C;
};

// The waves: MB (r, c) is in wave skew r + c; skew 1 serves the left and
// top neighbours, skew 2 also the top-right MB that I_4x4 reads.
MTPU_HD int n_waves(int R, int C, int skew) { return skew * (R - 1) + C; }
MTPU_HD int wave_first_row(int k, int C, int skew) {
  const int d = k - (C - 1);
  return d > 0 ? (d + skew - 1) / skew : 0;
}
MTPU_HD int wave_last_row(int k, int R, int skew) {
  return k / skew < R - 1 ? k / skew : R - 1;
}

// Shared memory of one MB, in ints.
struct Smem {
  // Neighbours: top[0] = left[0] the corner p[-1, -1], top[1 .. 16] the row
  // above, top[17 .. 20] the first four samples of the MB above and to the
  // right, left[1 .. 16] the column to the left; chroma likewise, 8 wide.
  int top[21], left[17], ctop[2][9], cleft[2][9];
  int orig[256], origc[2][64];  // the encoder's source MB
  int pred[4][256];             // the four 16x16 predictions (encoder)
  int predc[2][4][64];          // the four chroma predictions of U and V
  int part[64];                 // SATD sums by (luma mode, block)
  int csad[8];                  // SAD by (component, chroma mode)
  int lpar[4];                  // luma DC; plane a, b, c
  int cpar[2][7];               // chroma DC of the four quadrants; a, b, c
  int zac[16][16];              // I_16x16 levels by raster block (DC 0)
  int wdc[16], zdc[16], ddc[16];  // luma DCs: raw, levels, dequantised
  int rec[256];                 // the I_16x16 reconstruction
  int cur4[256];                // the I_4x4 canvas
  int lev4[16][16];             // I_4x4 levels by raster block
  int s13[13], ok4[9], dc4;     // a 4x4 block's neighbours, modes, DC
  int pred4[9][16], c4[9];      // its nine predictions and costs
  int modes4[16];               // the chosen 4x4 modes in z-scan order
  int zc[8][16], z2[8], dcd[8];  // chroma levels; DC levels, dequantised
  int mode, cmode, min16, cost4, sel;
  int mf[96], vt[96], zz[16], taps[kTapInts];
};

// ---- predictions (ops/intra.py) ---------------------------------------------

// _dc_select of the four DC rules.
MTPU_HD int dc_select(bool t, bool l, int both, int only_t, int only_l) {
  return t && l ? both : t ? only_t : l ? only_l : 128;
}

// The plane mode's a, b, c (ops/intra.py _plane) from the neighbour runs
// top[0 .. n], left[0 .. n] whose index 0 is the corner.
MTPU_HD void plane_params(const int* top, const int* left, int n, int bmul,
                          int bround, int bshift, int* out) {
  const int h2 = n / 2;
  int h = 0, v = 0;
  for (int i = 1; i <= h2; ++i) {
    h += i * (top[h2 + i] - top[h2 - i]);
    v += i * (left[h2 + i] - left[h2 - i]);
  }
  out[0] = 16 * (top[n] + left[n]);
  out[1] = (bmul * h + bround) >> bshift;
  out[2] = (bmul * v + bround) >> bshift;
}

MTPU_HD int plane_sample(const int* abc, int h2, int x, int y) {
  return clip255((abc[0] + abc[1] * (x - (h2 - 1)) + abc[2] * (y - (h2 - 1)) +
                  16) >> 5);
}

// Luma 16x16 mode m (0 V, 1 H, 2 DC, 3 plane) at (x, y).
MTPU_HD int pred16_sample(const Smem& s, int m, int x, int y) {
  return m == 0 ? s.top[1 + x]
         : m == 1 ? s.left[1 + y]
         : m == 2 ? s.lpar[0]
                  : plane_sample(s.lpar + 1, 8, x, y);
}

// Chroma mode m (0 DC, 1 H, 2 V, 3 plane) of component j at (x, y).
MTPU_HD int predc_sample(const Smem& s, int j, int m, int x, int y) {
  return m == 0 ? s.cpar[j][2 * (y >> 2) + (x >> 2)]
         : m == 1 ? s.cleft[j][1 + y]
         : m == 2 ? s.ctop[j][1 + x]
                  : plane_sample(s.cpar[j] + 4, 4, x, y);
}

// The luma DC and plane parameters (pred_16x16_dc, pred_16x16_plane).
MTPU_HD void luma_params(Smem& s, bool at, bool al) {
  int st = 0, sl = 0;
  for (int i = 1; i <= 16; ++i) st += s.top[i], sl += s.left[i];
  s.lpar[0] = dc_select(at, al, (st + sl + 16) >> 5, (st + 8) >> 4,
                        (sl + 8) >> 4);
  plane_params(s.top, s.left, 16, 5, 32, 6, s.lpar + 1);
}

// The chroma DC of each quadrant (pred_chroma_dc) and the plane parameters
// of component j.
MTPU_HD void chroma_params(Smem& s, int j, bool at, bool al) {
  const int* t = s.ctop[j] + 1;
  const int* l = s.cleft[j] + 1;
  const int t0 = t[0] + t[1] + t[2] + t[3], t1 = t[4] + t[5] + t[6] + t[7];
  const int l0 = l[0] + l[1] + l[2] + l[3], l1 = l[4] + l[5] + l[6] + l[7];
  int* dc = s.cpar[j];
  dc[0] = dc_select(at, al, (t0 + l0 + 4) >> 3, (t0 + 2) >> 2, (l0 + 2) >> 2);
  dc[1] = at ? (t1 + 2) >> 2 : al ? (l0 + 2) >> 2 : 128;  // x 4..7, y 0..3
  dc[2] = al ? (l1 + 2) >> 2 : at ? (t0 + 2) >> 2 : 128;  // x 0..3, y 4..7
  dc[3] = dc_select(at, al, (t1 + l1 + 4) >> 3, (t1 + 2) >> 2, (l1 + 2) >> 2);
  plane_params(s.ctop[j], s.cleft[j], 8, 17, 16, 5, dc + 4);
}

// Sample p of 4x4 mode m from the 13 neighbours [l3 l2 l1 l0 corner t0..t7]
// by the tap table (ops/intra.py _i4_table; DC from its own rule).
MTPU_HD int pred4_sample(const Smem& s, int m, int p) {
  if (m == 2) return s.dc4;
  const int* e = s.taps + (16 * m + p) * kTapCols;
  return (e[3] * s.s13[e[0]] + e[4] * s.s13[e[1]] + e[5] * s.s13[e[2]] +
          e[6]) >> e[7];
}

// The neighbours of 4x4 block z of the I_4x4 chain (encoder.py i4_chain)
// into s13, its DC prediction and its nine modes' availability; one thread.
// at, al: the MB's top and left availability; tr_mb: the top-right MB's.
MTPU_HD void i4_neighbours(Smem& s, int z, bool at, bool al, bool tr_mb) {
  const int b = zscan_to_raster(z), by = b >> 2, bx = b & 3;
  const int x0 = 4 * bx, y0 = 4 * by;
  int t[8], l[4];
  for (int i = 0; i < 4; ++i) {
    t[i] = by == 0 ? s.top[1 + x0 + i] : s.cur4[(y0 - 1) * 16 + x0 + i];
    l[i] = bx == 0 ? s.left[1 + y0 + i] : s.cur4[(y0 + i) * 16 + x0 - 1];
  }
  const int corner = by == 0 ? (bx == 0 ? s.top[0] : s.top[x0])
                     : bx == 0 ? s.left[y0]
                               : s.cur4[(y0 - 1) * 16 + x0 - 1];
  bool tr_ok;
  if (by == 0) {
    tr_ok = bx < 3 ? at : tr_mb;
    for (int i = 0; i < 4; ++i)
      t[4 + i] = bx < 3 ? s.top[1 + x0 + 4 + i] : s.top[17 + i];
  } else {
    tr_ok = (kTrOkMask >> b) & 1;
    for (int i = 0; i < 4; ++i)
      t[4 + i] = tr_ok ? s.cur4[(y0 - 1) * 16 + x0 + 4 + i] : 0;
  }
  // An unavailable top-right repeats p[3, -1] (spec 8.3.1.2).
  if (!tr_ok)
    for (int i = 4; i < 8; ++i) t[i] = t[3];
  for (int i = 0; i < 4; ++i) s.s13[i] = l[3 - i];
  s.s13[4] = corner;
  for (int i = 0; i < 8; ++i) s.s13[5 + i] = t[i];
  const bool bt = by > 0 || at, bl = bx > 0 || al, tl = bt && bl;
  const int st = t[0] + t[1] + t[2] + t[3], sl = l[0] + l[1] + l[2] + l[3];
  s.dc4 = dc_select(bt, bl, (st + sl + 4) >> 3, (st + 2) >> 2, (sl + 2) >> 2);
  const bool ok[9] = {bt, bl, true, bt, tl, tl, tl, bt, bl};
  for (int m = 0; m < 9; ++m) s.ok4[m] = ok[m];
}

// ---- transforms and quantisers (ops/transform.py) --------------------------

// H X H on a raster 4x4 block (hadamard_4x4).
MTPU_HD void hadamard4x4(const int* x, int* y) {
  int t[16];
  for (int r = 0; r < 4; ++r) {
    const int* v = x + 4 * r;
    const int a = v[0] + v[3], b = v[1] + v[2];
    const int c = v[1] - v[2], d = v[0] - v[3];
    t[4 * r + 0] = a + b;
    t[4 * r + 1] = d + c;
    t[4 * r + 2] = a - b;
    t[4 * r + 3] = d - c;
  }
  for (int k = 0; k < 4; ++k) {
    const int a = t[k] + t[12 + k], b = t[4 + k] + t[8 + k];
    const int c = t[4 + k] - t[8 + k], d = t[k] - t[12 + k];
    y[k] = a + b;
    y[4 + k] = d + c;
    y[8 + k] = a - b;
    y[12 + k] = d - c;
  }
}

// The SATD sum of one 4x4 residual, before the final >> 1 (satd_cost).
MTPU_HD int satd_sum(const int* res) {
  int h[16], sum = 0;
  hadamard4x4(res, h);
  for (int k = 0; k < 16; ++k) sum += iabs(h[k]);
  return sum;
}

// quant_4x4(intra=True): (|w| MF + 2^qbits / 3) >> qbits, clamped.
MTPU_HD int quant_intra(int w, int mf, int per) {
  const int qbits = 15 + per;
  const int level = (iabs(w) * mf + (1 << qbits) / 3) >> qbits;
  return sgn(w) * (level < kMaxLevel ? level : kMaxLevel);
}

// quant_dc_4x4: (|W| MF0 + 4f) >> (qbits + 2), unclamped.
MTPU_HD int quant_dc4_intra(int w, int mf0, int per) {
  const int qbits = 15 + per;
  return sgn(w) * ((iabs(w) * mf0 + 4 * ((1 << qbits) / 3)) >> (qbits + 2));
}

// quant_dc_2x2(intra=True): (|W| MF0 + 2f) >> (qbits + 1), clamped.
MTPU_HD int quant_dc2_intra(int w, int mf0, int per) {
  const int qbits = 15 + per;
  const int level = (iabs(w) * mf0 + 2 * ((1 << qbits) / 3)) >> (qbits + 1);
  return sgn(w) * (level < kMaxLevel ? level : kMaxLevel);
}

// dequant_dc_4x4 after the decoder-side Hadamard (spec 8.5.10).
MTPU_HD int dequant_dc4(int f, int v0, int qp) {
  const int ls = 16 * v0, per = qp / 6;
  if (qp >= 36) return f * ls * (1 << (per - 6));
  return (f * ls + (1 << (5 - per))) >> (6 - per);
}

// ---- stages shared by both directions ---------------------------------------

// Neighbours from the recon planes (0 where unavailable) and the tables.
MTPU_HD void load_common(const uint8_t* ry, const uint8_t* ru,
                         const uint8_t* rv, const int32_t* mf,
                         const int32_t* vt, const int64_t* zz,
                         const int32_t* taps, bool with_taps, int C, int r,
                         int c, bool at, bool al, bool tr_mb, Smem& s, int tid,
                         int nt) {
  const int64_t wy = 16 * (int64_t)C, wc = 8 * (int64_t)C;
  const bool tl = at && al;
  for (int p = tid; p < 21 + 17; p += nt) {
    int val = 0;
    if (p == 0 || p == 21) {
      if (tl) val = ry[(16 * r - 1) * wy + 16 * c - 1];
    } else if (p < 17) {
      if (at) val = ry[(16 * r - 1) * wy + 16 * c + p - 1];
    } else if (p < 21) {
      if (tr_mb) val = ry[(16 * r - 1) * wy + 16 * (c + 1) + p - 17];
    } else if (al) {
      val = ry[(16 * r + p - 22) * wy + 16 * c - 1];
    }
    if (p < 21)
      s.top[p] = val;
    else
      s.left[p - 21] = val;
  }
  for (int p = tid; p < 36; p += nt) {
    const int j = p / 18, q = p % 18;  // component; top 0..8, left 9..17
    const uint8_t* plane = j ? rv : ru;
    int val = 0;
    if (q == 0 || q == 9) {
      if (tl) val = plane[(8 * r - 1) * wc + 8 * c - 1];
    } else if (q < 9) {
      if (at) val = plane[(8 * r - 1) * wc + 8 * c + q - 1];
    } else if (al) {
      val = plane[(8 * r + q - 10) * wc + 8 * c - 1];
    }
    if (q < 9)
      s.ctop[j][q] = val;
    else
      s.cleft[j][q - 9] = val;
  }
  const int n_tab = 208 + (with_taps ? kTapInts : 0);
  for (int p = tid; p < n_tab; p += nt)
    if (p < 96)
      s.mf[p] = mf[p];
    else if (p < 192)
      s.vt[p - 96] = vt[p - 96];
    else if (p < 208)
      s.zz[p - 192] = (int)zz[p - 192];
    else
      s.taps[p - 208] = taps[p - 208];
}

// The inverse transform of dequantised coefficients d of raster block
// (by, bx) of an n x n area, added to `pred` and clipped into `out`
// (row stride `out_row`).
template <typename T>
MTPU_HD void add_residual(const int* d, const int* pred, int pred_row,
                          T* out, int64_t out_row) {
  int res[16];
  inverse4x4(d, res);
  for (int k = 0; k < 16; ++k)
    out[(k >> 2) * out_row + (k & 3)] =
        (T)clip255(pred[(k >> 2) * pred_row + (k & 3)] + res[k]);
}

// ---- the encoder -----------------------------------------------------------

template <bool kI4>
MTPU_HD void mb_intra_encode(const EncArgs& a, int r, int c, Smem& s, int tid,
                             int nt) {
  const int C = a.C, mb = r * C + c;
  const bool at = a.has_top[r] != 0, al = c > 0;
  const bool tr_mb = kI4 && at && c < C - 1;
  const int64_t wy = 16 * (int64_t)C, wc = 8 * (int64_t)C;
  const int rem = a.qp % 6, per = a.qp / 6;
  const int rem_c = a.qp_c % 6, per_c = a.qp_c / 6;

  // 1. The source MB, the neighbours, the tables.
  load_common(a.recon_y, a.recon_u, a.recon_v, a.mf, a.vt, a.zz, a.taps, kI4,
              C, r, c, at, al, tr_mb, s, tid, nt);
  for (int p = tid; p < 384; p += nt) {
    if (p < 256) {
      s.orig[p] = a.y[(16 * r + (p >> 4)) * a.y_row + 16 * c + (p & 15)];
    } else {
      const int j = (p - 256) >> 6, q = p & 63;
      const int64_t at_c = (8 * r + (q >> 3)) * (j ? a.v_row : a.u_row) +
                           8 * c + (q & 7);
      s.origc[j][q] = j ? a.v[at_c] : a.u[at_c];
    }
  }
  MTPU_SYNC();
  // 2. DC and plane parameters.
  for (int job = tid; job < 3; job += nt) {
    if (job == 0)
      luma_params(s, at, al);
    else
      chroma_params(s, job - 1, at, al);
  }
  MTPU_SYNC();
  // 3. Every candidate prediction.
  for (int p = tid; p < 1024 + 512; p += nt) {
    if (p < 1024) {
      const int m = p >> 8, q = p & 255;
      s.pred[m][q] = pred16_sample(s, m, q & 15, q >> 4);
    } else {
      const int j = (p - 1024) >> 8, m = (p >> 6) & 3, q = p & 63;
      s.predc[j][m][q] = predc_sample(s, j, m, q & 7, q >> 3);
    }
  }
  MTPU_SYNC();
  // 4. SATD by (luma mode, block); SAD by (component, chroma mode).
  for (int it = tid; it < 64 + 8; it += nt) {
    if (it < 64) {
      const int m = it >> 4, b = it & 15, o = 64 * (b >> 2) + 4 * (b & 3);
      int res[16];
      for (int k = 0; k < 16; ++k) {
        const int q = o + 16 * (k >> 2) + (k & 3);
        res[k] = s.pred[m][q] - s.orig[q];
      }
      s.part[it] = satd_sum(res);
    } else {
      const int j = (it - 64) >> 2, m = it & 3;
      int sad = 0;
      for (int q = 0; q < 64; ++q) sad += iabs(s.predc[j][m][q] - s.origc[j][q]);
      s.csad[it - 64] = sad;
    }
  }
  MTPU_SYNC();
  // 5. The mode decisions: the first minimum among the available modes.
  if (tid == 0) {
    const bool ok16[4] = {at, al, true, at && al};
    const bool okc[4] = {true, al, at, at && al};
    int best = 0, bestc = 0, min16 = 0, minc = 0;
    for (int m = 0; m < 4; ++m) {
      int sum = 0;
      for (int b = 0; b < 16; ++b) sum += s.part[16 * m + b];
      const int cost = ok16[m] ? sum >> 1 : kUnavailable;
      if (m == 0 || cost < min16) best = m, min16 = cost;
      const int ccost = okc[m] ? s.csad[m] + s.csad[4 + m] : kUnavailable;
      if (m == 0 || ccost < minc) bestc = m, minc = ccost;
    }
    s.mode = best, s.min16 = min16, s.cmode = bestc;
    s.cost4 = 0, s.sel = 0;
  }
  MTPU_SYNC();
  const int mode = s.mode, cmode = s.cmode;
  // 6. I_16x16: forward transform and AC quantisation of the 16 blocks
  //    (raster), and the chroma blocks' (U then V, raster in the 8x8).
  for (int t = tid; t < 24; t += nt) {
    int x[16], w[16];
    if (t < 16) {
      const int o = 64 * (t >> 2) + 4 * (t & 3);
      for (int k = 0; k < 16; ++k) {
        const int q = o + 16 * (k >> 2) + (k & 3);
        x[k] = s.orig[q] - s.pred[mode][q];
      }
      forward4x4(x, w);
      s.wdc[t] = w[0];
      s.zac[t][0] = 0;
      for (int k = 1; k < 16; ++k)
        s.zac[t][k] = quant_intra(w[k], s.mf[16 * rem + k], per);
    } else {
      const int b = t - 16, j = b >> 2, o = 32 * ((b >> 1) & 1) + 4 * (b & 1);
      for (int k = 0; k < 16; ++k) {
        const int q = o + 8 * (k >> 2) + (k & 3);
        x[k] = s.origc[j][q] - s.predc[j][cmode][q];
      }
      forward4x4(x, w);
      s.zc[b][0] = w[0];  // the DC, for the 2x2 transform
      for (int k = 1; k < 16; ++k)
        s.zc[b][k] = quant_intra(w[k], s.mf[16 * rem_c + k], per_c);
    }
  }
  MTPU_SYNC();
  // 7. The luma DC chain; the chroma DC chains.
  for (int job = tid; job < 3; job += nt) {
    if (job == 0) {
      int f[16];
      hadamard4x4(s.wdc, f);
      for (int k = 0; k < 16; ++k)
        s.zdc[k] = quant_dc4_intra(f[k], s.mf[16 * rem], per);
      hadamard4x4(s.zdc, f);
      for (int k = 0; k < 16; ++k) s.ddc[k] = dequant_dc4(f[k], s.vt[16 * rem], a.qp);
    } else {
      const int j = job - 1;
      int dc[4], f[4];
      for (int k = 0; k < 4; ++k) dc[k] = s.zc[4 * j + k][0];
      hadamard2x2(dc, f);
      for (int k = 0; k < 4; ++k)
        s.z2[4 * j + k] = quant_dc2_intra(f[k], s.mf[16 * rem_c], per_c);
      hadamard2x2(s.z2 + 4 * j, f);
      for (int k = 0; k < 4; ++k)
        s.dcd[4 * j + k] = dequant_dc2(f[k], s.vt[16 * rem_c], per_c);
    }
  }
  MTPU_SYNC();
  // 8. The I_16x16 reconstruction into `rec`; the chroma's into the planes.
  for (int t = tid; t < 24; t += nt) {
    int d[16];
    if (t < 16) {
      d[0] = s.ddc[t];
      for (int k = 1; k < 16; ++k) d[k] = dequant(s.zac[t][k], s.vt[16 * rem + k], per);
      const int o = 64 * (t >> 2) + 4 * (t & 3);
      add_residual(d, s.pred[mode] + o, 16, s.rec + o, 16);
    } else {
      const int b = t - 16, j = b >> 2, by = (b >> 1) & 1, bx = b & 1;
      d[0] = s.dcd[b];
      for (int k = 1; k < 16; ++k)
        d[k] = dequant(s.zc[b][k], s.vt[16 * rem_c + k], per_c);
      uint8_t* out = (j ? a.recon_v : a.recon_u) + (8 * r + 4 * by) * wc +
                     8 * c + 4 * bx;
      add_residual(d, s.predc[j][cmode] + 32 * by + 4 * bx, 8, out, wc);
    }
  }
  MTPU_SYNC();
  // 9. The I_4x4 candidate: 16 dependent blocks in z-scan order, each the
  //    SATD-best of its nine modes, coded and reconstructed on the canvas.
  if (kI4) {
    for (int z = 0; z < 16; ++z) {
      const int b = zscan_to_raster(z), o = 64 * (b >> 2) + 4 * (b & 3);
      if (tid == 0) i4_neighbours(s, z, at, al, tr_mb);
      MTPU_SYNC();
      for (int it = tid; it < 144; it += nt)
        s.pred4[it >> 4][it & 15] = pred4_sample(s, it >> 4, it & 15);
      MTPU_SYNC();
      for (int m = tid; m < 9; m += nt) {
        int res[16];
        for (int k = 0; k < 16; ++k)
          res[k] = s.pred4[m][k] - s.orig[o + 16 * (k >> 2) + (k & 3)];
        s.c4[m] = s.ok4[m] ? satd_sum(res) >> 1 : kUnavailable;
      }
      MTPU_SYNC();
      if (tid == 0) {
        int m4 = 0;
        for (int m = 1; m < 9; ++m)
          if (s.c4[m] < s.c4[m4]) m4 = m;
        s.cost4 += s.c4[m4];
        s.modes4[z] = m4;
        int x[16], w[16], d[16];
        for (int k = 0; k < 16; ++k)
          x[k] = s.orig[o + 16 * (k >> 2) + (k & 3)] - s.pred4[m4][k];
        forward4x4(x, w);
        for (int k = 0; k < 16; ++k) {
          s.lev4[b][k] = quant_intra(w[k], s.mf[16 * rem + k], per);
          d[k] = dequant(s.lev4[b][k], s.vt[16 * rem + k], per);
        }
        add_residual(d, s.pred4[m4], 4, s.cur4 + o, 16);
        if (z == 15)  // cost4 + bias < min16, strictly
          s.sel = s.cost4 + (40 << per) < s.min16;
      }
      MTPU_SYNC();
    }
  }
  // 10. The outputs; the side that lost carries no levels, mode16 stays.
  const bool sel = kI4 && s.sel;
  for (int p = tid; p < 256 + 16 + 240 + 8 + 120; p += nt) {
    if (p < 256) {
      a.recon_y[(16 * r + (p >> 4)) * wy + 16 * c + (p & 15)] =
          (uint8_t)(sel ? s.cur4[p] : s.rec[p]);
    } else if (p < 272) {
      const int k = p - 256;
      a.dc[16 * mb + k] = sel ? 0 : s.zdc[s.zz[k]];
    } else if (p < 512) {
      const int b = (p - 272) / 15, k = 1 + (p - 272) % 15;
      a.ac[240 * mb + 15 * b + k - 1] = sel ? 0 : s.zac[b][s.zz[k]];
    } else if (p < 520) {
      a.cdc[8 * mb + p - 512] = s.z2[p - 512];
    } else {
      const int b = (p - 520) / 15, k = 1 + (p - 520) % 15;
      a.cac[120 * mb + 15 * b + k - 1] = s.zc[b][s.zz[k]];
    }
  }
  if (kI4) {
    for (int p = tid; p < 256 + 16; p += nt) {
      if (p < 256)
        a.luma4[256 * mb + p] = sel ? s.lev4[p >> 4][s.zz[p & 15]] : 0;
      else
        a.modes4[16 * mb + p - 256] = sel ? s.modes4[p - 256] : 0;
    }
  }
  if (tid == 0) {
    a.mode16[mb] = mode;
    a.chroma_mode[mb] = cmode;
    if (kI4) a.is_i4[mb] = sel;
  }
}

// ---- the decoder -----------------------------------------------------------

// kI4: the picture holds I_4x4 MBs (skew-2 waves; is_i4, modes4 and luma4
// are read).
template <bool kI4>
MTPU_HD void mb_intra_recon(const RecArgs& a, int r, int c, Smem& s, int tid,
                            int nt) {
  const int C = a.C, mb = r * C + c;
  const bool at = a.has_top[r] != 0, al = c > 0;
  const bool i4 = kI4 && a.is_i4[mb] != 0;
  const bool tr_mb = i4 && at && c < C - 1;
  const int64_t wy = 16 * (int64_t)C, wc = 8 * (int64_t)C;
  const int rem = a.qp % 6, per = a.qp / 6;
  const int rem_c = a.qp_c % 6, per_c = a.qp_c / 6;
  // Modes index the predictions: a parsed stream holds 0..3 and 0..8.
  const int mode = a.mode16[mb] & 3, cmode = a.chroma_mode[mb] & 3;

  // 1. Neighbours and tables.
  load_common(a.recon_y, a.recon_u, a.recon_v, a.mf, a.vt, a.zz, a.taps, i4,
              C, r, c, at, al, tr_mb, s, tid, nt);
  MTPU_SYNC();
  // 2. DC and plane parameters; the luma DC chain (inverse zig-zag,
  //    Hadamard, dequant_dc_4x4); the chroma DC chains.
  for (int job = tid; job < 5; job += nt) {
    if (job == 0) {
      if (!i4) luma_params(s, at, al);
    } else if (job < 3) {
      chroma_params(s, job - 1, at, al);
    } else if (job == 3) {
      if (!i4) {
        int z[16], f[16];
        for (int k = 0; k < 16; ++k) z[s.zz[k]] = a.dc[16 * mb + k];
        hadamard4x4(z, f);
        for (int k = 0; k < 16; ++k) s.ddc[k] = dequant_dc4(f[k], s.vt[16 * rem], a.qp);
      }
    } else {
      for (int j = 0; j < 2; ++j) {
        int f[4];
        hadamard2x2(a.cdc + 8 * mb + 4 * j, f);
        for (int k = 0; k < 4; ++k)
          s.dcd[4 * j + k] = dequant_dc2(f[k], s.vt[16 * rem_c], per_c);
      }
    }
  }
  MTPU_SYNC();
  // 3. Luma: the I_16x16 blocks with the DC slot set, or the I_4x4 chain
  //    with the coded modes.
  if (!i4) {
    for (int t = tid; t < 16; t += nt) {
      int d[16], pred[16];
      d[0] = s.ddc[t];
      for (int k = 1; k < 16; ++k) {
        const int q = s.zz[k];
        d[q] = dequant(a.ac[240 * mb + 15 * t + k - 1], s.vt[16 * rem + q], per);
      }
      const int y0 = 4 * (t >> 2), x0 = 4 * (t & 3);
      for (int k = 0; k < 16; ++k)
        pred[k] = pred16_sample(s, mode, x0 + (k & 3), y0 + (k >> 2));
      add_residual(d, pred, 4, a.recon_y + (16 * r + y0) * wy + 16 * c + x0, wy);
    }
  } else {
    for (int z = 0; z < 16; ++z) {
      const int b = zscan_to_raster(z), o = 64 * (b >> 2) + 4 * (b & 3);
      if (tid == 0) i4_neighbours(s, z, at, al, tr_mb);
      MTPU_SYNC();
      if (tid == 0) {
        int d[16], pred[16];
        const int m4 = a.modes4[16 * mb + z];
        for (int k = 0; k < 16; ++k) {
          const int q = s.zz[k];
          d[q] = dequant(a.luma4[256 * mb + 16 * b + k], s.vt[16 * rem + q], per);
          pred[k] = pred4_sample(s, (unsigned)m4 < 9u ? m4 : 2, k);
        }
        add_residual(d, pred, 4, s.cur4 + o, 16);
      }
      MTPU_SYNC();
    }
    for (int p = tid; p < 256; p += nt)
      a.recon_y[(16 * r + (p >> 4)) * wy + 16 * c + (p & 15)] = (uint8_t)s.cur4[p];
  }
  // 4. Chroma (decoder_tpu._chroma_recon).
  for (int b = tid; b < 8; b += nt) {
    const int j = b >> 2, by = (b >> 1) & 1, bx = b & 1;
    int d[16], pred[16];
    d[0] = s.dcd[b];
    for (int k = 1; k < 16; ++k) {
      const int q = s.zz[k];
      d[q] = dequant(a.cac[120 * mb + 15 * b + k - 1], s.vt[16 * rem_c + q], per_c);
    }
    for (int k = 0; k < 16; ++k)
      pred[k] = predc_sample(s, j, cmode, 4 * bx + (k & 3), 4 * by + (k >> 2));
    add_residual(d, pred, 4, (j ? a.recon_v : a.recon_u) +
                                 (8 * r + 4 * by) * wc + 8 * c + 4 * bx, wc);
  }
}

}  // namespace media_intra
