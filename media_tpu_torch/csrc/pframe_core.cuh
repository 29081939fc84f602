// The arithmetic of the P-frame core kernel (csrc/pframe_core.cu), as
// functions of one macroblock (MB) that compile for the card (nvcc,
// __host__ __device__) and for the host (any C++17 compiler), so that the
// CPU tests run the kernel's own arithmetic through csrc/pframe_core_emu.cpp.
// The plain PyTorch versions it must equal, value for value, are
// media_tpu_torch/pipeline/pframe_core.py:search_refine_luma_plain and
// local_pframe_core_plain.
//
// The planes are uint8 (the encoder's and the tiles' P frames) or int32 (the
// B core's search, and callers that hand int32 planes): Args and mb_pframe
// are templates on the sample type, and only the loads differ.
//
// mb_pframe runs one MB on a block of `nt` threads, thread `tid` taking the
// items tid, tid + nt, ... of every loop, with a barrier between the
// stages; the host build runs it with nt = 1, where the barriers are empty
// and the shared-memory minimum is a plain one. Stages:
//   1. the current MB, its chroma, and the reference window of every sample
//      the search and the 6-tap filters read, into shared memory (columns
//      clamped to the plane; rows as given in an extended reference, clamped
//      to the picture in a whole-picture one);
//   2. the full-pel search: (2rs+1)^2 candidates, cost SAD + 4 (|dx|+|dy|),
//      the first minimum in (dy, dx) raster order;
//   3. the 18x18 windows around (mv - 1) of the full-pel samples g and the
//      half-pel samples b, h, j (spec 8.4.2.2.1);
//   4. the 49 quarter-pel candidates in pframe_core.py's _DELTAS order, cost
//      SAD + |qmv|_1 of the absolute quarter-pel MV, the first minimum; each
//      candidate's SAD summed over four items of four rows; the winner's
//      prediction;
// and, for the P core (not for the search alone):
//   5. chroma MC of U and V at 1/8 pel (spec 8.4.2.2.2);
//   6. the 16 luma and 8 chroma 4x4 blocks: forward transform, quant,
//      dequant, inverse, reconstruction; the chroma DC through the 2x2
//      Hadamard; the symbols in pframe_core.py's layout.
// A first minimum survives a parallel min because the key compared is
// cost << shift | candidate index: of two equal costs the smaller index has
// the smaller key.
//
// Right shifts of negative ints are arithmetic (floor) on nvcc and g++, as
// C++20 defines them and as torch's >> is; left shifts of a negative value
// are written as products.

#pragma once

#include <stdint.h>

#ifndef MTPU_HD
#ifdef __CUDACC__
#define MTPU_HD __host__ __device__ __forceinline__
#else
#define MTPU_HD inline
#endif
#endif

namespace media_pcore {

constexpr int kSymbolsPerMb = 2 + 256 + 8 + 120;  // pframe_core.SYMBOLS_PER_MB
constexpr int kOffLuma = 2;
constexpr int kOffCdc = 2 + 256;
constexpr int kOffCac = 2 + 256 + 8;
constexpr int kInterpHalo = 4;  // pframe_core.INTERP_HALO
constexpr int kMaxLevel = 2063;  // transform.MAX_LEVEL
constexpr int kMaxRange = 32;    // search ranges the shared layout allows
constexpr int kHp = 18;          // half-pel windows are 18 x 18
constexpr int kB1Rows = kHp + 5;  // b1 rows j reads: -2 .. 20
constexpr int kFullShift = 14;   // full-pel key: cost << 14 | index
constexpr int kQuarterShift = 6;  // quarter-pel key: cost << 6 | index

// The planes of one call. Current luma sample (i, j) of MB (r, c) is at
// cur_y[r * cy_mb_row + c * cy_mb_col + i * cy_row + j]: a plane or an
// (N, 16, 16) stack of MBs. Every other plane is (rows, width) with the
// given row stride and unit column stride.
template <typename Pix>
struct Args {
  const Pix *cur_y, *cur_u, *cur_v;
  int64_t cy_mb_row, cy_mb_col, cy_row, cu_row, cv_row;
  // The reference: extended by rs + 4 (luma) and rs / 2 + 2 (chroma) rows
  // above and below, read as given (a row tile's halo is its neighbours'
  // rows); or, where `whole`, the picture alone (16 R and 8 R rows), its
  // rows clamped to the picture, which is what the edge padding of the
  // extended form holds.
  const Pix *ref_y, *ref_u, *ref_v;
  int64_t ry_row, ru_row, rv_row;
  int whole;
  // QP: qp[mb * stride] where qp is not null, else the value.
  const int32_t *qp, *qp_c;
  int qp_stride, qp_c_stride, qp_value, qp_c_value;
  const int32_t *mf, *v;  // (6, 16) transform._tables "mf", "v"
  const int64_t* zz;      // (16) "zz": zig-zag -> raster position
  // The P core's outputs, or null for the search alone.
  int16_t* symbols;  // (R, C, 386)
  uint8_t *recon_y, *recon_u, *recon_v;  // (16R, 16C), (8R, 8C), (8R, 8C)
  int32_t* sad_total;                    // zeroed before the call
  // The search's outputs, or null for the P core.
  int32_t *qmv, *pred, *cost;  // (N, 2), (N, 16, 16), (N)
  int R, C, rs;
};

// The Args of the P core: the six planes' row strides in `strides` (cur_y,
// cur_u, cur_v, ref_y, ref_u, ref_v).
template <typename Pix>
inline Args<Pix> core_args(const Pix* cur_y, const Pix* cur_u,
                           const Pix* cur_v, const Pix* ref_y,
                           const Pix* ref_u, const Pix* ref_v,
                           const int64_t* strides, const int32_t* qp,
                           int qp_stride, int qp_value, const int32_t* qp_c,
                           int qp_c_stride, int qp_c_value, const int32_t* mf,
                           const int32_t* v, const int64_t* zz,
                           int16_t* symbols, uint8_t* recon_y,
                           uint8_t* recon_u, uint8_t* recon_v,
                           int32_t* sad_total, int R, int C, int rs,
                           int whole) {
  Args<Pix> a{};
  a.cur_y = cur_y, a.cur_u = cur_u, a.cur_v = cur_v;
  a.cy_mb_row = 16 * strides[0], a.cy_mb_col = 16, a.cy_row = strides[0];
  a.cu_row = strides[1], a.cv_row = strides[2];
  a.ref_y = ref_y, a.ref_u = ref_u, a.ref_v = ref_v;
  a.ry_row = strides[3], a.ru_row = strides[4], a.rv_row = strides[5];
  a.qp = qp, a.qp_stride = qp_stride, a.qp_value = qp_value;
  a.qp_c = qp_c, a.qp_c_stride = qp_c_stride, a.qp_c_value = qp_c_value;
  a.mf = mf, a.v = v, a.zz = zz;
  a.symbols = symbols;
  a.recon_y = recon_y, a.recon_u = recon_u, a.recon_v = recon_v;
  a.sad_total = sad_total;
  a.R = R, a.C = C, a.rs = rs, a.whole = whole;
  return a;
}

// The Args of the search alone: (N, 16, 16) contiguous current MBs.
inline Args<int32_t> search_args(const int32_t* cur, const int32_t* ref_y,
                                 int64_t ref_stride, int32_t* qmv,
                                 int32_t* pred, int32_t* cost, int R, int C,
                                 int rs) {
  Args<int32_t> a{};
  a.cur_y = cur;
  a.cy_mb_row = 256 * (int64_t)C, a.cy_mb_col = 256, a.cy_row = 16;
  a.ref_y = ref_y, a.ry_row = ref_stride;
  a.qmv = qmv, a.pred = pred, a.cost = cost;
  a.R = R, a.C = C, a.rs = rs;
  return a;
}

MTPU_HD int window_side(int rs) { return 2 * rs + 23; }  // -rs-3 .. rs+19

// Shared memory of one MB, in ints, carved from one array.
struct Smem {
  int *cur, *curc, *win, *b1, *hp, *pred, *predc, *zc, *dcd, *qsad, *keys,
      *tab;
  MTPU_HD static int ints(int rs) {
    const int w = window_side(rs);
    return 256 + 128 + w * w + kB1Rows * kHp + 4 * kHp * kHp + 256 + 128 +
           8 * 16 + 8 + 49 + 2 + 6 * 16 * 2 + 16;
  }
  MTPU_HD Smem(int* base, int rs) {
    const int w = window_side(rs);
    cur = base;
    curc = cur + 256;    // U then V, 8 x 8 each
    win = curc + 128;    // w x w
    b1 = win + w * w;    // kB1Rows x kHp, unrounded horizontal 6-tap
    hp = b1 + kB1Rows * kHp;  // g, b, h, j: kHp x kHp each
    pred = hp + 4 * kHp * kHp;  // 16 x 16
    predc = pred + 256;     // U then V
    zc = predc + 128;       // 8 chroma blocks' levels, DC 0; then transform
    dcd = zc + 8 * 16;      // 8 dequantised chroma DCs
    qsad = dcd + 8;         // the 49 quarter-pel candidates' SADs
    keys = qsad + 49;       // full-pel and quarter-pel minimum keys
    tab = keys + 2;         // mf (96), v (96), zz (16)
  }
};

#ifdef __CUDA_ARCH__
#define MTPU_SYNC() __syncthreads()
MTPU_HD void shared_min(int* slot, int key) { atomicMin(slot, key); }
MTPU_HD void shared_add(int* slot, int v) { atomicAdd(slot, v); }
MTPU_HD void global_add(int32_t* slot, int v) { atomicAdd(slot, v); }
#else
#define MTPU_SYNC() ((void)0)
MTPU_HD void shared_min(int* slot, int key) {
  if (key < *slot) *slot = key;
}
MTPU_HD void shared_add(int* slot, int v) { *slot += v; }
MTPU_HD void global_add(int32_t* slot, int v) {
  *slot = (int32_t)((uint32_t)*slot + (uint32_t)v);  // wraps as int32 sums do
}
#endif

MTPU_HD int iabs(int x) { return x < 0 ? -x : x; }
MTPU_HD int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
MTPU_HD int clip255(int x) { return clampi(x, 0, 255); }
MTPU_HD int tap6(int a, int b, int c, int d, int e, int f) {
  return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
}
MTPU_HD int sgn(int x) { return (x > 0) - (x < 0); }

// ---- the 4x4 transforms (spec 8.5.12; transform.py forward_4x4 etc.) ------

// W = Cf X Cf^T on a raster 4x4 block: rows first, then columns.
MTPU_HD void forward4x4(const int* x, int* w) {
  int t[16];
  for (int r = 0; r < 4; ++r) {
    const int* v = x + 4 * r;
    const int a = v[0] + v[3], b = v[1] + v[2];
    const int c = v[1] - v[2], d = v[0] - v[3];
    t[4 * r + 0] = a + b;
    t[4 * r + 1] = 2 * d + c;
    t[4 * r + 2] = a - b;
    t[4 * r + 3] = d - 2 * c;
  }
  for (int k = 0; k < 4; ++k) {
    const int a = t[k] + t[12 + k], b = t[4 + k] + t[8 + k];
    const int c = t[4 + k] - t[8 + k], d = t[k] - t[12 + k];
    w[k] = a + b;
    w[4 + k] = 2 * d + c;
    w[8 + k] = a - b;
    w[12 + k] = d - 2 * c;
  }
}

// The inverse core transform with the final (x + 32) >> 6: rows (the
// horizontal pass) first, then columns.
MTPU_HD void inverse4x4(const int* d, int* out) {
  int g[16];
  for (int r = 0; r < 4; ++r) {
    const int* v = d + 4 * r;
    const int e0 = v[0] + v[2], e1 = v[0] - v[2];
    const int e2 = (v[1] >> 1) - v[3], e3 = v[1] + (v[3] >> 1);
    g[4 * r + 0] = e0 + e3;
    g[4 * r + 1] = e1 + e2;
    g[4 * r + 2] = e1 - e2;
    g[4 * r + 3] = e0 - e3;
  }
  for (int k = 0; k < 4; ++k) {
    const int e0 = g[k] + g[8 + k], e1 = g[k] - g[8 + k];
    const int e2 = (g[4 + k] >> 1) - g[12 + k];
    const int e3 = g[4 + k] + (g[12 + k] >> 1);
    out[k] = (e0 + e3 + 32) >> 6;
    out[4 + k] = (e1 + e2 + 32) >> 6;
    out[8 + k] = (e1 - e2 + 32) >> 6;
    out[12 + k] = (e0 - e3 + 32) >> 6;
  }
}

// The 2x2 chroma DC transform of [[a, b], [c, d]], raster in and out.
MTPU_HD void hadamard2x2(const int* x, int* y) {
  const int a = x[0], b = x[1], c = x[2], d = x[3];
  y[0] = a + b + c + d;
  y[1] = a - b + c - d;
  y[2] = a + b - c - d;
  y[3] = a - b - c + d;
}

// Inter quantisation (JM): (|w| MF + f) >> qbits, f = 2^qbits / 6, the
// level clamped to MAX_LEVEL, sign(0) = 0.
MTPU_HD int quant_inter(int w, int mf, int per) {
  const int qbits = 15 + per;
  const int f = (1 << qbits) / 6;
  const int level = (iabs(w) * mf + f) >> qbits;
  return sgn(w) * (level < kMaxLevel ? level : kMaxLevel);
}

// Chroma DC after the 2x2 transform: (|w| MF0 + 2f) >> (qbits + 1).
MTPU_HD int quant_dc2_inter(int w, int mf0, int per) {
  const int qbits = 15 + per;
  const int f = (1 << qbits) / 6;
  const int level = (iabs(w) * mf0 + 2 * f) >> (qbits + 1);
  return sgn(w) * (level < kMaxLevel ? level : kMaxLevel);
}

MTPU_HD int dequant(int z, int v, int per) { return z * v * (1 << per); }

// Chroma DC after the decoder-side 2x2 transform: ((f 16 V0) << per) >> 5.
MTPU_HD int dequant_dc2(int f, int v0, int per) {
  return (f * 16 * v0 * (1 << per)) >> 5;
}

// ---- sub-pel prediction (pframe_core.py _TAPS, spec Table 8-12) -----------

// Per quarter-pel phase xf + 4 yf, its one or two taps, each a plane (0 g,
// 1 b, 2 h, 3 j) | px << 2 | py << 3; -1 where there is one tap.
struct TapPair {
  int first, second;
};
constexpr int kG = 0, kB = 1, kH = 2, kJ = 3, kX1 = 4, kY1 = 8;
constexpr TapPair kTapTable[16] = {
    {kG, -1},       {kG, kB},       {kB, -1},       {kB, kG | kX1},
    {kG, kH},       {kB, kH},       {kB, kJ},       {kB, kH | kX1},
    {kH, -1},       {kH, kJ},       {kJ, -1},       {kJ, kH | kX1},
    {kH, kG | kY1}, {kH, kB | kY1}, {kJ, kB | kY1}, {kH | kX1, kB | kY1}};

// Eight phases a word, a byte each: first | second << 4, the first tap again
// where there is one (the rounded mean of a sample with itself is the
// sample). Packed at compile time, so the kernel reads no table.
constexpr uint64_t pack_taps(int half) {
  uint64_t v = 0;
  for (int k = 7; k >= 0; --k) {
    const TapPair t = kTapTable[8 * half + k];
    v = v << 8 | (uint64_t)(t.first | (t.second < 0 ? t.first : t.second) << 4);
  }
  return v;
}
constexpr uint64_t kTapsLo = pack_taps(0), kTapsHi = pack_taps(1);

// The two tap windows of the quarter-pel candidate (dx, dy) around the
// full-pel MV: its prediction at pixel (i, j) is
// (p0[i kHp + j] + p1[i kHp + j] + 1) >> 1. hp holds the g, b, h, j windows
// (kHp x kHp each) whose (0, 0) is at (mv - 1).
MTPU_HD void subpel_taps(const int* hp, int dx, int dy, const int** p0,
                         const int** p1) {
  const int ox = 1 + (dx >> 2), oy = 1 + (dy >> 2);
  const int phase = (dx & 3) + 4 * (dy & 3);
  const int byte = (int)(((phase < 8 ? kTapsLo : kTapsHi) >> (8 * (phase & 7)))
                         & 0xff);
  const int a = byte & 15, b = byte >> 4;
  *p0 = hp + (a & 3) * kHp * kHp + (oy + (a >> 3)) * kHp + ox + ((a >> 2) & 1);
  *p1 = hp + (b & 3) * kHp * kHp + (oy + (b >> 3)) * kHp + ox + ((b >> 2) & 1);
}

MTPU_HD int qp_of(const int32_t* p, int stride, int value, int mb) {
  return p ? p[(int64_t)mb * stride] : value;
}

// The row of the reference plane that holds picture row `row` of a plane
// of `rows` rows: `halo` rows down in an extended reference, the row
// clamped to the picture in a whole one.
MTPU_HD int64_t ref_row(int row, int halo, int rows, int whole) {
  return whole ? clampi(row, 0, rows - 1) : row + halo;
}

// ---- one macroblock ---------------------------------------------------------

template <typename Pix>
MTPU_HD void mb_pframe(const Args<Pix>& a, int mb, const Smem& s, int tid,
                       int nt) {
  const int r = mb / a.C, c = mb % a.C, rs = a.rs;
  const int w = window_side(rs), o = rs + 3, K = 2 * rs + 1;
  const int width = 16 * a.C, width_c = 8 * a.C;
  const bool code = a.symbols != nullptr;

  // 1. Current MB, chroma, window, tables; the two minimum keys.
  const Pix* cy = a.cur_y + r * a.cy_mb_row + c * a.cy_mb_col;
  for (int p = tid; p < 256; p += nt)
    s.cur[p] = cy[(p >> 4) * a.cy_row + (p & 15)];
  // Window row k is picture row 16 r + k - o: in an extended reference
  // plane row rs + kInterpHalo + 16 r + k - o, never clamped (a tile's halo
  // rows are real rows); in a whole one clamped to the picture.
  for (int p = tid; p < w * w; p += nt) {
    const int k = p / w, x = 16 * c - o + p % w;
    s.win[p] = a.ref_y[ref_row(16 * r + k - o, rs + kInterpHalo, 16 * a.R,
                               a.whole) * a.ry_row +
                       clampi(x, 0, width - 1)];
  }
  if (code) {
    for (int p = tid; p < 128; p += nt) {
      const int comp = p >> 6, i = (p >> 3) & 7, j = p & 7;
      const int64_t at = (int64_t)(8 * r + i) * (comp ? a.cv_row : a.cu_row)
                         + 8 * c + j;
      s.curc[p] = comp ? a.cur_v[at] : a.cur_u[at];
    }
    for (int p = tid; p < 208; p += nt)
      s.tab[p] = p < 96 ? a.mf[p] : p < 192 ? a.v[p - 96] : (int)a.zz[p - 192];
  }
  for (int d = tid; d < 49; d += nt) s.qsad[d] = 0;
  if (tid == 0) s.keys[0] = s.keys[1] = 0x7fffffff;
  MTPU_SYNC();

  // 2. Full-pel search.
  for (int k = tid; k < K * K; k += nt) {
    const int dy = k / K - rs, dx = k % K - rs;
    const int* wp = s.win + (dy + o) * w + dx + o;
    int sad = 0;
    for (int i = 0; i < 16; ++i)
      for (int j = 0; j < 16; ++j)
        sad += iabs(s.cur[16 * i + j] - wp[i * w + j]);
    shared_min(&s.keys[0], (sad + 4 * (iabs(dx) + iabs(dy))) << kFullShift | k);
  }
  MTPU_SYNC();
  const int kbest = s.keys[0] & ((1 << kFullShift) - 1);
  const int mvx = kbest % K - rs, mvy = kbest / K - rs;

  // 3. Windows around (mv - 1): b1 over rows -2 .. 20, then g, b, h, j.
  const int* g = s.win + (mvy + o) * w + mvx + o;  // the full-pel MV's sample
  for (int p = tid; p < kB1Rows * kHp; p += nt) {
    const int* q = g + (p / kHp - 3) * w + (p % kHp - 1) - 2;
    s.b1[p] = tap6(q[0], q[1], q[2], q[3], q[4], q[5]);
  }
  MTPU_SYNC();
  int *hg = s.hp, *hb = hg + kHp * kHp, *hh = hb + kHp * kHp,
      *hj = hh + kHp * kHp;
  for (int p = tid; p < kHp * kHp; p += nt) {
    const int i = p / kHp, j = p % kHp;
    hg[p] = g[(i - 1) * w + (j - 1)];
    hb[p] = clip255((s.b1[(i + 2) * kHp + j] + 16) >> 5);
    const int* q = g + (i - 1 - 2) * w + (j - 1);
    hh[p] = clip255((tap6(q[0], q[w], q[2 * w], q[3 * w], q[4 * w],
                          q[5 * w]) + 16) >> 5);
    const int* t = s.b1 + i * kHp + j;
    hj[p] = clip255((tap6(t[0], t[kHp], t[2 * kHp], t[3 * kHp], t[4 * kHp],
                          t[5 * kHp]) + 512) >> 10);
  }
  MTPU_SYNC();

  // 4. Quarter-pel refinement: item (d, part) sums candidate d's SAD over
  //    rows 4 part .. 4 part + 3; then the keys; then the winner's
  //    prediction.
  for (int it = tid; it < 4 * 49; it += nt) {
    const int d = it % 49, i0 = 4 * (it / 49);
    const int *p0, *p1;
    subpel_taps(s.hp, d % 7 - 3, d / 7 - 3, &p0, &p1);
    int sad = 0;
    for (int i = i0; i < i0 + 4; ++i)
      for (int j = 0; j < 16; ++j)
        sad += iabs(s.cur[16 * i + j] -
                    ((p0[i * kHp + j] + p1[i * kHp + j] + 1) >> 1));
    shared_add(&s.qsad[d], sad);
  }
  MTPU_SYNC();
  for (int d = tid; d < 49; d += nt) {
    const int rate = iabs(4 * mvx + d % 7 - 3) + iabs(4 * mvy + d / 7 - 3);
    shared_min(&s.keys[1], (s.qsad[d] + rate) << kQuarterShift | d);
  }
  MTPU_SYNC();
  const int dbest = s.keys[1] & ((1 << kQuarterShift) - 1);
  const int cost = s.keys[1] >> kQuarterShift;
  const int qx = 4 * mvx + dbest % 7 - 3, qy = 4 * mvy + dbest / 7 - 3;
  {
    const int *p0, *p1;
    subpel_taps(s.hp, dbest % 7 - 3, dbest / 7 - 3, &p0, &p1);
    for (int p = tid; p < 256; p += nt) {
      const int at = (p >> 4) * kHp + (p & 15);
      s.pred[p] = (p0[at] + p1[at] + 1) >> 1;
    }
  }
  if (!code) {
    for (int p = tid; p < 256; p += nt) a.pred[(int64_t)mb * 256 + p] = s.pred[p];
    if (tid == 0) {
      a.qmv[2 * mb] = qx;
      a.qmv[2 * mb + 1] = qy;
      a.cost[mb] = cost;
    }
    return;  // the search alone: no barrier follows
  }

  // 5. Chroma MC at 1/8 pel: integer part by floor, fraction by & 7.
  const int halo_c = rs / 2 + 2;
  const int ix = qx >> 3, iy = qy >> 3, fx = qx & 7, fy = qy & 7;
  for (int p = tid; p < 128; p += nt) {
    const int comp = p >> 6, i = (p >> 3) & 7, j = p & 7;
    const Pix* ref = comp ? a.ref_v : a.ref_u;
    const int64_t row = comp ? a.rv_row : a.ru_row;
    const Pix* r0 =
        ref + ref_row(8 * r + iy + i, halo_c, 8 * a.R, a.whole) * row;
    const Pix* r1 =
        ref + ref_row(8 * r + iy + i + 1, halo_c, 8 * a.R, a.whole) * row;
    const int x0 = clampi(8 * c + ix + j, 0, width_c - 1);
    const int x1 = clampi(8 * c + ix + j + 1, 0, width_c - 1);
    const int A = r0[x0], B = r0[x1], Cc = r1[x0], D = r1[x1];
    s.predc[p] = ((8 - fx) * (8 - fy) * A + fx * (8 - fy) * B +
                  (8 - fx) * fy * Cc + fx * fy * D + 32) >> 6;
  }
  MTPU_SYNC();

  // 6. Residual coding. Items 0-15: the luma blocks in raster block order;
  //    16-23: the chroma blocks (U then V, raster in the 8x8).
  const int qp = qp_of(a.qp, a.qp_stride, a.qp_value, mb);
  const int qpc = qp_of(a.qp_c, a.qp_c_stride, a.qp_c_value, mb);
  const int *mf = s.tab, *vt = s.tab + 96, *zz = s.tab + 192;
  int16_t* sym = a.symbols + (int64_t)mb * kSymbolsPerMb;
  for (int t = tid; t < 24; t += nt) {
    int x[16], wc[16], z[16];
    if (t < 16) {
      const int by = t >> 2, bx = t & 3;
      for (int k = 0; k < 16; ++k) {
        const int p = (4 * by + (k >> 2)) * 16 + 4 * bx + (k & 3);
        x[k] = s.cur[p] - s.pred[p];
      }
      forward4x4(x, wc);
      const int rem = qp % 6, per = qp / 6;
      for (int k = 0; k < 16; ++k) {
        z[k] = quant_inter(wc[k], mf[16 * rem + k], per);
        x[k] = dequant(z[k], vt[16 * rem + k], per);
      }
      for (int k = 0; k < 16; ++k) sym[kOffLuma + 16 * t + k] = (int16_t)z[zz[k]];
      inverse4x4(x, wc);
      uint8_t* out = a.recon_y + (int64_t)(16 * r + 4 * by) * width + 16 * c +
                     4 * bx;
      for (int k = 0; k < 16; ++k) {
        const int p = (4 * by + (k >> 2)) * 16 + 4 * bx + (k & 3);
        out[(k >> 2) * width + (k & 3)] = (uint8_t)clip255(s.pred[p] + wc[k]);
      }
    } else {
      const int b = t - 16, comp = b >> 2, by = (b >> 1) & 1, bx = b & 1;
      for (int k = 0; k < 16; ++k) {
        const int p = 64 * comp + (4 * by + (k >> 2)) * 8 + 4 * bx + (k & 3);
        x[k] = s.curc[p] - s.predc[p];
      }
      forward4x4(x, wc);
      const int rem = qpc % 6, per = qpc / 6;
      s.zc[16 * b] = wc[0];  // the DC, for the 2x2 transform
      for (int k = 1; k < 16; ++k)
        s.zc[16 * b + k] = quant_inter(wc[k], mf[16 * rem + k], per);
      for (int k = 1; k < 16; ++k)
        sym[kOffCac + 15 * b + k - 1] = (int16_t)s.zc[16 * b + zz[k]];
    }
  }
  MTPU_SYNC();
  for (int comp = tid; comp < 2; comp += nt) {
    const int rem = qpc % 6, per = qpc / 6;
    int dc[4], f[4], z2[4];
    for (int k = 0; k < 4; ++k) dc[k] = s.zc[16 * (4 * comp + k)];
    hadamard2x2(dc, f);
    for (int k = 0; k < 4; ++k) {
      z2[k] = quant_dc2_inter(f[k], mf[16 * rem], per);
      sym[kOffCdc + 4 * comp + k] = (int16_t)z2[k];
    }
    hadamard2x2(z2, f);
    for (int k = 0; k < 4; ++k)
      s.dcd[4 * comp + k] = dequant_dc2(f[k], vt[16 * rem], per);
  }
  MTPU_SYNC();
  for (int b = tid; b < 8; b += nt) {
    const int comp = b >> 2, by = (b >> 1) & 1, bx = b & 1;
    const int rem = qpc % 6, per = qpc / 6;
    int d[16], res[16];
    d[0] = s.dcd[b];
    for (int k = 1; k < 16; ++k)
      d[k] = dequant(s.zc[16 * b + k], vt[16 * rem + k], per);
    inverse4x4(d, res);
    uint8_t* out = (comp ? a.recon_v : a.recon_u) +
                   (int64_t)(8 * r + 4 * by) * width_c + 8 * c + 4 * bx;
    for (int k = 0; k < 16; ++k) {
      const int p = 64 * comp + (4 * by + (k >> 2)) * 8 + 4 * bx + (k & 3);
      out[(k >> 2) * width_c + (k & 3)] = (uint8_t)clip255(s.predc[p] + res[k]);
    }
  }
  if (tid == 0) {
    sym[0] = (int16_t)qx;
    sym[1] = (int16_t)qy;
    global_add(a.sad_total, cost);
  }
}

}  // namespace media_pcore
