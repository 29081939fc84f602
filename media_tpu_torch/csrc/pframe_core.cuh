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
// are templates on the sample type, and only the loads differ. Every sample
// is 0..255 in every caller (frames are uint8 and a recon is clip255'd), so
// a load narrows an int32 sample to its byte, and the searches run on
// samples packed four to a 32-bit word, the leftmost in the lowest byte.
// The packed helpers (sad4, avg4, align4) are single instructions on the
// card and byte loops on the host, with the same results, so the host build
// runs the kernel's own packed arithmetic.
//
// mb_pframe runs one MB on a block of `nt` threads (a multiple of 32 on the
// card), thread `tid` taking the items tid, tid + nt, ... of every loop, with
// a barrier between the stages; the host build runs it with nt = 1, where
// the barriers are empty and the shared-memory sums and minima plain ones.
// Stages:
//   1. the current MB (16 rows of 4 words), its chroma, and the reference
//      window of every sample the search and the 6-tap filters read (rows
//      of words; columns clamped to the plane; rows as given in an extended
//      reference, clamped to the picture in a whole-picture one), into
//      shared memory, by cp.async where a word lies in its row as it is;
//   2. the full-pel search: (2rs+1)^2 candidates, cost SAD + 4 (|dx|+|dy|),
//      the first minimum in (dy, dx) raster order. An item is a quad of four
//      neighbouring dx whose first columns share a window word, on one dy,
//      over the MB's 16 rows: each window word it loads serves its four
//      candidates (aligned by a funnel shift), one instruction takes the
//      SAD of four samples, and the item's keys stay in registers;
//   3. the 18x18 windows around (mv - 1) of the full-pel samples g and the
//      half-pel samples b, h, j (spec 8.4.2.2.1), packed;
//   4. the 49 quarter-pel candidates in pframe_core.py's _DELTAS order, cost
//      SAD + |qmv|_1 of the absolute quarter-pel MV, the first minimum; each
//      candidate's SAD summed over four items of four rows, a prediction
//      word the rounded mean of two tap words; the winner's prediction;
// and, for the P core (not for the search alone):
//   5. chroma MC of U and V at 1/8 pel (spec 8.4.2.2.2);
//   6. the 16 luma and 8 chroma 4x4 blocks in five passes of 96 items, a
//      (block, row) or (block, column) each: forward transform, quant,
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
#include <string.h>

#ifndef MTPU_HD
#ifdef __CUDACC__
#define MTPU_HD __host__ __device__ __forceinline__
#else
#define MTPU_HD inline
#endif
#endif

#ifdef __CUDACC__
#define MTPU_UNROLL _Pragma("unroll")
#define MTPU_UNROLL4 _Pragma("unroll 4")
#else
#define MTPU_UNROLL
#define MTPU_UNROLL4
#endif

#if !defined(__CUDA_ARCH__) && defined(__BYTE_ORDER__) && \
    __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
#error "packed samples are read back as bytes in the card's (little-endian) order"
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
constexpr int kHpWords = 5;       // a half-pel window row: 18 bytes, 5 words
constexpr int kHpPlane = kHp * kHpWords;
constexpr int kNoKey = 0x7fffffff;

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

// Where the reference window sits in shared memory at search range rs.
// Window row k holds picture row 16 r + k - (rs + 3), k < 2 rs + 23; its
// byte x holds picture column 16 c - margin + x, the margin being rs + 3
// rounded up to a word, so that a window word is a word of an aligned
// plane row. Full-pel candidate dx's first column is margin + dx: a row of
// candidates covers the quads q0 .. q0 + nq - 1 (four columns each). A
// window row is `pitch` words apart, at least the `words` loaded plus one
// and equal to nq modulo 32, so that the lanes of a warp, on consecutive
// (dy, quad) items, read consecutive banks.
struct Geom {
  int K, margin, q0, nq, words, pitch, rows;
  MTPU_HD explicit Geom(int rs) {
    K = 2 * rs + 1;
    margin = 4 * ((rs + 6) / 4);
    q0 = (margin - rs) >> 2;
    nq = ((margin + rs) >> 2) - q0 + 1;
    words = (margin + rs + 23) / 4;  // columns up to margin + rs + 19
    pitch = words + 1 + ((nq - words - 1) % 32 + 32) % 32;
    rows = 2 * rs + 23;
  }
};

// Shared memory of one MB, in 32-bit words carved from one array: the
// tables first (cp.async writes the int64 zig-zag 8 bytes at a time), then
// packed samples, then ints.
struct Smem {
  int* tab;  // mf (96), v (96), zz (16 int64 as 32 words)
  uint32_t *cur, *curc, *win, *hp, *pred;
  int *b1, *predc, *tr, *dq, *dcw, *izz, *qsad, *keys;
  MTPU_HD static int words(int rs) {
    const Geom gm(rs);
    return 224 + 64 + 32 + gm.rows * gm.pitch + 4 * kHpPlane + 64 +
           kB1Rows * kHp + 128 + 2 * 24 * 16 + 8 + 16 + 49 + 2;
  }
  MTPU_HD Smem(uint32_t* base, int rs) {
    const Geom gm(rs);
    tab = reinterpret_cast<int*>(base);
    cur = base + 224;               // 16 rows x 4 words
    curc = cur + 64;                // U then V: 8 rows x 2 words each
    win = curc + 32;                // gm.rows x gm.pitch words
    hp = win + gm.rows * gm.pitch;  // g, b, h, j: kHp rows x kHpWords each
    pred = hp + 4 * kHpPlane;       // 16 rows x 4 words
    b1 = reinterpret_cast<int*>(pred + 64);  // kB1Rows x kHp, unrounded
    predc = b1 + kB1Rows * kHp;  // U then V, 8 x 8 each
    tr = predc + 128;        // 24 4x4 blocks: a transform's first pass
    dq = tr + 24 * 16;       // the 24 blocks' dequantised coefficients
    dcw = dq + 24 * 16;      // the 8 chroma blocks' DCs before the 2x2
    izz = dcw + 8;           // raster position -> zig-zag index
    qsad = izz + 16;         // the 49 quarter-pel candidates' SADs
    keys = qsad + 49;        // full-pel and quarter-pel minimum keys
  }
};

#ifdef __CUDA_ARCH__
#define MTPU_SYNC() __syncthreads()
MTPU_HD void shared_min(int* slot, int key) { atomicMin(slot, key); }
MTPU_HD void shared_add(int* slot, int v) { atomicAdd(slot, v); }
MTPU_HD void global_add(int32_t* slot, int v) { atomicAdd(slot, v); }
MTPU_HD int warp_min(int v) { return __reduce_min_sync(0xffffffffu, v); }
// acc + the sum of the four bytes' |a - b|: one VABSDIFF4.U8.ACC on sm_90a.
// A SAD of four words is 4 instructions so, 6 by __vsadu4 and adds, 8 by
// __vabsdiffu4 and __dp4a (pcore_tune.py --sass).
MTPU_HD uint32_t sad4(uint32_t a, uint32_t b, uint32_t acc) {
  uint32_t r;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(r) : "r"(a), "r"(b), "r"(acc));
  return r;
}
// The bytes' rounded means, (a + b + 1) >> 1.
MTPU_HD uint32_t avg4(uint32_t a, uint32_t b) { return __vavgu4(a, b); }
// Bytes n .. n + 3 of the eight of hi:lo (n 0..3): a word at any byte.
MTPU_HD uint32_t align4(uint32_t lo, uint32_t hi, int n) {
  return __funnelshift_r(lo, hi, 8 * n);
}
// Copies of 4 or 8 aligned bytes from device to shared memory that do not
// pass through registers (cp.async): a thread issues its copies, closes them
// into a group (copy_commit), and before the barrier that publishes them
// waits for all its groups (copy_wait) or all but the last (copy_wait_prior).
MTPU_HD void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
MTPU_HD void copy8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
MTPU_HD void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
MTPU_HD void copy_wait_prior() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}
MTPU_HD void copy_wait() { asm volatile("cp.async.wait_all;" ::: "memory"); }
#else
#define MTPU_SYNC() ((void)0)
MTPU_HD void shared_min(int* slot, int key) {
  if (key < *slot) *slot = key;
}
MTPU_HD void shared_add(int* slot, int v) { *slot += v; }
MTPU_HD void global_add(int32_t* slot, int v) {
  *slot = (int32_t)((uint32_t)*slot + (uint32_t)v);  // wraps as int32 sums do
}
MTPU_HD int warp_min(int v) { return v; }  // a block of one thread
MTPU_HD uint32_t sad4(uint32_t a, uint32_t b, uint32_t acc) {
  for (int k = 0; k < 32; k += 8) {
    const int x = (a >> k) & 255, y = (b >> k) & 255;
    acc += x > y ? x - y : y - x;
  }
  return acc;
}
MTPU_HD uint32_t avg4(uint32_t a, uint32_t b) {
  uint32_t r = 0;
  for (int k = 0; k < 32; k += 8)
    r |= ((((a >> k) & 255) + ((b >> k) & 255) + 1) >> 1) << k;
  return r;
}
MTPU_HD uint32_t align4(uint32_t lo, uint32_t hi, int n) {
  return (uint32_t)(((uint64_t)hi << 32 | lo) >> (8 * n));
}
MTPU_HD void copy4(void* dst, const void* src) { memcpy(dst, src, 4); }
MTPU_HD void copy8(void* dst, const void* src) { memcpy(dst, src, 8); }
MTPU_HD void copy_commit() {}
MTPU_HD void copy_wait_prior() {}
MTPU_HD void copy_wait() {}
#endif

MTPU_HD int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Samples x0 .. x0 + 3 of a row of `width`, the columns clamped to the row,
// as a word into *dst: copied as it is where the four lie inside the row on
// a word boundary of a uint8 plane, else assembled.
MTPU_HD void row_word(uint32_t* dst, const uint8_t* row, int x0, int width) {
  if (x0 >= 0 && x0 + 4 <= width && (((uintptr_t)row + x0) & 3) == 0) {
    copy4(dst, row + x0);
    return;
  }
  uint32_t w = 0;
  for (int t = 0; t < 4; ++t)
    w |= (uint32_t)row[clampi(x0 + t, 0, width - 1)] << (8 * t);
  *dst = w;
}
MTPU_HD void row_word(uint32_t* dst, const int32_t* row, int x0, int width) {
  uint32_t w = 0;
  for (int t = 0; t < 4; ++t)
    w |= (uint32_t)(row[clampi(x0 + t, 0, width - 1)] & 255) << (8 * t);
  *dst = w;
}

MTPU_HD int iabs(int x) { return x < 0 ? -x : x; }
MTPU_HD int clip255(int x) { return clampi(x, 0, 255); }
MTPU_HD int tap6(int a, int b, int c, int d, int e, int f) {
  return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
}
MTPU_HD int sgn(int x) { return (x > 0) - (x < 0); }

// ---- the 4x4 transforms (spec 8.5.12; transform.py forward_4x4 etc.) ------

// The 1-D forward core transform of four samples: W = Cf X Cf^T is this on
// the rows of a 4x4 block, then on its columns (transform.py forward_4x4).
MTPU_HD void forward4(int x0, int x1, int x2, int x3, int* w) {
  const int a = x0 + x3, b = x1 + x2, c = x1 - x2, d = x0 - x3;
  w[0] = a + b;
  w[1] = 2 * d + c;
  w[2] = a - b;
  w[3] = d - 2 * c;
}

// The 1-D inverse core transform: on the rows of a block (the horizontal
// pass) first, then on its columns, then (x + 32) >> 6.
MTPU_HD void inverse4(int v0, int v1, int v2, int v3, int* g) {
  const int e0 = v0 + v2, e1 = v0 - v2;
  const int e2 = (v1 >> 1) - v3, e3 = v1 + (v3 >> 1);
  g[0] = e0 + e3;
  g[1] = e1 + e2;
  g[2] = e1 - e2;
  g[3] = e0 - e3;
}

// The same on a raster 4x4 block (the intra kernels' whole-block form).
MTPU_HD void forward4x4(const int* x, int* w) {
  int t[16], c[4];
  for (int r = 0; r < 4; ++r)
    forward4(x[4 * r], x[4 * r + 1], x[4 * r + 2], x[4 * r + 3], t + 4 * r);
  for (int k = 0; k < 4; ++k) {
    forward4(t[k], t[4 + k], t[8 + k], t[12 + k], c);
    for (int i = 0; i < 4; ++i) w[4 * i + k] = c[i];
  }
}
MTPU_HD void inverse4x4(const int* d, int* out) {
  int g[16], c[4];
  for (int r = 0; r < 4; ++r)
    inverse4(d[4 * r], d[4 * r + 1], d[4 * r + 2], d[4 * r + 3], g + 4 * r);
  for (int k = 0; k < 4; ++k) {
    inverse4(g[k], g[4 + k], g[8 + k], g[12 + k], c);
    for (int i = 0; i < 4; ++i) out[4 * i + k] = (c[i] + 32) >> 6;
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
// full-pel MV: its prediction at pixel (i, j) is the rounded mean of the
// bytes at (i, j + n0) of the rows from p0 and at (i, j + n1) of those from
// p1, rows kHpWords words apart. hp holds the g, b, h, j windows (kHp x kHp
// bytes each) whose (0, 0) is at (mv - 1).
MTPU_HD void subpel_taps(const uint32_t* hp, int dx, int dy,
                         const uint32_t** p0, int* n0, const uint32_t** p1,
                         int* n1) {
  const int ox = 1 + (dx >> 2), oy = 1 + (dy >> 2);
  const int phase = (dx & 3) + 4 * (dy & 3);
  const int byte = (int)(((phase < 8 ? kTapsLo : kTapsHi) >> (8 * (phase & 7)))
                         & 0xff);
  const int a = byte & 15, b = byte >> 4;
  *p0 = hp + (a & 3) * kHpPlane + (oy + (a >> 3)) * kHpWords;
  *n0 = ox + ((a >> 2) & 1);
  *p1 = hp + (b & 3) * kHpPlane + (oy + (b >> 3)) * kHpWords;
  *n1 = ox + ((b >> 2) & 1);
}

// A prediction word of a quarter-pel candidate: bytes 4 j .. 4 j + 3 of its
// rows p0 and p1 (subpel_taps), rounded means.
MTPU_HD uint32_t subpel_word(const uint32_t* p0, int n0, const uint32_t* p1,
                             int n1, int j) {
  return avg4(align4(p0[j], p0[j + 1], n0), align4(p1[j], p1[j + 1], n1));
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
  const Geom gm(rs);
  const int K = gm.K, o = rs + 3, pitch = gm.pitch;
  const int width = 16 * a.C, width_c = 8 * a.C;
  const bool code = a.symbols != nullptr;
  const bool lane0 = (tid & 31) == 0;
  const uint8_t* win8 = reinterpret_cast<const uint8_t*>(s.win);
  const uint8_t* cur8 = reinterpret_cast<const uint8_t*>(s.cur);
  const uint8_t* pred8 = reinterpret_cast<const uint8_t*>(s.pred);

  // 1. Current MB, chroma, window, tables; the SAD sums and minimum keys.
  //    Every load is issued before any is waited for.
  const Pix* cy = a.cur_y + r * a.cy_mb_row + c * a.cy_mb_col;
  for (int p = tid; p < 64; p += nt)
    row_word(s.cur + p, cy + (p >> 2) * a.cy_row, 4 * (p & 3), 16);
  // Window row k is picture row 16 r + k - o: in an extended reference
  // plane row rs + kInterpHalo + 16 r + k - o, never clamped (a tile's halo
  // rows are real rows); in a whole one clamped to the picture.
  for (int p = tid; p < gm.rows * gm.words; p += nt) {
    const int k = p / gm.words, x = p - k * gm.words;
    const Pix* row = a.ref_y + ref_row(16 * r + k - o, rs + kInterpHalo,
                                       16 * a.R, a.whole) * a.ry_row;
    row_word(s.win + k * pitch + x, row, 16 * c - gm.margin + 4 * x, width);
  }
  copy_commit();
  // The chroma and the tables wait in a group of their own until stage 5.
  if (code) {
    for (int p = tid; p < 32; p += nt) {
      const int comp = p >> 4, i = (p >> 1) & 7;
      const Pix* row = (comp ? a.cur_v : a.cur_u) +
                       (int64_t)(8 * r + i) * (comp ? a.cv_row : a.cu_row);
      row_word(s.curc + p, row, 8 * c + 4 * (p & 1), width_c);
    }
    for (int p = tid; p < 208; p += nt) {
      if (p < 96)
        copy4(s.tab + p, a.mf + p);
      else if (p < 192)
        copy4(s.tab + p, a.v + p - 96);
      else
        copy8(s.tab + 192 + 2 * (p - 192), a.zz + p - 192);
    }
  }
  copy_commit();
  for (int d = tid; d < 49; d += nt) s.qsad[d] = 0;
  if (tid == 0) s.keys[0] = s.keys[1] = kNoKey;
  copy_wait_prior();
  MTPU_SYNC();

  // 2. Full-pel search. Item (quad, dy) over the MB's 16 rows, a warp's
  //    lanes on consecutive items, so that they read one current row (a
  //    broadcast) and consecutive banks of the window: candidate t of the
  //    quad reads its 16 samples of a row as bytes t .. t + 15 of the five
  //    window words from the quad's first. Each thread keeps the least key
  //    of its candidates in range; then the warps' least.
  int best = kNoKey;
  for (int p = tid; p < K * gm.nq; p += nt) {
    const int dyi = p / gm.nq, q = gm.q0 + p - dyi * gm.nq;
    const uint32_t* w = s.win + (dyi + 3) * pitch + q;
    const uint32_t* cw = s.cur;
    uint32_t sad[4] = {0, 0, 0, 0};
    MTPU_UNROLL4
    for (int i = 0; i < 16; ++i, w += pitch, cw += 4) {
      uint32_t ref[5];
      MTPU_UNROLL
      for (int j = 0; j < 5; ++j) ref[j] = w[j];
      MTPU_UNROLL
      for (int j = 0; j < 4; ++j) {
        const uint32_t cj = cw[j];
        sad[0] = sad4(ref[j], cj, sad[0]);
        sad[1] = sad4(align4(ref[j], ref[j + 1], 1), cj, sad[1]);
        sad[2] = sad4(align4(ref[j], ref[j + 1], 2), cj, sad[2]);
        sad[3] = sad4(align4(ref[j], ref[j + 1], 3), cj, sad[3]);
      }
    }
    MTPU_UNROLL
    for (int t = 0; t < 4; ++t) {
      const int dx = 4 * q + t - gm.margin;
      const int key = ((int)sad[t] + 4 * (iabs(dx) + iabs(dyi - rs)))
                          << kFullShift | (dyi * K + dx + rs);
      if (dx >= -rs && dx <= rs && key < best) best = key;
    }
  }
  best = warp_min(best);
  if (lane0) shared_min(&s.keys[0], best);
  MTPU_SYNC();
  const int kbest = s.keys[0] & ((1 << kFullShift) - 1);
  const int mvx = kbest % K - rs, mvy = kbest / K - rs;

  // 3. Windows around (mv - 1): b1 over rows -2 .. 20, then g, b, h, j, a
  //    word (four columns; columns 18 and 19 zero) of the four an item.
  const int gr = mvy + o, gc = mvx + gm.margin;  // the full-pel MV's sample
  const int wrow = 4 * pitch;                    // bytes a window row
  for (int p = tid; p < kB1Rows * kHp; p += nt) {
    const uint8_t* q = win8 + (gr + p / kHp - 3) * wrow + gc + p % kHp - 3;
    s.b1[p] = tap6(q[0], q[1], q[2], q[3], q[4], q[5]);
  }
  MTPU_SYNC();
  for (int p = tid; p < kHpPlane; p += nt) {
    const int i = p / kHpWords, jw = p - i * kHpWords;
    const uint32_t* wr = s.win + (gr + i - 1) * pitch;
    const int x = gc - 1 + 4 * jw;
    uint32_t hg = align4(wr[x >> 2], wr[(x >> 2) + 1], x & 3);
    uint32_t hb = 0, hh = 0, hj = 0;
    for (int t = 0; t < 4 && 4 * jw + t < kHp; ++t) {
      const int j = 4 * jw + t;
      hb |= (uint32_t)clip255((s.b1[(i + 2) * kHp + j] + 16) >> 5) << (8 * t);
      const uint8_t* q = win8 + (gr + i - 3) * wrow + gc + j - 1;
      hh |= (uint32_t)clip255((tap6(q[0], q[wrow], q[2 * wrow], q[3 * wrow],
                                    q[4 * wrow], q[5 * wrow]) + 16) >> 5)
            << (8 * t);
      const int* u = s.b1 + i * kHp + j;
      hj |= (uint32_t)clip255((tap6(u[0], u[kHp], u[2 * kHp], u[3 * kHp],
                                    u[4 * kHp], u[5 * kHp]) + 512) >> 10)
            << (8 * t);
    }
    if (jw == kHpWords - 1) hg &= 0xffff;
    s.hp[p] = hg;
    s.hp[kHpPlane + p] = hb;
    s.hp[2 * kHpPlane + p] = hh;
    s.hp[3 * kHpPlane + p] = hj;
  }
  MTPU_SYNC();

  // 4. Quarter-pel refinement: item (d, g) sums candidate d's SAD over
  //    rows 4 g .. 4 g + 3; then the keys; then the winner's prediction.
  for (int it = tid; it < 4 * 49; it += nt) {
    const int d = it % 49, g = it / 49;
    const uint32_t *p0, *p1;
    int n0, n1;
    subpel_taps(s.hp, d % 7 - 3, d / 7 - 3, &p0, &n0, &p1, &n1);
    p0 += 4 * g * kHpWords;
    p1 += 4 * g * kHpWords;
    const uint32_t* cw = s.cur + 16 * g;
    uint32_t sad = 0;
    MTPU_UNROLL
    for (int i = 0; i < 4; ++i, p0 += kHpWords, p1 += kHpWords, cw += 4) {
      MTPU_UNROLL
      for (int j = 0; j < 4; ++j)
        sad = sad4(subpel_word(p0, n0, p1, n1, j), cw[j], sad);
    }
    shared_add(&s.qsad[d], (int)sad);
  }
  MTPU_SYNC();
  int qbest = kNoKey;
  for (int d = tid; d < 49; d += nt) {
    const int rate = iabs(4 * mvx + d % 7 - 3) + iabs(4 * mvy + d / 7 - 3);
    const int key = (s.qsad[d] + rate) << kQuarterShift | d;
    qbest = key < qbest ? key : qbest;
  }
  qbest = warp_min(qbest);
  if (lane0) shared_min(&s.keys[1], qbest);
  MTPU_SYNC();
  const int dbest = s.keys[1] & ((1 << kQuarterShift) - 1);
  const int cost = s.keys[1] >> kQuarterShift;
  const int qx = 4 * mvx + dbest % 7 - 3, qy = 4 * mvy + dbest / 7 - 3;
  {
    const uint32_t *p0, *p1;
    int n0, n1;
    subpel_taps(s.hp, dbest % 7 - 3, dbest / 7 - 3, &p0, &n0, &p1, &n1);
    for (int p = tid; p < 64; p += nt) {
      const int at = (p >> 2) * kHpWords;
      const uint32_t w = subpel_word(p0 + at, n0, p1 + at, n1, p & 3);
      s.pred[p] = w;
      if (!code)
        for (int t = 0; t < 4; ++t)
          a.pred[(int64_t)mb * 256 + 4 * p + t] = (w >> (8 * t)) & 255;
    }
  }
  if (!code) {
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
  copy_wait();
  MTPU_SYNC();

  // 6. Residual coding of the 16 luma blocks (raster block order) and the 8
  //    chroma blocks (U then V, raster in the 8x8), in passes of an item a
  //    (block, row) or (block, column): forward rows; forward columns,
  //    quant, dequant and the symbols; the chroma DCs through the 2x2
  //    Hadamard; inverse rows; inverse columns and reconstruction.
  const int qp = qp_of(a.qp, a.qp_stride, a.qp_value, mb);
  const int qpc = qp_of(a.qp_c, a.qp_c_stride, a.qp_c_value, mb);
  const int *mf = s.tab, *vt = s.tab + 96;
  const uint8_t* curc8 = reinterpret_cast<const uint8_t*>(s.curc);
  int16_t* sym = a.symbols + (int64_t)mb * kSymbolsPerMb;
  // Sample (i, j) of block b: its offset in the MB's luma or in U and V.
  auto at = [](int b, int i, int j) {
    return b < 16 ? (4 * (b >> 2) + i) * 16 + 4 * (b & 3) + j
                  : 64 * ((b - 16) >> 2) + (4 * (((b - 16) >> 1) & 1) + i) * 8 +
                        4 * ((b - 16) & 1) + j;
  };
  for (int k = tid; k < 16; k += nt) s.izz[s.tab[192 + 2 * k]] = k;
  for (int it = tid; it < 96; it += nt) {
    const int b = it >> 2, i = it & 3;
    int x[4];
    for (int j = 0; j < 4; ++j) {
      const int p = at(b, i, j);
      x[j] = b < 16 ? cur8[p] - pred8[p] : curc8[p] - s.predc[p];
    }
    forward4(x[0], x[1], x[2], x[3], s.tr + 16 * b + 4 * i);
  }
  MTPU_SYNC();
  for (int it = tid; it < 96; it += nt) {
    const int b = it >> 2, j = it & 3, q = b < 16 ? qp : qpc;
    const int rem = q % 6, per = q / 6;
    const int* t = s.tr + 16 * b + j;
    int w[4];
    forward4(t[0], t[4], t[8], t[12], w);
    for (int i = 0; i < 4; ++i) {
      const int pos = 4 * i + j;
      if (b >= 16 && pos == 0) {  // the DC, for the 2x2 transform
        s.dcw[b - 16] = w[0];
        continue;
      }
      const int z = quant_inter(w[i], mf[16 * rem + pos], per);
      s.dq[16 * b + pos] = dequant(z, vt[16 * rem + pos], per);
      sym[b < 16 ? kOffLuma + 16 * b + s.izz[pos]
                 : kOffCac + 15 * (b - 16) + s.izz[pos] - 1] = (int16_t)z;
    }
  }
  MTPU_SYNC();
  for (int comp = tid; comp < 2; comp += nt) {
    const int rem = qpc % 6, per = qpc / 6;
    int f[4], z2[4];
    hadamard2x2(s.dcw + 4 * comp, f);
    for (int k = 0; k < 4; ++k) {
      z2[k] = quant_dc2_inter(f[k], mf[16 * rem], per);
      sym[kOffCdc + 4 * comp + k] = (int16_t)z2[k];
    }
    hadamard2x2(z2, f);
    for (int k = 0; k < 4; ++k)
      s.dq[16 * (16 + 4 * comp + k)] = dequant_dc2(f[k], vt[16 * rem], per);
  }
  MTPU_SYNC();
  for (int it = tid; it < 96; it += nt) {
    const int* d = s.dq + 16 * (it >> 2) + 4 * (it & 3);
    inverse4(d[0], d[1], d[2], d[3], s.tr + 16 * (it >> 2) + 4 * (it & 3));
  }
  MTPU_SYNC();
  for (int it = tid; it < 96; it += nt) {
    const int b = it >> 2, j = it & 3;
    const int* g = s.tr + 16 * b + j;
    int res[4];
    inverse4(g[0], g[4], g[8], g[12], res);
    for (int i = 0; i < 4; ++i) {
      const int p = at(b, i, j), rv = (res[i] + 32) >> 6;
      if (b < 16)
        a.recon_y[(int64_t)(16 * r + 4 * (b >> 2) + i) * width + 16 * c +
                  4 * (b & 3) + j] = (uint8_t)clip255(pred8[p] + rv);
      else
        ((b - 16) >> 2 ? a.recon_v : a.recon_u)
            [(int64_t)(8 * r + 4 * (((b - 16) >> 1) & 1) + i) * width_c +
             8 * c + 4 * ((b - 16) & 1) + j] =
                (uint8_t)clip255(s.predc[p] + rv);
    }
  }
  if (tid == 0) {
    sym[0] = (int16_t)qx;
    sym[1] = (int16_t)qy;
    global_add(a.sad_total, cost);
  }
}

}  // namespace media_pcore
