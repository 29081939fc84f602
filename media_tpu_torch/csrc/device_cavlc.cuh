// The arithmetic of the on-device CAVLC P-slice packer (csrc/device_cavlc.cu),
// as functions of one macroblock or one chunk that compile for the card
// (nvcc, __host__ __device__) and for the host (any C++17 compiler), so
// that the CPU tests run the kernel's own arithmetic through
// csrc/device_cavlc_emu.cpp. The plain PyTorch version it must equal, value
// for value, is media_tpu_torch/entropy/device_cavlc.py:pack_pslice_plain.
//
// A P slice is cut into chunks, 27 a macroblock (MB) and one after the last:
// the MB header, its 16 luma 4x4 blocks in z-scan order, the U and V chroma
// DC blocks, the 4 U and 4 V chroma AC blocks, and the trailing skip run. A
// chunk's codewords are produced twice by one function, chunk_codes: once
// to count its bits, once to write them at the chunk's bit offset.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define MTPU_HD __host__ __device__ __forceinline__
#else
#define MTPU_HD inline
#endif

namespace media_cavlc {

constexpr int kChunksPerMb = 27;
constexpr int kBlockSlotBits = 16 * 32;  // BLOCK_WORDS: a block's slot
constexpr int kHeaderSlotBits = 4 * 32;  // HDR_WORDS: a header's slot
constexpr int kMaxLevels = 11;           // levels of the 8-ary bitcat tree
constexpr int kTileLog8 = 3;             // a tile is one level-3 node:
constexpr int kTile = 1 << (3 * kTileLog8);  // 512 chunks

// The int64 tables that device_cavlc.py:_tables builds (one copy of them).
struct Tables {
  const int64_t *len_ct, *cod_ct;    // (3, 4, 17) coeff_token by nC context
  const int64_t *len_cdc, *cod_cdc;  // (4, 5) chroma DC coeff_token
  const int64_t *len_tz, *cod_tz;    // (15, 16) total_zeros
  const int64_t *len_tzc, *cod_tzc;  // (3, 4) chroma DC total_zeros
  const int64_t* rb_packed;          // (7 * 15) run_before, len << 12 | code
  const int64_t* cbp_inter;          // (48) coded_block_pattern -> ue code
  const int64_t* zscan;              // (16) z-scan -> raster block index
};

// The symbol tensors of one slice. Each may be a view: within an MB its
// elements are contiguous, MBs are `row`/`col` elements apart.
struct Symbols {
  const int32_t *mv, *luma, *cdc, *cac;  // (R,C,2) (R,C,16,16) (R,C,2,4)
  int64_t mv_row, mv_col, luma_row, luma_col;  //  (R,C,2,4,15)
  int64_t cdc_row, cdc_col, cac_row, cac_col;
  const int32_t* qp_map;    // (R*C) per-MB QP, or null: no mb_qp_delta
  const int32_t* slice_qp;  // the running QP's seed on the device, or null
  int slice_qp_value;       // ... else this one
  int R, C;
};

// Per-MB results of the metadata pass, and of the scan after it.
struct MbState {
  int32_t* info;      // (n) cbp | is_skip << 6
  int32_t* mvd;       // (n, 2) mv minus its prediction
  uint8_t* nnz;       // (n, 24) nnz of the 16 raster luma, 8 chroma AC blocks
  int32_t* skip_run;  // (n) skipped MBs before this one
  int32_t* qp_delta;  // (n) mb_qp_delta (with a QP map)
  int32_t* trailing;  // (1) skipped MBs after the last coded one
};

// The static capacity schedule of the bitcat tree (device_cavlc.py:
// _bitcat_caps) for this chunk count and stream size: the word capacity of
// a group at each level, and the word-shift mask of that level (the
// reference shifts by the binary digits of prefix >> 5 below the bit length
// of its largest legal shift, so a larger shift wraps).
struct Schedule {
  int levels;
  int64_t cap_bits[kMaxLevels];  // 32 * cap words, level 1..levels
  int64_t wrap[kMaxLevels];      // 2^bitlen(7 * width of the level below) - 1
  int64_t out_bits;              // 32 * out_words
};

// The C ABI's arguments (device_cavlc_launch) as the structs above. Host
// arrays: strides (8: mv, luma, cdc, cac, each row then column), tables (11
// pointers in the order of struct Tables), caps and wraps (levels each).
inline Symbols symbols_of(const int32_t* mv, const int32_t* luma,
                          const int32_t* cdc, const int32_t* cac,
                          const int64_t* strides, const int32_t* qp_map,
                          const int32_t* slice_qp, int slice_qp_value, int R,
                          int C) {
  return Symbols{mv,         luma,       cdc,        cac,
                 strides[0], strides[1], strides[2], strides[3],
                 strides[4], strides[5], strides[6], strides[7],
                 qp_map,     slice_qp,   slice_qp_value, R, C};
}

inline Tables tables_of(const void* const* tables) {
  const int64_t* const* p = reinterpret_cast<const int64_t* const*>(tables);
  return Tables{p[0], p[1], p[2], p[3], p[4], p[5],
                p[6], p[7], p[8], p[9], p[10]};
}

inline Schedule schedule_of(int levels, const int64_t* caps,
                            const int64_t* wraps, int64_t out_words) {
  Schedule sc{};
  sc.levels = levels;
  for (int L = 0; L < levels; ++L) {
    sc.cap_bits[L] = 32 * caps[L];
    sc.wrap[L] = wraps[L];
  }
  sc.out_bits = 32 * out_words;
  return sc;
}

MTPU_HD int mini(int a, int b) { return a < b ? a : b; }
MTPU_HD int maxi(int a, int b) { return a > b ? a : b; }
MTPU_HD int clampi(int x, int lo, int hi) { return mini(maxi(x, lo), hi); }

// ---- per MB ---------------------------------------------------------------

MTPU_HD void mv_of(const Symbols& s, int r, int c, int* m) {
  const int32_t* p = s.mv + r * s.mv_row + c * s.mv_col;
  m[0] = p[0];
  m[1] = p[1];
}

MTPU_HD int median3(int a, int b, int c) {
  const int lo = mini(a, b), hi = maxi(a, b);
  return maxi(lo, mini(hi, c));
}

// Stage 1 of device_cavlc.py:_mb_metadata for MB (r, c): nnz per block,
// the coded block pattern, the median MV prediction (8.4.1.3) and the skip
// decision (P_Skip's MV rule, 8.4.1.1).
MTPU_HD void mb_metadata(const Symbols& s, const Tables& t, int mb,
                         const MbState& st) {
  const int r = mb / s.C, c = mb % s.C;
  const int32_t* luma = s.luma + r * s.luma_row + c * s.luma_col;
  const int32_t* cdc = s.cdc + r * s.cdc_row + c * s.cdc_col;
  const int32_t* cac = s.cac + r * s.cac_row + c * s.cac_col;
  uint8_t* nnz = st.nnz + 24 * (int64_t)mb;
  for (int b = 0; b < 16; ++b) {
    int k = 0;
    for (int i = 0; i < 16; ++i) k += luma[16 * b + i] != 0;
    nnz[b] = (uint8_t)k;
  }
  int cac_any = 0, cdc_any = 0;
  for (int b = 0; b < 8; ++b) {
    int k = 0;
    for (int i = 0; i < 15; ++i) k += cac[15 * b + i] != 0;
    nnz[16 + b] = (uint8_t)k;
    cac_any |= k;
  }
  for (int i = 0; i < 8; ++i) cdc_any |= cdc[i] != 0;
  int cbp = 0;
  for (int g = 0; g < 4; ++g) {
    int any = 0;
    for (int j = 0; j < 4; ++j) any |= nnz[(int)t.zscan[4 * g + j]];
    cbp |= (any != 0) << g;
  }
  cbp |= (cac_any ? 2 : (cdc_any ? 1 : 0)) << 4;

  int mv[2], a[2] = {0, 0}, b[2] = {0, 0}, cc[2] = {0, 0}, d[2] = {0, 0};
  mv_of(s, r, c, mv);
  if (c > 0) mv_of(s, r, c - 1, a);
  if (r > 0) mv_of(s, r - 1, c, b);
  if (r > 0 && c + 1 < s.C) mv_of(s, r - 1, c + 1, cc);
  if (r > 0 && c > 0) mv_of(s, r - 1, c - 1, d);
  const bool c_direct = r > 0 && c + 1 < s.C, c_sub = r > 0 && c > 0;
  int pred[2];
  for (int k = 0; k < 2; ++k) {
    const int ce = c_direct ? cc[k] : (c_sub ? d[k] : 0);
    pred[k] = median3(a[k], b[k], ce);
    if (r == 0 && c > 0) pred[k] = a[k];
    // 8.4.1.3.2 for single-MB-column pictures: only B is available.
    if (s.C == 1 && r > 0 && c == 0) pred[k] = b[k];
  }
  const bool a_zero = c > 0 && a[0] == 0 && a[1] == 0;
  const bool b_zero = r > 0 && b[0] == 0 && b[1] == 0;
  const bool zero_mv = r == 0 || c == 0 || a_zero || b_zero;
  const bool skip = cbp == 0 && mv[0] == (zero_mv ? 0 : pred[0]) &&
                    mv[1] == (zero_mv ? 0 : pred[1]);
  st.info[mb] = cbp | (skip ? 64 : 0);
  st.mvd[2 * mb] = mv[0] - pred[0];
  st.mvd[2 * mb + 1] = mv[1] - pred[1];
}

MTPU_HD int slice_qp_of(const Symbols& s) {
  return s.slice_qp ? *s.slice_qp : s.slice_qp_value;
}

// mb_qp_delta of MB i given the QP of the last MB before it that codes one
// (coded = cbp != 0 and not skipped), wrapped mod 52 into [-26, 25].
MTPU_HD int qp_delta_of(int qp, int prev) {
  int delta = qp - prev;
  if (delta > 25) delta -= 52;
  if (delta < -26) delta += 52;
  return delta;
}

// ---- codewords ------------------------------------------------------------

// ue(v) as the reference writes it: the zero prefix, then v + 1 in
// prefix + 1 bits; the prefix saturates at 17 (codes up to 2^18 - 1).
template <class Emit>
MTPU_HD void ue(Emit& emit, int v) {
  const uint32_t code = (uint32_t)v + 1u;
  int nz = 0;
  for (int k = 1; k < 18; ++k) nz += code >= (1u << k);
  emit(0u, nz);
  emit(code, nz + 1);
}

template <class Emit>
MTPU_HD void se(Emit& emit, int v) {
  ue(emit, v > 0 ? 2 * v - 1 : -2 * v);
}

// One residual block (9.2): coeff_token, trailing-one signs, levels with
// the suffix-length adaptation and the 28-bit escape, total_zeros,
// run_before. `lev` holds mc zig-zag coefficients, |level| <= 2063.
template <class Emit>
MTPU_HD void block_codes(const int32_t* lev, int mc, int nc, bool chroma_dc,
                         const Tables& t, Emit& emit) {
  int lfe[16], pfe[16];  // levels and positions, the last nonzero first
  int tc = 0;
  for (int p = mc - 1; p >= 0; --p) {
    const int v = lev[p];
    if (v != 0) {
      lfe[tc] = v;
      pfe[tc] = p;
      ++tc;
    }
  }
  const int tz = tc > 0 ? pfe[0] + 1 - tc : 0;
  int t1 = 0;
  while (t1 < tc && t1 < 3 && (lfe[t1] == 1 || lfe[t1] == -1)) ++t1;

  if (chroma_dc) {
    emit((uint32_t)t.cod_cdc[t1 * 5 + tc], (int)t.len_cdc[t1 * 5 + tc]);
  } else if (nc >= 8) {
    emit(tc == 0 ? 3u : (uint32_t)(((tc - 1) << 2) | t1), 6);
  } else {
    const int i = ((nc < 2 ? 0 : (nc < 4 ? 1 : 2)) * 4 + t1) * 17 + tc;
    emit((uint32_t)t.cod_ct[i], (int)t.len_ct[i]);
  }
  uint32_t signs = 0;
  for (int k = 0; k < t1; ++k) signs = (signs << 1) | (lfe[k] < 0);
  emit(signs, t1);

  int suf = (tc > 10 && t1 < 3) ? 1 : 0;
  for (int k = 0; k < tc - t1; ++k) {
    const int lv = lfe[t1 + k];
    int lc = lv > 0 ? 2 * lv - 2 : -2 * lv - 1;
    if (k == 0 && t1 < 3) lc -= 2;
    if (suf == 0) {
      if (lc < 14)
        emit(1u, lc + 1);
      else if (lc < 30)
        emit((uint32_t)(16 | (lc - 14)), 19);
      else
        emit((uint32_t)(4096 | clampi(lc - 30, 0, 4095)), 28);
    } else {
      const int pfx = lc >> suf;
      if (pfx < 15)
        emit((1u << suf) | (uint32_t)(lc & ((1 << suf) - 1)), pfx + 1 + suf);
      else
        emit((uint32_t)(4096 | clampi(lc - (15 << suf), 0, 4095)), 28);
    }
    int ns = suf == 0 ? 1 : suf;
    const int mag = lv < 0 ? -lv : lv;
    if (mag > (3 << (ns - 1)) && ns < 6) ++ns;
    suf = ns;
  }

  if (tc > 0 && tc < mc) {
    if (chroma_dc) {
      const int i = clampi(tc - 1, 0, 2) * 4 + clampi(tz, 0, 3);
      emit((uint32_t)t.cod_tzc[i], (int)t.len_tzc[i]);
    } else {
      const int i = clampi(tc - 1, 0, 14) * 16 + clampi(tz, 0, 15);
      emit((uint32_t)t.cod_tz[i], (int)t.len_tz[i]);
    }
  }
  int zl = tz;
  for (int k = 0; k < tc - 1; ++k) {
    const int run = clampi(pfe[k] - pfe[k + 1] - 1, 0, 14);
    if (zl > 0) {
      const int zi = clampi(mini(zl, 7) - 1, 0, 6);
      if (zi == 6) {
        emit(run < 7 ? (uint32_t)(7 - run) : 1u, run < 7 ? 3 : run - 3);
      } else {
        const int64_t p = t.rb_packed[zi * 15 + run];
        emit((uint32_t)(p & 0xFFF), (int)(p >> 12));
      }
    }
    zl -= run;
  }
}

// nC (9.2.1) of a block at (x, y) of an nnz grid whose blocks of one MB are
// `w` wide: the left (A) and upper (B) neighbours, picture edges only (one
// slice). nnz(mb, blk) reads the grid.
template <class Nnz>
MTPU_HD int n_c(int r, int c, int bx, int by, int w, const Nnz& nnz) {
  const bool a_av = bx > 0 || c > 0, b_av = by > 0 || r > 0;
  const int na = !a_av ? 0 : (bx > 0 ? nnz(r, c, by * w + bx - 1)
                                     : nnz(r, c - 1, by * w + w - 1));
  const int nb = !b_av ? 0 : (by > 0 ? nnz(r, c, (by - 1) * w + bx)
                                     : nnz(r - 1, c, (w - 1) * w + bx));
  if (a_av && b_av) return (na + nb + 1) >> 1;
  return a_av ? na : (b_av ? nb : 0);
}

// Every codeword of chunk `ch` (0 <= ch <= 27 n), in stream order; a chunk
// that the MB's skip flag or coded block pattern leaves out emits nothing.
template <class Emit>
MTPU_HD void chunk_codes(const Symbols& s, const Tables& t, const MbState& st,
                         int64_t ch, Emit& emit) {
  const int n = s.R * s.C;
  if (ch == (int64_t)kChunksPerMb * n) {  // the trailing skip run
    const int run = *st.trailing;
    if (run > 0) ue(emit, run);
    return;
  }
  const int mb = (int)(ch / kChunksPerMb), k = (int)(ch % kChunksPerMb);
  const int info = st.info[mb];
  if (info & 64) return;  // P_Skip: no chunk of this MB is coded
  const int cbp = info & 63;
  const int r = mb / s.C, c = mb % s.C;
  if (k == 0) {  // header: mb_skip_run, mb_type P_L0_16x16, mvd, cbp, dQP
    ue(emit, st.skip_run[mb]);
    ue(emit, 0);
    se(emit, st.mvd[2 * mb]);
    se(emit, st.mvd[2 * mb + 1]);
    ue(emit, (int)t.cbp_inter[cbp]);
    if (cbp > 0) {
      if (s.qp_map)
        se(emit, st.qp_delta[mb]);
      else
        emit(1u, 1);  // se(0)
    }
    return;
  }
  auto nnz = [&](int rr, int cc, int blk) {
    return (int)st.nnz[24 * (int64_t)(rr * s.C + cc) + blk];
  };
  if (k <= 16) {  // luma block, z-scan index k - 1
    if (!((cbp >> ((k - 1) >> 2)) & 1)) return;
    const int b = (int)t.zscan[k - 1];
    const int nc = n_c(r, c, b & 3, b >> 2, 4, nnz);
    block_codes(s.luma + r * s.luma_row + c * s.luma_col + 16 * b, 16, nc,
                false, t, emit);
    return;
  }
  const int cbp_c = cbp >> 4;
  if (k <= 18) {  // chroma DC, U then V
    if (cbp_c == 0) return;
    block_codes(s.cdc + r * s.cdc_row + c * s.cdc_col + 4 * (k - 17), 4, 0,
                true, t, emit);
    return;
  }
  if (cbp_c != 2) return;  // chroma AC, 4 U blocks then 4 V (raster)
  const int comp = (k - 19) >> 2, b = (k - 19) & 3;
  auto nnz_c = [&](int rr, int cc, int blk) {
    return nnz(rr, cc, 16 + 4 * comp + blk);
  };
  const int nc = n_c(r, c, b & 1, b >> 1, 2, nnz_c);
  block_codes(s.cac + r * s.cac_row + c * s.cac_col + 15 * (k - 19), 15, nc,
              false, t, emit);
}

// The bits a chunk's codewords would take in full.
struct Count {
  int bits = 0;
  MTPU_HD void operator()(uint32_t, int len) { bits += len; }
};

// Where the reference's bitcat tree puts a chunk's bits. At level L the
// chunk's ancestor is shifted right by P, the bits of the nodes before it
// in its group of 8 (bitcat_reduce's exclusive prefix): by P & 31 bits,
// then by the words of P >> 5 that the level's shift mask keeps; bits that
// land past the group's capacity are dropped. prefix(L) returns P at level
// L (1-based). So bit i of the chunk lands at shift + i if i < keep, where
// keep also holds the chunk's slot (a block's 512 bits, a header's 128) and
// the stream's end. Without overflow shift is the chunk's exclusive prefix
// in the slice and keep its bit count.
template <class Prefix>
MTPU_HD void place(const Schedule& sc, int64_t slot_bits, int64_t bits,
                   const Prefix& prefix, int64_t* shift, int64_t* keep) {
  int64_t at = 0, k = slot_bits < bits ? slot_bits : bits;
  for (int L = 1; L <= sc.levels; ++L) {
    const int64_t p = prefix(L);
    at += (p & 31) + 32 * ((p >> 5) & sc.wrap[L - 1]);
    const int64_t room = sc.cap_bits[L - 1] - at;
    k = room < k ? room : k;
  }
  const int64_t room = sc.out_bits - at;
  *shift = at;
  *keep = room < k ? room : k;
}

MTPU_HD int64_t slot_bits_of(const Symbols& s, int64_t ch) {
  const int64_t n = (int64_t)s.R * s.C;
  return (ch == kChunksPerMb * n || ch % kChunksPerMb == 0) ? kHeaderSlotBits
                                                            : kBlockSlotBits;
}

// Writes the first `keep` bits of a chunk's codewords MSB-first from bit
// position `pos` of a stream of 32-bit words held in 64-bit slots, one OR
// per word touched (or_word: an atomic OR on the card, a plain one on the
// host), so that chunks sharing a word need no order.
template <class OrWord>
struct Writer {
  uint64_t* out;
  int64_t pos, left;
  OrWord or_word;
  int64_t word = -1;
  uint32_t acc = 0;

  MTPU_HD void operator()(uint32_t val, int len) {
    if (len <= 0 || left <= 0) return;
    val &= len >= 32 ? 0xFFFFFFFFu : ((1u << len) - 1u);
    if (len > left) {  // keep the codeword's leading bits only
      val >>= (int)(len - left);
      len = (int)left;
    }
    left -= len;
    while (len > 0) {
      const int64_t w = pos >> 5;
      const int o = (int)(pos & 31);
      const int take = len < 32 - o ? len : 32 - o;
      const uint32_t part = (val >> (len - take)) &
                            (take >= 32 ? 0xFFFFFFFFu : ((1u << take) - 1u));
      if (w != word) {
        flush();
        word = w;
      }
      acc |= part << (32 - o - take);
      pos += take;
      len -= take;
    }
  }

  MTPU_HD void flush() {
    if (word >= 0 && acc) or_word(out + word, acc);
    acc = 0;
  }
};

}  // namespace media_cavlc
