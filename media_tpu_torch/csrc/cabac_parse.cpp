// Native CABAC slice PARSERS: decode twins of
// media_tpu_torch/csrc/cabac_pack.cpp and exact mirrors of
// media_tpu_torch/entropy/cabac_slice.parse_pslice_cabac / parse_islice_cabac
// (the Python implementations stay the tested oracle; tests assert identical
// symbol arrays). A copy of the JAX package's csrc/cabac_parse.cpp. This is
// the decode-side CABAC entropy hot path, in line with the C++ CAVLC parser
// (media_tpu_torch/csrc/cavlc_parse.cpp).

#include <cstdint>
#include <cstring>
#include <vector>

#include "cavlc_tables.inc"

namespace {

constexpr int NUM_CTX = 460;

// ctxIdx bases (media_tpu_torch/entropy/cabac_contexts.py)
constexpr int MB_SKIP_P = 11;
constexpr int MB_TYPE_P = 14;
constexpr int MB_TYPE_I = 3;
constexpr int CHROMA_PRED = 64;
constexpr int I4_PRED_FLAG = 68;
constexpr int I4_PRED_REM = 69;
constexpr int MVD_X = 40;
constexpr int MVD_Y = 47;
constexpr int MB_QP_DELTA = 60;
constexpr int CBP_LUMA = 73;
constexpr int CBP_CHROMA = 77;
constexpr int CBF = 85;
constexpr int SIG = 105;
constexpr int LAST = 166;
constexpr int ABS_LVL = 227;

const int CAT_OFFSET_SIG[5] = {0, 15, 29, 44, 47};
const int CAT_OFFSET_ABS[5] = {0, 10, 20, 30, 39};
const int CAT_MAXCOEFF[5] = {16, 15, 16, 4, 15};

struct Ctx {
  int8_t state[NUM_CTX];
  int8_t mps[NUM_CTX];
  void init(int qp, const int32_t* init_mn) {
    if (qp < 0) qp = 0;
    if (qp > 51) qp = 51;
    for (int i = 0; i < NUM_CTX; i++) {
      int m = init_mn[2 * i], n = init_mn[2 * i + 1];
      int pre = ((m * qp) >> 4) + n;
      if (pre < 1) pre = 1;
      if (pre > 126) pre = 126;
      mps[i] = pre > 63 ? 1 : 0;
      state[i] = pre > 63 ? pre - 64 : 63 - pre;
    }
  }
};

struct Dec {
  const uint8_t* data;
  int64_t len;   // bytes
  int64_t pos;   // bit position
  int range = 510;
  uint32_t offset = 0;

  void init(const uint8_t* d, int64_t nbytes, int64_t bitpos) {
    data = d;
    len = nbytes;
    pos = bitpos;
    for (int i = 0; i < 9; i++) offset = (offset << 1) | bit();
  }
  inline uint32_t bit() {
    int64_t p = pos++;
    uint8_t b = (p >> 3) < len ? data[p >> 3] : 0;
    return (b >> (7 - (p & 7))) & 1;
  }
  inline int decode_bin(Ctx& c, int idx) {
    int st = c.state[idx];
    int mps = c.mps[idx];
    int q = (range >> 6) & 3;
    int r_lps = kRangeTabLPS[st][q];
    range -= r_lps;
    int v;
    if ((int)offset >= range) {
      v = 1 - mps;
      offset -= range;
      range = r_lps;
      if (st == 0) c.mps[idx] = (int8_t)(1 - mps);
      c.state[idx] = kTransIdxLPS[st];
    } else {
      v = mps;
      c.state[idx] = (int8_t)(st < 62 ? st + 1 : st);
    }
    while (range < 256) {
      range <<= 1;
      offset = (offset << 1) | bit();
    }
    return v;
  }
  inline int decode_bypass() {
    offset = (offset << 1) | bit();
    if ((int)offset >= range) {
      offset -= range;
      return 1;
    }
    return 0;
  }
  inline int decode_terminate() {
    range -= 2;
    if ((int)offset >= range) return 1;
    while (range < 256) {
      range <<= 1;
      offset = (offset << 1) | bit();
    }
    return 0;
  }
};

template <typename CtxOf>
int dec_tu(Dec& d, Ctx& c, int cmax, CtxOf ctx_of) {
  int v = 0;
  while (v < cmax && d.decode_bin(c, ctx_of(v))) v++;
  return v;
}

int64_t dec_eg_bypass(Dec& d, int k) {
  int64_t val = 0;
  while (d.decode_bypass()) {
    val += (int64_t)1 << k;
    k++;
    if (k > 30) return -1;  // corrupt stream guard
  }
  int64_t suffix = 0;
  for (int i = 0; i < k; i++) suffix = (suffix << 1) | d.decode_bypass();
  return val + suffix;
}

int dec_mvd(Dec& d, Ctx& c, int base, int esum, bool* err) {
  int inc0 = esum < 3 ? 0 : (esum <= 32 ? 1 : 2);
  auto ctx_of = [&](int k) {
    return base + (k == 0 ? inc0 : (k + 2 < 6 ? k + 2 : 6));
  };
  int64_t a = dec_tu(d, c, 9, ctx_of);
  if (a == 9) {
    int64_t e = dec_eg_bypass(d, 3);
    if (e < 0) { *err = true; return 0; }
    a += e;
  }
  if (a && d.decode_bypass()) return (int)-a;
  return (int)a;
}

// Mirror of cabac_slice._dec_block.
int dec_block(Dec& d, Ctx& c, int cat, int cbf_inc, int32_t* levels,
              bool* err) {
  int mc = CAT_MAXCOEFF[cat];
  std::memset(levels, 0, sizeof(int32_t) * mc);
  if (!d.decode_bin(c, CBF + 4 * cat + cbf_inc)) return 0;
  int off = CAT_OFFSET_SIG[cat];
  int sig_pos[16], nsig = 0;
  bool last_found = false;
  for (int i = 0; i < mc - 1; i++) {
    if (d.decode_bin(c, SIG + off + i)) {
      sig_pos[nsig++] = i;
      if (d.decode_bin(c, LAST + off + i)) {
        last_found = true;
        break;
      }
    }
  }
  if (!last_found) sig_pos[nsig++] = mc - 1;
  int num_eq1 = 0, num_gt1 = 0;
  int aoff = ABS_LVL + CAT_OFFSET_ABS[cat];
  int cap = cat == 3 ? 3 : 4;
  for (int j = nsig - 1; j >= 0; j--) {
    int i = sig_pos[j];
    int inc0 = num_gt1 ? 0 : (1 + num_eq1 < 4 ? 1 + num_eq1 : 4);
    int incN = 5 + (num_gt1 < cap ? num_gt1 : cap);
    auto ctx_of = [&](int k) { return aoff + (k == 0 ? inc0 : incN); };
    int64_t a = dec_tu(d, c, 14, ctx_of);
    if (a == 14) {
      int64_t e = dec_eg_bypass(d, 0);
      if (e < 0) { *err = true; return 0; }
      a += e;
    }
    int64_t val = a + 1;
    if (d.decode_bypass()) val = -val;
    levels[i] = (int32_t)val;
    if (a == 0)
      num_eq1++;
    else
      num_gt1++;
  }
  return 1;
}

// cbp (mirror of _dec_cbp); a/b values: -1 == unavailable.
void dec_cbp(Dec& d, Ctx& c, int cbp_l_a, int cbp_l_b, int cbp_c_a,
             int cbp_c_b, int* out_luma, int* out_chroma) {
  int cbp_luma = 0;
  for (int g8 = 0; g8 < 4; g8++) {
    int bit_a, bit_b;
    if (g8 % 2 == 0)
      bit_a = cbp_l_a >= 0 ? (cbp_l_a >> (g8 + 1)) & 1 : 1;
    else
      bit_a = (cbp_luma >> (g8 - 1)) & 1;
    if (g8 < 2)
      bit_b = cbp_l_b >= 0 ? (cbp_l_b >> (g8 + 2)) & 1 : 1;
    else
      bit_b = (cbp_luma >> (g8 - 2)) & 1;
    int inc = (1 - bit_a) + 2 * (1 - bit_b);
    cbp_luma |= d.decode_bin(c, CBP_LUMA + inc) << g8;
  }
  int a = cbp_c_a > 0 ? cbp_c_a : 0;
  int b = cbp_c_b > 0 ? cbp_c_b : 0;
  int inc0 = (a ? 1 : 0) + 2 * (b ? 1 : 0);
  int cbp_chroma = 0;
  if (d.decode_bin(c, CBP_CHROMA + inc0)) {
    int inc1 = (a == 2 ? 1 : 0) + 2 * (b == 2 ? 1 : 0);
    cbp_chroma = d.decode_bin(c, CBP_CHROMA + 4 + inc1) ? 2 : 1;
  }
  *out_luma = cbp_luma;
  *out_chroma = cbp_chroma;
}

inline int median3(int a, int b, int c) {
  int mx = a > b ? a : b;
  int mn = a < b ? a : b;
  return mx < c ? mx : (mn > c ? mn : c);
}

struct MvPred {
  const int32_t* mv;
  int C;
  void predict(int r, int c, int n_cols, int* px, int* py) const {
    bool a_av = c > 0, b_av = r > 0;
    bool c_av = r > 0 && c + 1 < n_cols;
    int cx = 0, cy = 0, ax = 0, ay = 0, bx = 0, by = 0;
    if (a_av) { ax = mv[(r * C + c - 1) * 2]; ay = mv[(r * C + c - 1) * 2 + 1]; }
    if (b_av) { bx = mv[((r - 1) * C + c) * 2]; by = mv[((r - 1) * C + c) * 2 + 1]; }
    if (c_av) {
      cx = mv[((r - 1) * C + c + 1) * 2]; cy = mv[((r - 1) * C + c + 1) * 2 + 1];
    } else if (r > 0 && c > 0) {
      cx = mv[((r - 1) * C + c - 1) * 2]; cy = mv[((r - 1) * C + c - 1) * 2 + 1];
      c_av = true;
    }
    if (a_av && !b_av && !c_av) { *px = ax; *py = ay; return; }
    // 8.4.1.3.2 rule 2 (see cavlc_parse.cpp): exactly one available
    // neighbor -> its MV alone; only differs from the median for
    // single-MB-column pictures (n_cols == 1, r > 0: selects mvB).
    int n_av = (a_av ? 1 : 0) + (b_av ? 1 : 0) + (c_av ? 1 : 0);
    if (n_av == 1) {
      if (a_av) { *px = ax; *py = ay; }
      else if (b_av) { *px = bx; *py = by; }
      else { *px = cx; *py = cy; }
      return;
    }
    *px = median3(ax, bx, cx);
    *py = median3(ay, by, cy);
  }
  void skip_mv(int r, int c, int n_cols, int* px, int* py) const {
    if (r == 0 || c == 0) { *px = 0; *py = 0; return; }
    int ax = mv[(r * C + c - 1) * 2], ay = mv[(r * C + c - 1) * 2 + 1];
    int bx = mv[((r - 1) * C + c) * 2], by = mv[((r - 1) * C + c) * 2 + 1];
    if ((ax == 0 && ay == 0) || (bx == 0 && by == 0)) { *px = 0; *py = 0; return; }
    predict(r, c, n_cols, px, py);
  }
};

}  // namespace

extern "C" {

// Parse a CABAC P slice's slice_data (P_L0_16x16 / P_Skip, fixed QP).
// data/nbytes: RBSP; bitpos: first bit after cabac alignment. Returns MBs
// parsed (terminate bin honored) or <0 (-2: tools beyond the envelope —
// caller falls back to the Python parser).
int64_t mtpu_cabac_parse_slice_p(const uint8_t* data, int64_t nbytes,
                                 int64_t bitpos, int R, int C, int qp,
                                 const int32_t* init_mn, int32_t* mv,
                                 int32_t* luma, int32_t* cdc, int32_t* cac,
                                 int32_t* qp_map) {
  Ctx ctx;
  ctx.init(qp, init_mn);
  Dec d;
  d.init(data, nbytes, bitpos);
  int n_mb = R * C;
  std::memset(mv, 0, sizeof(int32_t) * n_mb * 2);
  std::memset(luma, 0, sizeof(int32_t) * n_mb * 256);
  std::memset(cdc, 0, sizeof(int32_t) * n_mb * 8);
  std::memset(cac, 0, sizeof(int32_t) * n_mb * 120);
  std::vector<int8_t> skip_map((size_t)n_mb, 0);
  std::vector<int32_t> cbp_map((size_t)n_mb, -1);
  std::vector<int32_t> mvd_map((size_t)n_mb * 2, 0);
  // cbf neighbor grids (inter MB: edge condTermFlag = 0)
  std::vector<int8_t> lgrid((size_t)R * 4 * C * 4, 0);
  std::vector<int8_t> cgrid((size_t)2 * R * 2 * C * 2, 0);
  std::vector<int8_t> cdcgrid((size_t)2 * R * C, 0);
  MvPred pred{mv, C};
  bool err = false;
  int cur_qp = qp, prev_delta = 0;

  // mb_qp_delta decode (spec 9.3.2.7): U binarization; ctxIdxInc bin0 =
  // (prev mb_qp_delta != 0), bin1 -> +2, bins >= 2 -> +3.
  auto dec_qp_delta = [&]() -> int {
    int ctx0 = MB_QP_DELTA + (prev_delta ? 1 : 0);
    if (!d.decode_bin(ctx, ctx0)) return 0;
    int k = 1;
    while (d.decode_bin(ctx, MB_QP_DELTA + (k == 1 ? 2 : 3))) {
      if (++k > 52) { err = true; return 0; }
    }
    return (k & 1) ? (k + 1) >> 1 : -(k >> 1);
  };

  auto inc_luma = [&](int by, int bx) {
    int a = bx > 0 ? lgrid[by * C * 4 + bx - 1] : 0;
    int b = by > 0 ? lgrid[(by - 1) * C * 4 + bx] : 0;
    return a + 2 * b;
  };
  auto inc_chroma = [&](int comp, int by, int bx) {
    int a = bx > 0 ? cgrid[(comp * R * 2 + by) * C * 2 + bx - 1] : 0;
    int b = by > 0 ? cgrid[(comp * R * 2 + by - 1) * C * 2 + bx] : 0;
    return a + 2 * b;
  };
  auto inc_cdc = [&](int comp, int r, int c) {
    int a = c > 0 ? cdcgrid[(size_t)comp * R * C + r * C + c - 1] : 0;
    int b = r > 0 ? cdcgrid[(size_t)comp * R * C + (r - 1) * C + c] : 0;
    return a + 2 * b;
  };

  for (int r = 0; r < R; r++) {
    for (int c = 0; c < C; c++) {
      int mb = r * C + c;
      int inc = ((c > 0 && !skip_map[mb - 1]) ? 1 : 0)
                + ((r > 0 && !skip_map[mb - C]) ? 1 : 0);
      if (d.decode_bin(ctx, MB_SKIP_P + inc)) {
        int sx, sy;
        pred.skip_mv(r, c, C, &sx, &sy);
        mv[mb * 2] = sx;
        mv[mb * 2 + 1] = sy;
        skip_map[mb] = 1;
        cbp_map[mb] = 0;
        if (qp_map) qp_map[mb] = cur_qp;
        prev_delta = 0;
        if (d.decode_terminate()) return mb + 1;
        continue;
      }
      if (d.decode_bin(ctx, MB_TYPE_P)) return -2;  // intra-in-P
      d.decode_bin(ctx, MB_TYPE_P + 1);
      d.decode_bin(ctx, MB_TYPE_P + 2);
      int ea = 0, eb = 0;
      if (c > 0) {
        ea += mvd_map[(mb - 1) * 2] < 0 ? -mvd_map[(mb - 1) * 2]
                                        : mvd_map[(mb - 1) * 2];
        eb += mvd_map[(mb - 1) * 2 + 1] < 0 ? -mvd_map[(mb - 1) * 2 + 1]
                                            : mvd_map[(mb - 1) * 2 + 1];
      }
      if (r > 0) {
        ea += mvd_map[(mb - C) * 2] < 0 ? -mvd_map[(mb - C) * 2]
                                        : mvd_map[(mb - C) * 2];
        eb += mvd_map[(mb - C) * 2 + 1] < 0 ? -mvd_map[(mb - C) * 2 + 1]
                                            : mvd_map[(mb - C) * 2 + 1];
      }
      int mvdx = dec_mvd(d, ctx, MVD_X, ea, &err);
      int mvdy = dec_mvd(d, ctx, MVD_Y, eb, &err);
      if (err) return -1;
      int px, py;
      pred.predict(r, c, C, &px, &py);
      mv[mb * 2] = px + mvdx;
      mv[mb * 2 + 1] = py + mvdy;
      mvd_map[mb * 2] = mvdx;
      mvd_map[mb * 2 + 1] = mvdy;
      int la = c > 0 ? (cbp_map[mb - 1] >= 0 ? (cbp_map[mb - 1] & 15) : 0) : -1;
      int lb = r > 0 ? (cbp_map[mb - C] >= 0 ? (cbp_map[mb - C] & 15) : 0) : -1;
      int ca = c > 0 ? (cbp_map[mb - 1] >= 0 ? (cbp_map[mb - 1] >> 4) : 0) : -1;
      int cb = r > 0 ? (cbp_map[mb - C] >= 0 ? (cbp_map[mb - C] >> 4) : 0) : -1;
      int cbp_luma, cbp_chroma;
      dec_cbp(d, ctx, la, lb, ca, cb, &cbp_luma, &cbp_chroma);
      cbp_map[mb] = cbp_luma | (cbp_chroma << 4);
      if (cbp_luma || cbp_chroma) {
        int delta = dec_qp_delta();
        if (err) return -1;
        prev_delta = delta;
        cur_qp += delta;
        if (cur_qp < 0) cur_qp += 52;       // spec 7.4.5 mod-52 wrap
        else if (cur_qp > 51) cur_qp -= 52;
      } else {
        prev_delta = 0;
      }
      if (qp_map) qp_map[mb] = cur_qp;
      int32_t* lv = luma + (size_t)mb * 256;
      for (int g8 = 0; g8 < 4; g8++) {
        if (!((cbp_luma >> g8) & 1)) {
          for (int k = 0; k < 4; k++) {
            int b = kZscanToRaster[g8 * 4 + k];
            lgrid[(r * 4 + b / 4) * C * 4 + c * 4 + b % 4] = 0;
          }
          continue;
        }
        for (int k = 0; k < 4; k++) {
          int b = kZscanToRaster[g8 * 4 + k];
          int by = r * 4 + b / 4, bx = c * 4 + b % 4;
          int cbf = dec_block(d, ctx, 2, inc_luma(by, bx), lv + b * 16, &err);
          if (err) return -1;
          lgrid[by * C * 4 + bx] = (int8_t)cbf;
        }
      }
      // chroma: mirror of _chroma_blocks(write=False)
      int32_t* dcp = cdc + (size_t)mb * 8;
      int32_t* acp = cac + (size_t)mb * 120;
      if (cbp_chroma == 0) {
        for (int comp = 0; comp < 2; comp++) {
          cdcgrid[(size_t)comp * R * C + mb] = 0;
          for (int b = 0; b < 4; b++)
            cgrid[(comp * R * 2 + r * 2 + b / 2) * C * 2 + c * 2 + b % 2] = 0;
        }
      } else {
        for (int comp = 0; comp < 2; comp++) {
          int cbf = dec_block(d, ctx, 3, inc_cdc(comp, r, c), dcp + comp * 4,
                              &err);
          if (err) return -1;
          cdcgrid[(size_t)comp * R * C + mb] = (int8_t)cbf;
        }
        if (cbp_chroma == 2) {
          for (int comp = 0; comp < 2; comp++) {
            for (int b = 0; b < 4; b++) {
              int by = r * 2 + b / 2, bx = c * 2 + b % 2;
              int cbf = dec_block(d, ctx, 4, inc_chroma(comp, by, bx),
                                  acp + (comp * 4 + b) * 15, &err);
              if (err) return -1;
              cgrid[(comp * R * 2 + by) * C * 2 + bx] = (int8_t)cbf;
            }
          }
        } else {
          for (int comp = 0; comp < 2; comp++)
            for (int b = 0; b < 4; b++)
              cgrid[(comp * R * 2 + r * 2 + b / 2) * C * 2 + c * 2 + b % 2] = 0;
        }
      }
      if (d.decode_terminate()) return mb + 1;
    }
  }
  return n_mb;
}

// Parse a CABAC I slice's slice_data (I_16x16 + I_4x4, fixed QP) — the
// native mirror of media_tpu_torch/entropy/cabac_slice.parse_islice_cabac.
// Returns MBs parsed, or <0 (-2: I_PCM / per-MB QP, outside this envelope —
// the caller falls back to the Python parser; -1: corrupt stream).
int64_t mtpu_cabac_parse_slice_i(const uint8_t* data, int64_t nbytes,
                                 int64_t bitpos, int R, int C, int qp,
                                 const int32_t* init_mn,
                                 int32_t* mode16, int32_t* chroma_mode,
                                 int32_t* dc, int32_t* ac,
                                 int32_t* cdc, int32_t* cac,
                                 int32_t* is_i4, int32_t* modes4,
                                 int32_t* luma4) {
  Ctx ctx;
  ctx.init(qp, init_mn);
  Dec d;
  d.init(data, nbytes, bitpos);
  int n_mb = R * C;
  std::memset(mode16, 0, sizeof(int32_t) * n_mb);
  std::memset(chroma_mode, 0, sizeof(int32_t) * n_mb);
  std::memset(dc, 0, sizeof(int32_t) * n_mb * 16);
  std::memset(ac, 0, sizeof(int32_t) * n_mb * 16 * 15);
  std::memset(cdc, 0, sizeof(int32_t) * n_mb * 8);
  std::memset(cac, 0, sizeof(int32_t) * n_mb * 120);
  std::memset(is_i4, 0, sizeof(int32_t) * n_mb);
  std::memset(modes4, 0, sizeof(int32_t) * n_mb * 16);
  std::memset(luma4, 0, sizeof(int32_t) * n_mb * 256);

  // cbf neighbor state; I slice: edge condTermFlag = 1 (spec 9.3.3.1.1.9)
  std::vector<int8_t> lgrid((size_t)R * 4 * C * 4, 0);
  std::vector<int8_t> cgrid((size_t)2 * R * 2 * C * 2, 0);
  std::vector<int8_t> dcgrid((size_t)R * C, 0);
  std::vector<int8_t> cdcgrid((size_t)2 * R * C, 0);
  std::vector<int32_t> cbp_map((size_t)n_mb, 0);
  std::vector<int32_t> cm_map((size_t)n_mb, 0);
  std::vector<int8_t> mode_grid((size_t)R * 4 * C * 4, -1);
  bool err = false;

  auto inc_luma = [&](int by, int bx) {
    int a = bx > 0 ? lgrid[by * C * 4 + bx - 1] : 1;
    int b = by > 0 ? lgrid[(by - 1) * C * 4 + bx] : 1;
    return a + 2 * b;
  };
  auto inc_chroma = [&](int comp, int by, int bx) {
    int a = bx > 0 ? cgrid[(comp * R * 2 + by) * C * 2 + bx - 1] : 1;
    int b = by > 0 ? cgrid[(comp * R * 2 + by - 1) * C * 2 + bx] : 1;
    return a + 2 * b;
  };
  auto inc_dc = [&](int r, int c) {
    int a = c > 0 ? dcgrid[r * C + c - 1] : 1;
    int b = r > 0 ? dcgrid[(r - 1) * C + c] : 1;
    return a + 2 * b;
  };
  auto inc_cdc = [&](int comp, int r, int c) {
    int a = c > 0 ? cdcgrid[(size_t)comp * R * C + r * C + c - 1] : 1;
    int b = r > 0 ? cdcgrid[(size_t)comp * R * C + (r - 1) * C + c] : 1;
    return a + 2 * b;
  };
  auto i4_pred_mode = [&](int gy, int gx) {
    if (gx <= 0 || gy <= 0) return 2;
    int a = mode_grid[gy * C * 4 + gx - 1];
    int b = mode_grid[(gy - 1) * C * 4 + gx];
    if (a < 0) a = 2;
    if (b < 0) b = 2;
    return a < b ? a : b;
  };

  for (int r = 0; r < R; r++) {
    for (int c = 0; c < C; c++) {
      int mb = r * C + c;
      int avail_inc = ((c > 0 && !is_i4[mb - 1]) ? 1 : 0)
                      + ((r > 0 && !is_i4[mb - C]) ? 1 : 0);
      int cbp_luma, cbp_chroma;
      int32_t* lv4 = luma4 + (size_t)mb * 256;
      if (!d.decode_bin(ctx, MB_TYPE_I + avail_inc)) {
        // ---- I_NxN (I_4x4) ----
        is_i4[mb] = 1;
        for (int zi = 0; zi < 16; zi++) {
          int bi = kZscanToRaster[zi];
          int gy = r * 4 + bi / 4, gx = c * 4 + bi % 4;
          int pred = i4_pred_mode(gy, gx);
          int m;
          if (d.decode_bin(ctx, I4_PRED_FLAG)) {
            m = pred;
          } else {
            int rem = 0;
            for (int k = 0; k < 3; k++)
              rem |= d.decode_bin(ctx, I4_PRED_REM) << k;
            m = rem < pred ? rem : rem + 1;
          }
          modes4[(size_t)mb * 16 + zi] = m;
          mode_grid[gy * C * 4 + gx] = (int8_t)m;
        }
        int cm_inc = ((c > 0 && cm_map[mb - 1]) ? 1 : 0)
                     + ((r > 0 && cm_map[mb - C]) ? 1 : 0);
        int cm = dec_tu(d, ctx, 3, [&](int k) {
          return CHROMA_PRED + (k == 0 ? cm_inc : 3);
        });
        chroma_mode[mb] = cm;
        cm_map[mb] = cm;
        int la = c > 0 ? (cbp_map[mb - 1] & 15) : -1;
        int lb = r > 0 ? (cbp_map[mb - C] & 15) : -1;
        int ca = c > 0 ? (cbp_map[mb - 1] >> 4) : -1;
        int cb = r > 0 ? (cbp_map[mb - C] >> 4) : -1;
        dec_cbp(d, ctx, la, lb, ca, cb, &cbp_luma, &cbp_chroma);
        cbp_map[mb] = cbp_luma | (cbp_chroma << 4);
        if (cbp_luma || cbp_chroma) {
          if (d.decode_bin(ctx, MB_QP_DELTA)) return -2;  // per-MB QP
        }
        dcgrid[mb] = 0;
        for (int g8 = 0; g8 < 4; g8++) {
          if (!((cbp_luma >> g8) & 1)) {
            for (int k = 0; k < 4; k++) {
              int b = kZscanToRaster[g8 * 4 + k];
              lgrid[(r * 4 + b / 4) * C * 4 + c * 4 + b % 4] = 0;
            }
            continue;
          }
          for (int k = 0; k < 4; k++) {
            int b = kZscanToRaster[g8 * 4 + k];
            int by = r * 4 + b / 4, bx = c * 4 + b % 4;
            int cbf = dec_block(d, ctx, 2, inc_luma(by, bx),
                                lv4 + b * 16, &err);
            if (err) return -1;
            lgrid[by * C * 4 + bx] = (int8_t)cbf;
          }
        }
      } else {
        // ---- I_16x16 ----
        if (d.decode_terminate()) return -2;  // I_PCM
        cbp_luma = d.decode_bin(ctx, MB_TYPE_I + 3) ? 15 : 0;
        cbp_chroma = 0;
        if (d.decode_bin(ctx, MB_TYPE_I + 4))
          cbp_chroma = d.decode_bin(ctx, MB_TYPE_I + 5) ? 2 : 1;
        int mode = d.decode_bin(ctx, MB_TYPE_I + 6) << 1;
        mode |= d.decode_bin(ctx, MB_TYPE_I + 7);
        mode16[mb] = mode;
        cbp_map[mb] = cbp_luma | (cbp_chroma << 4);
        int cm_inc = ((c > 0 && cm_map[mb - 1]) ? 1 : 0)
                     + ((r > 0 && cm_map[mb - C]) ? 1 : 0);
        int cm = dec_tu(d, ctx, 3, [&](int k) {
          return CHROMA_PRED + (k == 0 ? cm_inc : 3);
        });
        chroma_mode[mb] = cm;
        cm_map[mb] = cm;
        if (d.decode_bin(ctx, MB_QP_DELTA)) return -2;  // per-MB QP
        int cbf = dec_block(d, ctx, 0, inc_dc(r, c),
                            dc + (size_t)mb * 16, &err);
        if (err) return -1;
        dcgrid[mb] = (int8_t)cbf;
        for (int zi = 0; zi < 16; zi++) {
          int b = kZscanToRaster[zi];
          int by = r * 4 + b / 4, bx = c * 4 + b % 4;
          if (cbp_luma) {
            int32_t tmp[16];
            int cf = dec_block(d, ctx, 1, inc_luma(by, bx), tmp, &err);
            if (err) return -1;
            for (int t = 0; t < 15; t++)
              ac[((size_t)mb * 16 + b) * 15 + t] = tmp[t];
            lgrid[by * C * 4 + bx] = (int8_t)cf;
          } else {
            lgrid[by * C * 4 + bx] = 0;
          }
        }
      }
      // ---- chroma residual (shared I_4x4 / I_16x16) ----
      int32_t* dcp = cdc + (size_t)mb * 8;
      int32_t* acp = cac + (size_t)mb * 120;
      if (cbp_chroma == 0) {
        for (int comp = 0; comp < 2; comp++) {
          cdcgrid[(size_t)comp * R * C + mb] = 0;
          for (int b = 0; b < 4; b++)
            cgrid[(comp * R * 2 + r * 2 + b / 2) * C * 2 + c * 2 + b % 2] = 0;
        }
      } else {
        for (int comp = 0; comp < 2; comp++) {
          int cbf = dec_block(d, ctx, 3, inc_cdc(comp, r, c), dcp + comp * 4,
                              &err);
          if (err) return -1;
          cdcgrid[(size_t)comp * R * C + mb] = (int8_t)cbf;
        }
        if (cbp_chroma == 2) {
          for (int comp = 0; comp < 2; comp++) {
            for (int b = 0; b < 4; b++) {
              int by = r * 2 + b / 2, bx = c * 2 + b % 2;
              int cbf = dec_block(d, ctx, 4, inc_chroma(comp, by, bx),
                                  acp + (comp * 4 + b) * 15, &err);
              if (err) return -1;
              cgrid[(comp * R * 2 + by) * C * 2 + bx] = (int8_t)cbf;
            }
          }
        } else {
          for (int comp = 0; comp < 2; comp++)
            for (int b = 0; b < 4; b++)
              cgrid[(comp * R * 2 + r * 2 + b / 2) * C * 2 + c * 2 + b % 2] = 0;
        }
      }
      if (d.decode_terminate()) return mb + 1;
    }
  }
  return n_mb;
}

}  // extern "C"
