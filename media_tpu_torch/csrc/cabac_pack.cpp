// CABAC slice-data packer (C++): byte-exact mirror of the Python coder in
// media_tpu_torch/entropy/cabac_slice.py (which mirrors Rec. ITU-T H.264 9.3).
// The slice writers are a copy of the JAX package's csrc/cabac_pack.cpp;
// the engine under them (Enc) writes a byte at a time where that one writes
// a bit at a time, and the bytes are the same.
//
// The Python implementation is the tested oracle; tests force this packer
// byte-identical. Context-init (m, n) tables are passed in from Python so
// entropy/cabac_init_tables.py stays the single source of truth; the engine
// tables (spec Tables 9-44/9-45) come from cavlc_tables.inc, generated from
// the validated Python engine.
//
// Reference operating point: the adaptation layer's software path enables
// CABAC (video_codec/VideoEncoderOpenH264.cpp:291).

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
constexpr int MVD_X = 40;
constexpr int MVD_Y = 47;
constexpr int MB_QP_DELTA = 60;
constexpr int CHROMA_PRED = 64;
constexpr int CBP_LUMA = 73;
constexpr int CBP_CHROMA = 77;
constexpr int CBF = 85;
constexpr int SIG = 105;
constexpr int LAST = 166;
constexpr int ABS_LVL = 227;

const int CAT_OFFSET_SIG[5] = {0, 15, 29, 44, 47};
const int CAT_OFFSET_ABS[5] = {0, 10, 20, 30, 39};
const int CAT_MAXCOEFF[5] = {16, 15, 16, 4, 15};

// Next packed state (pStateIdx << 1 | valMPS) after coding `bin` in packed
// state s (Table 9-45; the MPS path saturates at 62, the LPS path swaps
// valMPS from state 0). Built once from kTransIdxLPS.
struct Trans {
  uint8_t next[128][2];
  Trans() {
    for (int s = 0; s < 128; s++) {
      int st = s >> 1, mps = s & 1;
      int up = st < 62 ? st + 1 : 62;
      int down = kTransIdxLPS[st];
      int lps_mps = st == 0 ? 1 - mps : mps;
      next[s][mps] = (uint8_t)(up << 1 | mps);
      next[s][1 - mps] = (uint8_t)(down << 1 | lps_mps);
    }
  }
};
const Trans kTrans;

struct Ctx {
  uint8_t st[NUM_CTX];  // pStateIdx << 1 | valMPS
  void init(int qp, const int32_t* init_mn) {
    if (qp < 0) qp = 0;
    if (qp > 51) qp = 51;
    for (int i = 0; i < NUM_CTX; i++) {
      int m = init_mn[2 * i], n = init_mn[2 * i + 1];
      int pre = ((m * qp) >> 4) + n;
      if (pre < 1) pre = 1;
      if (pre > 126) pre = 126;
      st[i] = (uint8_t)(pre > 63 ? (pre - 64) << 1 | 1 : (63 - pre) << 1);
    }
  }
};

// The encoding engine of 9.3.4, a byte at a time. `low` keeps the 10-bit
// window of the spec's codILow in its bits 0-9 and, above them, the bits
// already shifted out of it and not yet written: queue + 8 of them, under
// one carry bit. A byte goes out when 8 have gathered. A byte of 0xFF is
// held back (`outstanding`) until the next byte shows whether a carry runs
// through it; a carry adds 1 to the byte written before and turns the held
// bytes into 0x00. This writes the bits of the spec's PutBit with its
// bitsOutstanding. The queue starts at -9, so the first bit shifted out,
// which the spec drops, sits where the first byte's carry goes: in out[0],
// a slack byte. The payload is written from out[1] and moved down by one at
// the end, so a carry never lands before `out`.
struct Enc {
  uint32_t low = 0;
  uint32_t range = 510;
  int queue = -9;
  int64_t outstanding = 0;
  uint8_t* base;
  uint8_t* p;
  uint8_t* end;
  bool overflow = false;

  Enc(uint8_t* out, int64_t cap) : base(out), p(out + 1), end(out + cap) {
    if (cap < 2)
      overflow = true;
    else
      out[0] = 0;
  }

  inline void put_byte() {
    if (queue < 0) return;
    uint32_t byte = low >> (queue + 10);
    low &= (0x400u << queue) - 1;
    queue -= 8;
    if ((byte & 0xFF) == 0xFF) {
      outstanding++;
      return;
    }
    if (end - p <= outstanding) {  // no room: the result is -1
      overflow = true;
      outstanding = 0;
      return;
    }
    uint32_t carry = byte >> 8;
    p[-1] += (uint8_t)carry;
    uint8_t held = (uint8_t)(carry - 1);  // 0xFF, or 0x00 after a carry
    for (; outstanding > 0; outstanding--) *p++ = held;
    *p++ = (uint8_t)byte;
  }
  inline void shift(int n) {
    range <<= n;
    low <<= n;
    queue += n;
    put_byte();
  }
  inline void renorm() { shift(__builtin_clz(range) - 23); }

  inline void encode_bin(Ctx& c, int idx, int bin) {
    uint32_t s = c.st[idx];
    uint32_t r_lps = kRangeTabLPS[s >> 1][(range >> 6) & 3];
    uint32_t lps = (uint32_t)bin ^ (s & 1);
    range -= r_lps;
    low += range & (0u - lps);
    range = lps ? r_lps : range;
    c.st[idx] = kTrans.next[s][bin];
    renorm();
  }
  inline void encode_bypass(int bin) {
    low = (low << 1) + (range & (0u - (uint32_t)bin));
    queue += 1;
    put_byte();
  }
  // bin 1 ends the slice (9.3.4.5): the spec's final PutBit of codILow's
  // bit 9, then its bit 8, then a 1 that is the RBSP stop bit, padded with
  // zeros to the byte; the held 0xFF bytes are written last.
  void encode_terminate(int bin) {
    range -= 2;
    if (!bin) {
      renorm();
      return;
    }
    low += range;
    range = 2;
    shift(7);
    low = (low & ~0x7Fu) | 0x80;  // bits 9, 8 kept; bit 7 the stop bit
    shift(3);
    if (queue > -8) shift(-queue);  // the last byte, zero-padded
    if (end - p < outstanding) {
      overflow = true;
    } else {
      for (; outstanding > 0; outstanding--) *p++ = 0xFF;
    }
  }
  // Moves the payload to out[0] and returns its length, or -1 when it and
  // the slack byte did not fit in cap.
  int64_t get_bytes() {
    if (overflow) return -1;
    int64_t n = p - (base + 1);
    std::memmove(base, base + 1, (size_t)n);
    return n;
  }
};

// Truncated unary with per-bin ctx function. CtxOf: int(int k).
template <typename CtxOf>
void enc_tu(Enc& e, Ctx& c, int val, int cmax, CtxOf ctx_of) {
  for (int k = 0; k < val; k++) e.encode_bin(c, ctx_of(k), 1);
  if (val < cmax) e.encode_bin(c, ctx_of(val), 0);
}

void enc_eg_bypass(Enc& e, int val, int k) {
  while (val >= (1 << k)) {
    e.encode_bypass(1);
    val -= 1 << k;
    k++;
  }
  e.encode_bypass(0);
  for (int i = k - 1; i >= 0; i--) e.encode_bypass((val >> i) & 1);
}

void enc_mvd(Enc& e, Ctx& c, int mvd, int base, int esum) {
  int a = mvd < 0 ? -mvd : mvd;
  int inc0 = esum < 3 ? 0 : (esum <= 32 ? 1 : 2);
  auto ctx_of = [&](int k) {
    return base + (k == 0 ? inc0 : (k + 2 < 6 ? k + 2 : 6));
  };
  enc_tu(e, c, a < 9 ? a : 9, 9, ctx_of);
  if (a >= 9) enc_eg_bypass(e, a - 9, 3);
  if (a) e.encode_bypass(mvd < 0 ? 1 : 0);
}

// One residual block (cat, zig-zag levels, length CAT_MAXCOEFF[cat]).
// Returns cbf.
int enc_block(Enc& e, Ctx& c, int cat, const int32_t* levels, int cbf_inc) {
  int mc = CAT_MAXCOEFF[cat];
  int nz[16], nnz = 0;
  for (int i = 0; i < mc; i++)
    if (levels[i]) nz[nnz++] = i;
  int cbf = nnz ? 1 : 0;
  e.encode_bin(c, CBF + 4 * cat + cbf_inc, cbf);
  if (!cbf) return 0;
  int last = nz[nnz - 1];
  int off = CAT_OFFSET_SIG[cat];
  for (int i = 0; i < mc - 1; i++) {
    int sig = levels[i] ? 1 : 0;
    e.encode_bin(c, SIG + off + i, sig);
    if (sig) {
      e.encode_bin(c, LAST + off + i, i == last ? 1 : 0);
      if (i == last) break;
    }
  }
  int num_eq1 = 0, num_gt1 = 0;
  int aoff = ABS_LVL + CAT_OFFSET_ABS[cat];
  for (int j = nnz - 1; j >= 0; j--) {
    int i = nz[j];
    int lv = levels[i];
    int a = (lv < 0 ? -lv : lv) - 1;
    int inc0 = num_gt1 ? 0 : (1 + num_eq1 < 4 ? 1 + num_eq1 : 4);
    int cap = cat == 3 ? 3 : 4;  // chroma DC caps at 3 (9.3.3.1.3)
    int incN = 5 + (num_gt1 < cap ? num_gt1 : cap);
    auto ctx_of = [&](int k) { return aoff + (k == 0 ? inc0 : incN); };
    enc_tu(e, c, a < 14 ? a : 14, 14, ctx_of);
    if (a >= 14) enc_eg_bypass(e, a - 14, 0);
    e.encode_bypass(lv < 0 ? 1 : 0);
    if (a == 0)
      num_eq1++;
    else
      num_gt1++;
  }
  return 1;
}

struct CbfState {
  std::vector<int8_t> luma;       // (4R, 4C)
  std::vector<int8_t> chroma;     // (2, 2R, 2C)
  std::vector<int8_t> luma_dc;    // (R, C)
  std::vector<int8_t> chroma_dc;  // (2, R, C)
  int R, C;
  CbfState(int R_, int C_) : R(R_), C(C_) {
    luma.assign((size_t)R * C * 16, 0);
    chroma.assign((size_t)2 * R * C * 4, 0);
    luma_dc.assign((size_t)R * C, 0);
    chroma_dc.assign((size_t)2 * R * C, 0);
  }
  int8_t& L(int by, int bx) { return luma[(size_t)by * 4 * C + bx]; }
  int8_t& Ch(int comp, int by, int bx) {
    return chroma[((size_t)comp * 2 * R + by) * 2 * C + bx];
  }
  int8_t& Ldc(int r, int c) { return luma_dc[(size_t)r * C + c]; }
  int8_t& Cdc(int comp, int r, int c) {
    return chroma_dc[((size_t)comp * R + r) * C + c];
  }
  // Current MB's prediction class: unavailable neighbors contribute
  // condTermFlag = 1 for intra MBs, 0 for inter (spec 9.3.3.1.1.9).
  int intra = 0;
  int edge() const { return intra ? 1 : 0; }
  int inc_luma(int by, int bx) {
    int a = bx > 0 ? L(by, bx - 1) : edge();
    int b = by > 0 ? L(by - 1, bx) : edge();
    return a + 2 * b;
  }
  int inc_chroma(int comp, int by, int bx) {
    int a = bx > 0 ? Ch(comp, by, bx - 1) : edge();
    int b = by > 0 ? Ch(comp, by - 1, bx) : edge();
    return a + 2 * b;
  }
  int inc_luma_dc(int r, int c) {
    int a = c > 0 ? Ldc(r, c - 1) : edge();
    int b = r > 0 ? Ldc(r - 1, c) : edge();
    return a + 2 * b;
  }
  int inc_chroma_dc(int comp, int r, int c) {
    int a = c > 0 ? Cdc(comp, r, c - 1) : edge();
    int b = r > 0 ? Cdc(comp, r - 1, c) : edge();
    return a + 2 * b;
  }
};

void enc_cbp(Enc& e, Ctx& c, int cbp_luma, int cbp_chroma, int cbp_l_a,
             int cbp_l_b, int cbp_c_a, int cbp_c_b) {
  // cbp_*_a/b: -1 encodes "unavailable" (Python None).
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
    e.encode_bin(c, CBP_LUMA + inc, (cbp_luma >> g8) & 1);
  }
  int a = cbp_c_a >= 0 ? cbp_c_a : 0;
  int b = cbp_c_b >= 0 ? cbp_c_b : 0;
  int inc0 = (a ? 1 : 0) + 2 * (b ? 1 : 0);
  e.encode_bin(c, CBP_CHROMA + inc0, cbp_chroma ? 1 : 0);
  if (cbp_chroma) {
    int inc1 = (a == 2 ? 1 : 0) + 2 * (b == 2 ? 1 : 0);
    e.encode_bin(c, CBP_CHROMA + 4 + inc1, cbp_chroma == 2 ? 1 : 0);
  }
}

void chroma_blocks(Enc& e, Ctx& c, CbfState& st, int r, int cc_, int cbp_chroma,
                   const int32_t* cdc_rc, const int32_t* cac_rc) {
  if (cbp_chroma == 0) {
    for (int comp = 0; comp < 2; comp++) {
      st.Cdc(comp, r, cc_) = 0;
      for (int dy = 0; dy < 2; dy++)
        for (int dx = 0; dx < 2; dx++)
          st.Ch(comp, r * 2 + dy, cc_ * 2 + dx) = 0;
    }
    return;
  }
  for (int comp = 0; comp < 2; comp++) {
    int inc = st.inc_chroma_dc(comp, r, cc_);
    int cbf = enc_block(e, c, 3, cdc_rc + comp * 4, inc);
    st.Cdc(comp, r, cc_) = (int8_t)cbf;
  }
  if (cbp_chroma == 2) {
    for (int comp = 0; comp < 2; comp++) {
      for (int blk = 0; blk < 4; blk++) {
        int by = r * 2 + blk / 2, bx = cc_ * 2 + blk % 2;
        int inc = st.inc_chroma(comp, by, bx);
        int cbf = enc_block(e, c, 4, cac_rc + (comp * 4 + blk) * 15, inc);
        st.Ch(comp, by, bx) = (int8_t)cbf;
      }
    }
  } else {
    for (int comp = 0; comp < 2; comp++)
      for (int dy = 0; dy < 2; dy++)
        for (int dx = 0; dx < 2; dx++)
          st.Ch(comp, r * 2 + dy, cc_ * 2 + dx) = 0;
  }
}

inline int median3(int a, int b, int c) {
  int mn = a < b ? a : b, mx = a < b ? b : a;
  int m2 = mx < c ? mx : c;
  return mn > m2 ? mn : m2;
}

// Median MV predictor + skip rule (media_tpu_torch/pipeline/mv_pred.py). mv is the
// (R, C, 2) array of already-final MVs; raster order guarantees neighbors
// left/top/top-right are final when MB (r, c) is coded.
void predict_mv(const int32_t* mv, int R, int C, int r, int c, int* px,
                int* py) {
  const int32_t* a = c > 0 ? mv + ((size_t)r * C + c - 1) * 2 : nullptr;
  const int32_t* b = r > 0 ? mv + ((size_t)(r - 1) * C + c) * 2 : nullptr;
  const int32_t* cc_ = nullptr;
  bool c_avail = false;
  if (r > 0 && c + 1 < C) {
    cc_ = mv + ((size_t)(r - 1) * C + c + 1) * 2;
    c_avail = true;
  } else if (r > 0 && c > 0) {
    cc_ = mv + ((size_t)(r - 1) * C + c - 1) * 2;
    c_avail = true;
  }
  bool a_avail = c > 0, b_avail = r > 0;
  if (a_avail && !b_avail && !c_avail) {
    *px = a[0];
    *py = a[1];
    return;
  }
  int ax = a ? a[0] : 0, ay = a ? a[1] : 0;
  int bx = b ? b[0] : 0, by = b ? b[1] : 0;
  int cx = cc_ ? cc_[0] : 0, cy = cc_ ? cc_[1] : 0;
  // 8.4.1.3.2 rule 2: exactly one available neighbor -> its MV alone
  // (only differs from the median for C == 1, r > 0: selects mvB).
  int n_av = (a_avail ? 1 : 0) + (b_avail ? 1 : 0) + (c_avail ? 1 : 0);
  if (n_av == 1) {
    if (a_avail) { *px = ax; *py = ay; }
    else if (b_avail) { *px = bx; *py = by; }
    else { *px = cx; *py = cy; }
    return;
  }
  *px = median3(ax, bx, cx);
  *py = median3(ay, by, cy);
}

void skip_mv(const int32_t* mv, int R, int C, int r, int c, int* px, int* py) {
  if (r == 0 || c == 0) {
    *px = 0;
    *py = 0;
    return;
  }
  const int32_t* a = mv + ((size_t)r * C + c - 1) * 2;
  const int32_t* b = mv + ((size_t)(r - 1) * C + c) * 2;
  if ((a[0] == 0 && a[1] == 0) || (b[0] == 0 && b[1] == 0)) {
    *px = 0;
    *py = 0;
    return;
  }
  predict_mv(mv, R, C, r, c, px, py);
}

}  // namespace

// mb_qp_delta (spec 9.3.2.7): signed map to k, U binarization; ctxIdxInc
// bin0 = (prev mb_qp_delta != 0), bin1 -> +2, bins >= 2 -> +3.
static void enc_qp_delta(Enc& e, Ctx& ctx, int delta, int prev_delta) {
  int k = delta > 0 ? 2 * delta - 1 : -2 * delta;
  int ctx0 = MB_QP_DELTA + (prev_delta ? 1 : 0);
  if (k == 0) {
    e.encode_bin(ctx, ctx0, 0);
    return;
  }
  e.encode_bin(ctx, ctx0, 1);
  for (int i = 1; i < k; i++)
    e.encode_bin(ctx, MB_QP_DELTA + (i == 1 ? 2 : 3), 1);
  e.encode_bin(ctx, MB_QP_DELTA + (k == 1 ? 2 : 3), 0);
}

extern "C" int64_t mtpu_cabac_write_slice_p(
    const int32_t* mv, const int32_t* luma, const int32_t* cdc,
    const int32_t* cac, int R, int C, int qp, const int32_t* init_mn,
    const int32_t* qp_map, uint8_t* out, int64_t cap) {
  Ctx ctx;
  ctx.init(qp, init_mn);
  Enc e(out, cap);
  CbfState st(R, C);
  std::vector<int8_t> skip_map((size_t)R * C, 0);
  std::vector<int32_t> cbp_map((size_t)R * C, -1);
  std::vector<int32_t> mvd((size_t)R * C * 2, 0);
  int cur_qp = qp, prev_delta = 0;

  for (int r = 0; r < R; r++) {
    for (int c = 0; c < C; c++) {
      size_t mb = (size_t)r * C + c;
      const int32_t* mv_rc = mv + mb * 2;
      const int32_t* luma_rc = luma + mb * 256;   // 16 blocks x 16
      const int32_t* cdc_rc = cdc + mb * 8;       // 2 x 4
      const int32_t* cac_rc = cac + mb * 120;     // 2 x 4 x 15
      int cbp_luma = 0;
      for (int g8 = 0; g8 < 4; g8++) {
        bool any = false;
        for (int k = 0; k < 4 && !any; k++) {
          int b = kZscanToRaster[g8 * 4 + k];
          for (int i = 0; i < 16; i++)
            if (luma_rc[b * 16 + i]) {
              any = true;
              break;
            }
        }
        if (any) cbp_luma |= 1 << g8;
      }
      bool cac_any = false, cdc_any = false;
      for (int i = 0; i < 120 && !cac_any; i++)
        if (cac_rc[i]) cac_any = true;
      for (int i = 0; i < 8 && !cdc_any; i++)
        if (cdc_rc[i]) cdc_any = true;
      int cbp_chroma = cac_any ? 2 : (cdc_any ? 1 : 0);
      int cbp = cbp_luma | (cbp_chroma << 4);

      int sx, sy;
      skip_mv(mv, R, C, r, c, &sx, &sy);
      bool can_skip = cbp == 0 && mv_rc[0] == sx && mv_rc[1] == sy;
      int inc = ((c > 0 && !skip_map[mb - 1]) ? 1 : 0) +
                ((r > 0 && !skip_map[mb - C]) ? 1 : 0);
      e.encode_bin(ctx, MB_SKIP_P + inc, can_skip ? 1 : 0);
      skip_map[mb] = can_skip ? 1 : 0;
      bool last_mb = r == R - 1 && c == C - 1;
      if (can_skip) {
        mvd[mb * 2] = mvd[mb * 2 + 1] = 0;
        for (int by = r * 4; by < r * 4 + 4; by++)
          for (int bx = c * 4; bx < c * 4 + 4; bx++) st.L(by, bx) = 0;
        for (int comp = 0; comp < 2; comp++) {
          st.Cdc(comp, r, c) = 0;
          for (int dy = 0; dy < 2; dy++)
            for (int dx = 0; dx < 2; dx++)
              st.Ch(comp, r * 2 + dy, c * 2 + dx) = 0;
        }
        cbp_map[mb] = 0;
        prev_delta = 0;  // skip MBs carry an inferred delta of 0
        e.encode_terminate(last_mb ? 1 : 0);
        continue;
      }
      e.encode_bin(ctx, MB_TYPE_P, 0);
      e.encode_bin(ctx, MB_TYPE_P + 1, 0);
      e.encode_bin(ctx, MB_TYPE_P + 2, 0);
      int px, py;
      predict_mv(mv, R, C, r, c, &px, &py);
      int mvdx = mv_rc[0] - px, mvdy = mv_rc[1] - py;
      int eax = 0, eay = 0;
      if (c > 0) {
        eax += mvd[(mb - 1) * 2] < 0 ? -mvd[(mb - 1) * 2] : mvd[(mb - 1) * 2];
        eay += mvd[(mb - 1) * 2 + 1] < 0 ? -mvd[(mb - 1) * 2 + 1]
                                         : mvd[(mb - 1) * 2 + 1];
      }
      if (r > 0) {
        eax += mvd[(mb - C) * 2] < 0 ? -mvd[(mb - C) * 2] : mvd[(mb - C) * 2];
        eay += mvd[(mb - C) * 2 + 1] < 0 ? -mvd[(mb - C) * 2 + 1]
                                         : mvd[(mb - C) * 2 + 1];
      }
      enc_mvd(e, ctx, mvdx, MVD_X, eax);
      enc_mvd(e, ctx, mvdy, MVD_Y, eay);
      mvd[mb * 2] = mvdx;
      mvd[mb * 2 + 1] = mvdy;
      int cbp_l_a = c > 0 ? (cbp_map[mb - 1] >= 0 ? cbp_map[mb - 1] & 15 : 0)
                          : -1;
      int cbp_l_b = r > 0 ? (cbp_map[mb - C] >= 0 ? cbp_map[mb - C] & 15 : 0)
                          : -1;
      int cbp_c_a = c > 0 ? (cbp_map[mb - 1] >= 0 ? cbp_map[mb - 1] >> 4 : 0)
                          : -1;
      int cbp_c_b = r > 0 ? (cbp_map[mb - C] >= 0 ? cbp_map[mb - C] >> 4 : 0)
                          : -1;
      enc_cbp(e, ctx, cbp_luma, cbp_chroma, cbp_l_a, cbp_l_b, cbp_c_a,
              cbp_c_b);
      cbp_map[mb] = cbp;
      if (cbp) {
        if (qp_map == nullptr) {
          enc_qp_delta(e, ctx, 0, prev_delta);
          prev_delta = 0;
        } else {
          int want = qp_map[mb];
          int delta = want - cur_qp;
          if (delta > 25) delta -= 52;       // mod-52 wrap (spec 7.4.5)
          else if (delta < -26) delta += 52;
          enc_qp_delta(e, ctx, delta, prev_delta);
          prev_delta = delta;
          cur_qp = want;
        }
      } else {
        prev_delta = 0;
      }
      for (int g8 = 0; g8 < 4; g8++) {
        if (!((cbp_luma >> g8) & 1)) {
          for (int k = 0; k < 4; k++) {
            int b = kZscanToRaster[g8 * 4 + k];
            st.L(r * 4 + b / 4, c * 4 + b % 4) = 0;
          }
          continue;
        }
        for (int k = 0; k < 4; k++) {
          int b = kZscanToRaster[g8 * 4 + k];
          int by = r * 4 + b / 4, bx = c * 4 + b % 4;
          int cbf = enc_block(e, ctx, 2, luma_rc + b * 16, st.inc_luma(by, bx));
          st.L(by, bx) = (int8_t)cbf;
        }
      }
      chroma_blocks(e, ctx, st, r, c, cbp_chroma, cdc_rc, cac_rc);
      e.encode_terminate(last_mb ? 1 : 0);
    }
  }
  return e.get_bytes();
}

// mtpu_cabac_engine_bins: the engine alone, for tests. Codes n bins, each
// a regular bin of context ctx_idx[i] (kinds[i] 0), a bypass bin (1) or a
// terminate bin of value 0 (2), with the contexts set from init_mn at qp,
// then the terminate bin of value 1 that ends a slice. Returns the bytes
// written to out, -1 when cap is too small, -2 for a bad kind or context.
extern "C" int64_t mtpu_cabac_engine_bins(const int32_t* ctx_idx,
                                          const int32_t* bins,
                                          const int32_t* kinds, int64_t n,
                                          int qp, const int32_t* init_mn,
                                          uint8_t* out, int64_t cap) {
  Ctx ctx;
  ctx.init(qp, init_mn);
  Enc e(out, cap);
  for (int64_t i = 0; i < n; i++) {
    int bin = bins[i] ? 1 : 0;
    if (kinds[i] == 0 && ctx_idx[i] >= 0 && ctx_idx[i] < NUM_CTX)
      e.encode_bin(ctx, ctx_idx[i], bin);
    else if (kinds[i] == 1)
      e.encode_bypass(bin);
    else if (kinds[i] == 2 && !bin)
      e.encode_terminate(0);
    else
      return -2;
  }
  e.encode_terminate(1);
  return e.get_bytes();
}

constexpr int I4_PRED_FLAG = 68;
constexpr int I4_PRED_REM = 69;

// mtpu_cabac_write_slice_i: I slice with mixed I_16x16 / I_4x4 MBs.
// is_i4 may be null (all I_16x16); modes4 (R*C*16, z-scan), luma4
// (R*C*16*16, zig-zag per raster block) required when is_i4 is set.
extern "C" int64_t mtpu_cabac_write_slice_i(
    const int32_t* mode16, const int32_t* cmode, const int32_t* dc,
    const int32_t* ac, const int32_t* cdc, const int32_t* cac,
    const int32_t* is_i4, const int32_t* modes4, const int32_t* luma4,
    int R, int C, int qp, const int32_t* init_mn, uint8_t* out, int64_t cap) {
  Ctx ctx;
  ctx.init(qp, init_mn);
  Enc e(out, cap);
  CbfState st(R, C);
  st.intra = 1;  // I slice: edge condTermFlag = 1 (9.3.3.1.1.9)
  std::vector<int32_t> cm_map((size_t)R * C, 0);
  std::vector<int8_t> i4_map((size_t)R * C, 0);
  std::vector<int32_t> cbp_map((size_t)R * C, 0);
  std::vector<int8_t> mode_grid((size_t)R * 4 * C * 4, -1);
  auto mg = [&](int gy, int gx) -> int8_t& {
    return mode_grid[(size_t)gy * 4 * C + gx];
  };

  for (int r = 0; r < R; r++) {
    for (int c = 0; c < C; c++) {
      size_t mb = (size_t)r * C + c;
      const int32_t* dc_rc = dc + mb * 16;
      const int32_t* ac_rc = ac + mb * 16 * 15;
      const int32_t* cdc_rc = cdc + mb * 8;
      const int32_t* cac_rc = cac + mb * 120;
      bool cac_any = false, cdc_any = false;
      for (int i = 0; i < 120 && !cac_any; i++)
        if (cac_rc[i]) cac_any = true;
      for (int i = 0; i < 8 && !cdc_any; i++)
        if (cdc_rc[i]) cdc_any = true;
      int cbp_chroma = cac_any ? 2 : (cdc_any ? 1 : 0);
      bool last_mb = r == R - 1 && c == C - 1;

      // condTermFlagN = available && !I_NxN
      int avail_inc = ((c > 0 && !i4_map[mb - 1]) ? 1 : 0) +
                      ((r > 0 && !i4_map[mb - C]) ? 1 : 0);
      bool mb_i4 = is_i4 && is_i4[mb];
      if (mb_i4) {
        i4_map[mb] = 1;
        e.encode_bin(ctx, MB_TYPE_I + avail_inc, 0);  // I_NxN
        const int32_t* m4 = modes4 + mb * 16;
        const int32_t* lv4 = luma4 + mb * 256;
        for (int zi = 0; zi < 16; zi++) {
          int bi = kZscanToRaster[zi];
          int gy = r * 4 + bi / 4, gx = c * 4 + bi % 4;
          int pred;
          if (gx <= 0 || gy <= 0) {
            pred = 2;  // dcPredModePredictedFlag (8.3.1.1)
          } else {
            int a = mg(gy, gx - 1);
            int b = mg(gy - 1, gx);
            if (a < 0) a = 2;
            if (b < 0) b = 2;
            pred = a < b ? a : b;
          }
          int m = m4[zi];
          if (m == pred) {
            e.encode_bin(ctx, I4_PRED_FLAG, 1);
          } else {
            e.encode_bin(ctx, I4_PRED_FLAG, 0);
            int rem = m > pred ? m - 1 : m;
            for (int k = 0; k < 3; k++)
              e.encode_bin(ctx, I4_PRED_REM, (rem >> k) & 1);
          }
          mg(gy, gx) = (int8_t)m;
        }
        int cm = cmode[mb];
        int inc = ((c > 0 && cm_map[mb - 1]) ? 1 : 0) +
                  ((r > 0 && cm_map[mb - C]) ? 1 : 0);
        auto cm_ctx = [&](int k) { return CHROMA_PRED + (k == 0 ? inc : 3); };
        enc_tu(e, ctx, cm, 3, cm_ctx);
        cm_map[mb] = cm;
        int cbp_luma = 0;
        for (int g8 = 0; g8 < 4; g8++) {
          bool any = false;
          for (int k = 0; k < 4 && !any; k++) {
            int b = kZscanToRaster[g8 * 4 + k];
            for (int i = 0; i < 16; i++)
              if (lv4[b * 16 + i]) {
                any = true;
                break;
              }
          }
          if (any) cbp_luma |= 1 << g8;
        }
        int cbp_l_a = c > 0 ? cbp_map[mb - 1] & 15 : -1;
        int cbp_l_b = r > 0 ? cbp_map[mb - C] & 15 : -1;
        int cbp_c_a = c > 0 ? cbp_map[mb - 1] >> 4 : -1;
        int cbp_c_b = r > 0 ? cbp_map[mb - C] >> 4 : -1;
        enc_cbp(e, ctx, cbp_luma, cbp_chroma, cbp_l_a, cbp_l_b, cbp_c_a,
                cbp_c_b);
        cbp_map[mb] = cbp_luma | (cbp_chroma << 4);
        if (cbp_luma || cbp_chroma) e.encode_bin(ctx, MB_QP_DELTA, 0);
        st.Ldc(r, c) = 0;
        for (int g8 = 0; g8 < 4; g8++) {
          if (!((cbp_luma >> g8) & 1)) {
            for (int k = 0; k < 4; k++) {
              int b = kZscanToRaster[g8 * 4 + k];
              st.L(r * 4 + b / 4, c * 4 + b % 4) = 0;
            }
            continue;
          }
          for (int k = 0; k < 4; k++) {
            int b = kZscanToRaster[g8 * 4 + k];
            int by = r * 4 + b / 4, bx = c * 4 + b % 4;
            int cbf =
                enc_block(e, ctx, 2, lv4 + b * 16, st.inc_luma(by, bx));
            st.L(by, bx) = (int8_t)cbf;
          }
        }
        chroma_blocks(e, ctx, st, r, c, cbp_chroma, cdc_rc, cac_rc);
        e.encode_terminate(last_mb ? 1 : 0);
        continue;
      }
      bool ac_any = false;
      for (int i = 0; i < 240 && !ac_any; i++)
        if (ac_rc[i]) ac_any = true;
      int cbp_luma = ac_any ? 15 : 0;
      int mode = mode16[mb];

      e.encode_bin(ctx, MB_TYPE_I + avail_inc, 1);
      e.encode_terminate(0);  // not I_PCM
      e.encode_bin(ctx, MB_TYPE_I + 3, cbp_luma ? 1 : 0);
      e.encode_bin(ctx, MB_TYPE_I + 4, cbp_chroma ? 1 : 0);
      if (cbp_chroma)
        e.encode_bin(ctx, MB_TYPE_I + 5, cbp_chroma == 2 ? 1 : 0);
      e.encode_bin(ctx, MB_TYPE_I + 6, (mode >> 1) & 1);
      e.encode_bin(ctx, MB_TYPE_I + 7, mode & 1);
      cbp_map[mb] = cbp_luma | (cbp_chroma << 4);

      int cm = cmode[mb];
      int inc = ((c > 0 && cm_map[mb - 1]) ? 1 : 0) +
                ((r > 0 && cm_map[mb - C]) ? 1 : 0);
      auto cm_ctx = [&](int k) { return CHROMA_PRED + (k == 0 ? inc : 3); };
      enc_tu(e, ctx, cm, 3, cm_ctx);
      cm_map[mb] = cm;
      e.encode_bin(ctx, MB_QP_DELTA, 0);
      int cbf = enc_block(e, ctx, 0, dc_rc, st.inc_luma_dc(r, c));
      st.Ldc(r, c) = (int8_t)cbf;
      for (int z = 0; z < 16; z++) {
        int b = kZscanToRaster[z];
        int by = r * 4 + b / 4, bx = c * 4 + b % 4;
        if (cbp_luma) {
          int cbf2 = enc_block(e, ctx, 1, ac_rc + b * 15, st.inc_luma(by, bx));
          st.L(by, bx) = (int8_t)cbf2;
        } else {
          st.L(by, bx) = 0;
        }
      }
      chroma_blocks(e, ctx, st, r, c, cbp_chroma, cdc_rc, cac_rc);
      e.encode_terminate(last_mb ? 1 : 0);
    }
  }
  return e.get_bytes();
}
