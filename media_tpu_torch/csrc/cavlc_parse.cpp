// Native CAVLC P-slice PARSER: decode twin of
// media_tpu_torch/csrc/cavlc_pack.cpp and of the Python slice parser
// (pipeline/decoder_tpu.parse_pslice_symbols). A copy of the JAX package's
// csrc/cavlc_parse.cpp. Consumes slice_data bits (spec 7.3.4/7.3.5 baseline P
// syntax: mb_skip_run, P_L0_16x16, mvd, cbp, mb_qp_delta, 9.2 residuals)
// and produces the per-MB symbol arrays the device reconstruction consumes.
//
// Two roles:
//  - decode hot path: replaces the per-MB Python entropy parse;
//  - CAVLC->CABAC transcode: the CBR+CABAC session downloads the device
//    CAVLC pack (about the size of the bitstream) instead of the symbol
//    tensors, then this parser + the native CABAC packer re-emit the slice
//    as CABAC on the host, overlapped with the next chunk's device compute.
//
// Tables come from cavlc_tables.inc (generated from the validated Python
// tables); decode LUTs are built once, on first use.

#include <cstdint>
#include <cstring>

#include "cavlc_tables.inc"

// From cabac_pack.cpp (same shared library).
extern "C" int64_t mtpu_cabac_write_slice_p(
    const int32_t* mv, const int32_t* luma, const int32_t* cdc,
    const int32_t* cac, int R, int C, int qp, const int32_t* init_mn,
    const int32_t* qp_map, uint8_t* out, int64_t cap);

namespace {

struct BitReader {
  const uint8_t* data;
  int64_t nbits;   // total bits available
  int64_t pos;     // current bit position
  bool error = false;

  uint32_t peek(int n) {
    // Peek up to 24 bits (zero-padded past the end).
    int64_t total_bytes = (nbits + 7) >> 3;
    int64_t byte = pos >> 3;
    int shift = (int)(pos & 7);
    uint64_t acc = 0;
    for (int i = 0; i < 5; i++) {
      uint8_t b = (byte + i) < total_bytes ? data[byte + i] : 0;
      acc = (acc << 8) | b;
    }
    acc <<= shift;               // align current bit to bit 39 of 40
    return (uint32_t)((acc >> (40 - n)) & ((1u << n) - 1));
  }

  uint32_t u(int n) {
    if (pos + n > nbits) { error = true; return 0; }
    uint32_t v = peek(n);
    pos += n;
    return v;
  }

  uint32_t ue() {
    int zeros = 0;
    while (pos + zeros < nbits && peek_bit(zeros) == 0) zeros++;
    if (pos + 2 * zeros + 1 > nbits || zeros > 31) { error = true; return 0; }
    pos += zeros + 1;
    uint32_t suffix = zeros ? u(zeros) : 0;
    return ((1u << zeros) - 1) + suffix;
  }

  int32_t se() {
    uint32_t k = ue();
    return (k & 1) ? (int32_t)((k + 1) >> 1) : -(int32_t)(k >> 1);
  }

  int peek_bit(int off) {
    int64_t p = pos + off;
    return (data[p >> 3] >> (7 - (p & 7))) & 1;
  }
};

// ---- VLC decode LUTs (built once) ----

struct Vlc {
  // lut[peek] = (symbol << 5) | len ; 0 = invalid
  uint16_t* lut;
  int bits;
};

uint16_t* build_lut(int bits, const unsigned char* lens,
                    const unsigned char* codes, int n, int stride) {
  uint16_t* lut = new uint16_t[(size_t)1 << bits]();
  for (int i = 0; i < n; i++) {
    int len = lens[i * stride];
    int code = codes[i * stride];
    if (len == 0 || len > bits) continue;
    int base = code << (bits - len);
    int span = 1 << (bits - len);
    for (int s = 0; s < span; s++) lut[base + s] = (uint16_t)((i << 5) | len);
  }
  return lut;
}

// coeff_token: symbol index i encodes (t1, tc) as t1 * 17 + tc.
struct Tables {
  uint16_t* ct[3];      // 16-bit peek -> (t1*17+tc, len)
  uint16_t* ct_cdc;     // 8-bit peek
  uint16_t* tz[15];     // 9-bit peek per totalCoeff-1
  uint16_t* tz_cdc[3];  // 3-bit peek
  uint16_t* rb[7];      // 11-bit peek per min(zerosLeft,7)-1

  Tables() {
    for (int ctx = 0; ctx < 3; ctx++) {
      uint16_t* lut = new uint16_t[1 << 16]();
      for (int t1 = 0; t1 < 4; t1++)
        for (int tc = 0; tc < 17; tc++) {
          int len = kLenCT[ctx][t1][tc];
          int code = kCodCT[ctx][t1][tc];
          if (len == 0 && !(t1 == 0 && tc == 0)) continue;
          if (len == 0) continue;
          if (len > 16) continue;
          int base = code << (16 - len);
          int span = 1 << (16 - len);
          for (int s = 0; s < span; s++)
            lut[base + s] = (uint16_t)(((t1 * 17 + tc) << 5) | len);
        }
      ct[ctx] = lut;
    }
    {
      uint16_t* lut = new uint16_t[1 << 8]();
      for (int t1 = 0; t1 < 4; t1++)
        for (int tc = 0; tc < 5; tc++) {
          int len = kLenCTCdc[t1][tc];
          int code = kCodCTCdc[t1][tc];
          if (len == 0 || len > 8) continue;
          int base = code << (8 - len);
          for (int s = 0; s < (1 << (8 - len)); s++)
            lut[base + s] = (uint16_t)(((t1 * 17 + tc) << 5) | len);
        }
      ct_cdc = lut;
    }
    for (int tc = 0; tc < 15; tc++)
      tz[tc] = build_lut(9, &kLenTZ[tc][0], &kCodTZ[tc][0], 16, 1);
    for (int tc = 0; tc < 3; tc++)
      tz_cdc[tc] = build_lut(3, &kLenTZCdc[tc][0], &kCodTZCdc[tc][0], 4, 1);
    for (int zl = 0; zl < 7; zl++)
      rb[zl] = build_lut(11, &kLenRB[zl][0], &kCodRB[zl][0], 15, 1);
  }
};

const Tables& tables() {
  static Tables t;
  return t;
}

// decode coeff_token; returns false on error.
bool read_coeff_token(BitReader& br, int nC, int* t1, int* tc) {
  if (nC >= 8) {
    uint32_t v = br.u(6);
    if (br.error) return false;
    if (v == 3) { *t1 = 0; *tc = 0; return true; }
    *tc = (int)(v >> 2) + 1;
    *t1 = (int)(v & 3);
    return *t1 <= *tc;
  }
  const Tables& T = tables();
  if (nC == -1) {
    uint16_t e = T.ct_cdc[br.peek(8)];
    if (!e) return false;
    br.pos += e & 31;
    *t1 = (e >> 5) / 17;
    *tc = (e >> 5) % 17;
    return true;
  }
  int ctx = nC < 2 ? 0 : (nC < 4 ? 1 : 2);
  uint16_t e = T.ct[ctx][br.peek(16)];
  if (!e) return false;
  br.pos += e & 31;
  *t1 = (e >> 5) / 17;
  *tc = (e >> 5) % 17;
  return true;
}

int read_level_prefix(BitReader& br) {
  int zeros = 0;
  while (br.pos + zeros < br.nbits && br.peek_bit(zeros) == 0) zeros++;
  if (br.pos + zeros + 1 > br.nbits) { br.error = true; return -1; }
  br.pos += zeros + 1;
  return zeros;
}

// Mirror of entropy/cavlc.py decode_block: fills `coeffs[max_coeff]`
// (zig-zag order); returns TotalCoeff, or -1 on error.
int decode_block(BitReader& br, int nC, int max_coeff, int32_t* coeffs) {
  std::memset(coeffs, 0, sizeof(int32_t) * max_coeff);
  int t1 = 0, tc = 0;
  if (!read_coeff_token(br, nC, &t1, &tc)) return -1;
  if (tc == 0) return 0;
  if (tc > max_coeff) return -1;

  int32_t levels[16];
  int idx = 0;
  for (int k = 0; k < t1; k++) {
    levels[idx++] = br.u(1) ? -1 : 1;
  }
  int suffix_length = (tc > 10 && t1 < 3) ? 1 : 0;
  for (int k = t1; k < tc; k++) {
    int prefix = read_level_prefix(br);
    if (prefix < 0) return -1;
    int64_t level_code;
    int suffix_size = suffix_length;
    if (prefix == 14 && suffix_length == 0) suffix_size = 4;
    else if (prefix >= 15) suffix_size = prefix - 3;
    if (suffix_size > 24) return -1;  // beyond any 8-bit-video level
    int64_t suffix = suffix_size ? br.u(suffix_size) : 0;
    level_code = ((int64_t)(prefix < 15 ? prefix : 15) << suffix_length)
                 + suffix;
    if (prefix >= 15 && suffix_length == 0) level_code += 15;
    if (prefix >= 16) level_code += ((int64_t)1 << (prefix - 3)) - 4096;
    if (k == t1 && t1 < 3) level_code += 2;
    int64_t level = (level_code & 1) ? -((level_code + 1) >> 1)
                                     : ((level_code + 2) >> 1);
    levels[idx++] = (int32_t)level;
    if (suffix_length == 0) suffix_length = 1;
    int64_t a = level < 0 ? -level : level;
    if (a > (3LL << (suffix_length - 1)) && suffix_length < 6)
      suffix_length++;
  }

  int total_zeros = 0;
  if (tc < max_coeff) {
    const Tables& T = tables();
    uint16_t e;
    if (nC == -1)
      e = T.tz_cdc[tc - 1][br.peek(3)];
    else
      e = T.tz[tc - 1][br.peek(9)];
    if (!e) return -1;
    br.pos += e & 31;
    total_zeros = e >> 5;
  }

  // Place coefficients: highest frequency first (levels[0] is highest).
  int zeros_left = total_zeros;
  int posn = tc - 1 + total_zeros;  // index of highest-freq coeff
  const Tables& T = tables();
  for (int k = 0; k < tc; k++) {
    if (posn >= max_coeff || posn < 0) return -1;
    coeffs[posn] = levels[k];
    if (k == tc - 1) break;
    int run = 0;
    if (zeros_left > 0) {
      int zl = zeros_left < 7 ? zeros_left : 7;
      uint16_t e = T.rb[zl - 1][br.peek(11)];
      if (!e) return -1;
      br.pos += e & 31;
      run = e >> 5;
      if (run > zeros_left) return -1;
      zeros_left -= run;
    }
    posn -= 1 + run;
  }
  if (br.error) return -1;
  return tc;
}

inline int median3(int a, int b, int c) {
  int mx = a > b ? a : b;
  int mn = a < b ? a : b;
  return mx < c ? mx : (mn > c ? mn : c);
}

struct MvPred {
  // refIdx map: mv stored per MB; all MBs inter here (P_L0_16x16/P_Skip).
  const int32_t* mv;  // (R*C*2), filled progressively
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
    // 8.4.1.3.2 rule 2: exactly one available neighbor (all in-picture
    // neighbors are inter/refIdx-0 in this envelope) -> its MV alone. For
    // n_cols >= 2 this never fires beyond the A-only case above; for
    // single-MB-column pictures (n_cols == 1, r > 0) it selects mvB.
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

int nc_of(const int32_t* nnz, int stride, int by, int bx) {
  bool a = bx > 0, b = by > 0;
  if (a && b) return (nnz[by * stride + bx - 1] + nnz[(by - 1) * stride + bx] + 1) >> 1;
  if (a) return nnz[by * stride + bx - 1];
  if (b) return nnz[(by - 1) * stride + bx];
  return 0;
}

}  // namespace

extern "C" {

// Parse a P slice's slice_data (P_L0_16x16 / P_Skip envelope) starting at
// `bitpos` of `data` (`nbits` total). Outputs: mv (R*C*2), luma (R*C*16*16
// zig-zag per raster 4x4 block), cdc (R*C*2*4), cac (R*C*2*4*15), qp_map
// (R*C). Returns macroblocks parsed (== R*C on success) or <0 on error
// (-2 = unsupported mb_type: caller falls back to the Python parser).
int64_t mtpu_parse_slice_p(const uint8_t* data, int64_t nbits, int64_t bitpos,
                           int R, int C, int slice_qp,
                           int32_t* mv, int32_t* luma, int32_t* cdc,
                           int32_t* cac, int32_t* qp_map) {
  BitReader br{data, nbits, bitpos};
  int n_mb = R * C;
  std::memset(mv, 0, sizeof(int32_t) * n_mb * 2);
  std::memset(luma, 0, sizeof(int32_t) * n_mb * 256);
  std::memset(cdc, 0, sizeof(int32_t) * n_mb * 8);
  std::memset(cac, 0, sizeof(int32_t) * n_mb * 120);
  // nnz grids for nC
  int32_t* lnnz = new int32_t[(size_t)R * 4 * C * 4]();
  int32_t* cnnz = new int32_t[(size_t)2 * R * 2 * C * 2]();
  MvPred pred{mv, C};
  int cur_qp = slice_qp;
  int mb = 0;
  int64_t ret = -1;

  while (mb < n_mb) {
    uint32_t skip_run = br.ue();
    if (br.error) goto done;
    for (uint32_t s = 0; s < skip_run && mb < n_mb; s++, mb++) {
      int r = mb / C, c = mb % C;
      int sx, sy;
      pred.skip_mv(r, c, C, &sx, &sy);
      mv[mb * 2] = sx;
      mv[mb * 2 + 1] = sy;
      qp_map[mb] = cur_qp;
      for (int b = 0; b < 4; b++)
        for (int bb = 0; bb < 4; bb++)
          lnnz[(r * 4 + b) * C * 4 + c * 4 + bb] = 0;
      for (int comp = 0; comp < 2; comp++)
        for (int b = 0; b < 2; b++)
          for (int bb = 0; bb < 2; bb++)
            cnnz[(comp * R * 2 + r * 2 + b) * C * 2 + c * 2 + bb] = 0;
    }
    if (mb >= n_mb) break;
    {
      int r = mb / C, c = mb % C;
      uint32_t mb_type = br.ue();
      if (br.error) goto done;
      if (mb_type != 0) { ret = -2; goto done; }  // beyond P_L0_16x16
      int32_t mvdx = br.se();
      int32_t mvdy = br.se();
      int px, py;
      pred.predict(r, c, C, &px, &py);
      mv[mb * 2] = px + mvdx;
      mv[mb * 2 + 1] = py + mvdy;
      uint32_t cbp_code = br.ue();
      if (br.error || cbp_code >= 48) goto done;
      int cbp = kCbpFromCode[cbp_code][1];  // inter column
      int cbp_luma = cbp & 15, cbp_chroma = cbp >> 4;
      if (cbp) {
        int32_t d = br.se();
        if (br.error || d < -26 || d > 25) goto done;
        cur_qp = (cur_qp + d + 52) % 52;
      }
      qp_map[mb] = cur_qp;
      int32_t* lv = luma + (size_t)mb * 256;
      for (int g8 = 0; g8 < 4; g8++) {
        if (!((cbp_luma >> g8) & 1)) {
          for (int k = 0; k < 4; k++) {
            int bi = kZscanToRaster[g8 * 4 + k];
            lnnz[(r * 4 + bi / 4) * C * 4 + c * 4 + bi % 4] = 0;
          }
          continue;
        }
        for (int k = 0; k < 4; k++) {
          int bi = kZscanToRaster[g8 * 4 + k];
          int by = r * 4 + bi / 4, bx = c * 4 + bi % 4;
          int nC = nc_of(lnnz, C * 4, by, bx);
          int tc = decode_block(br, nC, 16, lv + bi * 16);
          if (tc < 0) goto done;
          lnnz[by * C * 4 + bx] = tc;
        }
      }
      int32_t* dcp = cdc + (size_t)mb * 8;
      int32_t* acp = cac + (size_t)mb * 120;
      if (cbp_chroma) {
        for (int comp = 0; comp < 2; comp++) {
          if (decode_block(br, -1, 4, dcp + comp * 4) < 0) goto done;
        }
      }
      if (cbp_chroma == 2) {
        for (int comp = 0; comp < 2; comp++) {
          for (int b = 0; b < 4; b++) {
            int by = r * 2 + b / 2, bx = c * 2 + b % 2;
            int nC = nc_of(cnnz + (size_t)comp * R * 2 * C * 2, C * 2, by, bx);
            int tc = decode_block(br, nC, 15, acp + (comp * 4 + b) * 15);
            if (tc < 0) goto done;
            cnnz[(comp * R * 2 + by) * C * 2 + bx] = tc;
          }
        }
      } else {
        for (int comp = 0; comp < 2; comp++)
          for (int b = 0; b < 2; b++)
            for (int bb = 0; bb < 2; bb++)
              cnnz[(comp * R * 2 + r * 2 + b) * C * 2 + c * 2 + bb] = 0;
      }
      mb++;
    }
  }
  ret = mb;
done:
  delete[] lnnz;
  delete[] cnnz;
  return ret;
}

// CAVLC -> CABAC transcode of one P slice: parse the CAVLC slice_data and
// re-emit it as a CABAC slice_data payload via the native CABAC packer.
// Returns payload bytes written, or <0 on error.
int64_t mtpu_transcode_pslice(const uint8_t* data, int64_t nbits,
                              int64_t bitpos, int R, int C, int qp,
                              const int32_t* init_mn, uint8_t* out,
                              int64_t cap) {
  int n_mb = R * C;
  int32_t* mv = new int32_t[(size_t)n_mb * 2];
  int32_t* luma = new int32_t[(size_t)n_mb * 256];
  int32_t* cdc = new int32_t[(size_t)n_mb * 8];
  int32_t* cac = new int32_t[(size_t)n_mb * 120];
  int32_t* qp_map = new int32_t[(size_t)n_mb];
  int64_t ret = mtpu_parse_slice_p(data, nbits, bitpos, R, C, qp, mv, luma,
                                   cdc, cac, qp_map);
  if (ret == n_mb) {
    // Pass the parsed per-MB QP map through: for uniform-QP slices every
    // delta re-encodes as 0 (bitstream unchanged); adaptive-QP CAVLC
    // slices transcode to CABAC with their QP map intact.
    ret = mtpu_cabac_write_slice_p(mv, luma, cdc, cac, R, C, qp, init_mn,
                                   qp_map, out, cap);
  } else if (ret >= 0) {
    ret = -3;  // slice did not cover the full picture
  }
  delete[] mv;
  delete[] luma;
  delete[] cdc;
  delete[] cac;
  delete[] qp_map;
  return ret;
}

}  // extern "C"
