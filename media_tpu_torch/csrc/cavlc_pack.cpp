// Native CAVLC slice packer: hot-path twin of
// media_tpu_torch/pipeline/slice_coder.py and media_tpu_torch/entropy/cavlc.py
// (the Python implementations are the tested oracle; tests assert
// byte-identical output). A copy of the JAX package's csrc/cavlc_pack.cpp.
// Consumes the frame encoder's per-MB symbol arrays and emits the slice RBSP,
// continuing from the Python BitWriter's state so the slice header stays in
// Python.
//
// Build: see media_tpu_torch/native/__init__.py (g++ -O2 -shared -fPIC).

#include <cstdint>
#include <cstring>

#include "cavlc_tables.inc"

namespace {

struct BitWriter {
  uint8_t* out;
  int64_t cap;
  int64_t nbytes;
  uint64_t acc;
  int nbits;
  bool overflow;

  void put_byte(uint8_t b) {
    if (nbytes >= cap) { overflow = true; return; }
    out[nbytes++] = b;
  }

  void u(int n, uint32_t value) {
    acc = (acc << n) | value;
    nbits += n;
    while (nbits >= 8) {
      nbits -= 8;
      put_byte(static_cast<uint8_t>((acc >> nbits) & 0xFF));
    }
    acc &= (1ULL << nbits) - 1;
  }

  void ue(uint32_t value) {
    uint32_t code = value + 1;
    int n = 32 - __builtin_clz(code);
    u(2 * n - 1, code);
  }

  void se(int32_t value) {
    ue(value > 0 ? 2 * (uint32_t)value - 1 : (uint32_t)(-2 * (int64_t)value));
  }

  void rbsp_trailing() {
    u(1, 1);
    if (nbits) u(8 - nbits, 0);
  }
};

void write_level(BitWriter& bw, int64_t level_code, int suffix_length) {
  if (suffix_length == 0) {
    if (level_code < 14) {
      bw.u((int)level_code + 1, 1);
    } else if (level_code < 30) {
      bw.u(15, 1);
      bw.u(4, (uint32_t)(level_code - 14));
    } else {
      int64_t rem = level_code - 30;
      int prefix = 15;
      int64_t base = 0;
      for (;;) {
        base = (prefix == 15) ? 0 : ((int64_t)1 << (prefix - 3)) - 4096;
        int64_t span = (int64_t)1 << (prefix - 3);
        if (rem < base + span) break;
        ++prefix;
      }
      bw.u(prefix + 1, 1);
      bw.u(prefix - 3, (uint32_t)(rem - base));
    }
  } else {
    if ((level_code >> suffix_length) < 15) {
      bw.u((int)(level_code >> suffix_length) + 1, 1);
      bw.u(suffix_length, (uint32_t)(level_code & (((int64_t)1 << suffix_length) - 1)));
    } else {
      int64_t rem = level_code - ((int64_t)15 << suffix_length);
      int prefix = 15;
      int64_t base = 0;
      for (;;) {
        base = (prefix == 15) ? 0 : ((int64_t)1 << (prefix - 3)) - 4096;
        int64_t span = (int64_t)1 << (prefix - 3);
        if (rem < base + span) break;
        ++prefix;
      }
      bw.u(prefix + 1, 1);
      bw.u(prefix - 3, (uint32_t)(rem - base));
    }
  }
}

// Encode one residual block (zig-zag order). Returns TotalCoeff.
int encode_block(BitWriter& bw, const int32_t* coeffs, int max_coeff, int n_c) {
  int nz_idx[16];
  int total_coeff = 0;
  for (int i = 0; i < max_coeff; ++i) {
    if (coeffs[i] != 0) nz_idx[total_coeff++] = i;
  }

  if (total_coeff == 0) {
    if (n_c == -1) {
      bw.u(kLenCTCdc[0][0], kCodCTCdc[0][0]);
    } else if (n_c >= 8) {
      bw.u(6, 3);
    } else {
      int ctx = n_c < 2 ? 0 : (n_c < 4 ? 1 : 2);
      bw.u(kLenCT[ctx][0][0], kCodCT[ctx][0][0]);
    }
    return 0;
  }

  int last = nz_idx[total_coeff - 1];
  int total_zeros = last + 1 - total_coeff;

  int trailing_ones = 0;
  for (int k = total_coeff - 1; k >= 0 && trailing_ones < 3; --k) {
    int v = coeffs[nz_idx[k]];
    if (v == 1 || v == -1) ++trailing_ones; else break;
  }

  if (n_c == -1) {
    bw.u(kLenCTCdc[trailing_ones][total_coeff], kCodCTCdc[trailing_ones][total_coeff]);
  } else if (n_c >= 8) {
    bw.u(6, (uint32_t)(((total_coeff - 1) << 2) | trailing_ones));
  } else {
    int ctx = n_c < 2 ? 0 : (n_c < 4 ? 1 : 2);
    bw.u(kLenCT[ctx][trailing_ones][total_coeff], kCodCT[ctx][trailing_ones][total_coeff]);
  }

  for (int k = 0; k < trailing_ones; ++k) {
    bw.u(1, coeffs[nz_idx[total_coeff - 1 - k]] < 0 ? 1 : 0);
  }

  int suffix_length = (total_coeff > 10 && trailing_ones < 3) ? 1 : 0;
  int n_rem = total_coeff - trailing_ones;
  for (int i = 0; i < n_rem; ++i) {
    int level = coeffs[nz_idx[n_rem - 1 - i]];
    int64_t level_code = level > 0 ? 2 * (int64_t)level - 2 : -2 * (int64_t)level - 1;
    if (i == 0 && trailing_ones < 3) level_code -= 2;
    write_level(bw, level_code, suffix_length);
    if (suffix_length == 0) suffix_length = 1;
    int abs_level = level < 0 ? -level : level;
    if (abs_level > (3 << (suffix_length - 1)) && suffix_length < 6) ++suffix_length;
  }

  if (total_coeff < max_coeff) {
    if (n_c == -1) {
      bw.u(kLenTZCdc[total_coeff - 1][total_zeros], kCodTZCdc[total_coeff - 1][total_zeros]);
    } else {
      bw.u(kLenTZ[total_coeff - 1][total_zeros], kCodTZ[total_coeff - 1][total_zeros]);
    }
  }

  int zeros_left = total_zeros;
  for (int k = 0; k < total_coeff - 1; ++k) {
    if (zeros_left <= 0) break;
    int run = nz_idx[total_coeff - 1 - k] - nz_idx[total_coeff - 2 - k] - 1;
    int zl = zeros_left < 7 ? zeros_left : 7;
    bw.u(kLenRB[zl - 1][run], kCodRB[zl - 1][run]);
    zeros_left -= run;
  }
  return total_coeff;
}

struct NcState {
  int32_t* luma;      // (R*4) x (C*4)
  int32_t* chroma[2]; // (R*2) x (C*2) each
  int lw, cw;         // row strides

  int nc_luma(int by, int bx) const {
    bool a = bx > 0, b = by > 0;
    if (a && b) return (luma[by * lw + bx - 1] + luma[(by - 1) * lw + bx] + 1) >> 1;
    if (a) return luma[by * lw + bx - 1];
    if (b) return luma[(by - 1) * lw + bx];
    return 0;
  }
  int nc_chroma(int comp, int by, int bx) const {
    const int32_t* n = chroma[comp];
    bool a = bx > 0, b = by > 0;
    if (a && b) return (n[by * cw + bx - 1] + n[(by - 1) * cw + bx] + 1) >> 1;
    if (a) return n[by * cw + bx - 1];
    if (b) return n[(by - 1) * cw + bx];
    return 0;
  }
};

bool any_nonzero(const int32_t* p, int n) {
  for (int i = 0; i < n; ++i) if (p[i]) return true;
  return false;
}

void write_chroma_residual(BitWriter& bw, NcState& st, int r, int c,
                           const int32_t* cdc, const int32_t* cac, int cbp_chroma) {
  if (cbp_chroma) {
    for (int comp = 0; comp < 2; ++comp) {
      encode_block(bw, cdc + comp * 4, 4, -1);
    }
  }
  if (cbp_chroma == 2) {
    for (int comp = 0; comp < 2; ++comp) {
      for (int bi = 0; bi < 4; ++bi) {
        int by = r * 2 + bi / 2, bx = c * 2 + bi % 2;
        int n_c = st.nc_chroma(comp, by, bx);
        int tc = encode_block(bw, cac + (comp * 4 + bi) * 15, 15, n_c);
        st.chroma[comp][by * st.cw + bx] = tc;
      }
    }
  } else {
    for (int comp = 0; comp < 2; ++comp) {
      for (int dy = 0; dy < 2; ++dy)
        for (int dx = 0; dx < 2; ++dx)
          st.chroma[comp][(r * 2 + dy) * st.cw + c * 2 + dx] = 0;
    }
  }
}

int median3(int a, int b, int c) {
  int mn = a < b ? a : b;
  int mx = a > b ? a : b;
  return mx < c ? mx : (c < mn ? mn : c);
}

}  // namespace

extern "C" {

// Continue from a Python BitWriter state (acc/nbits; completed bytes stay on
// the Python side) and write all I-slice macroblocks + rbsp trailing bits.
// Returns output byte count, or -1 on overflow.
int64_t mtpu_write_slice_i(
    uint64_t acc, int nbits,
    const int32_t* mode16, const int32_t* chroma_mode,
    const int32_t* dc, const int32_t* ac,
    const int32_t* cdc, const int32_t* cac,
    int R, int C,
    int32_t* scratch_luma_nnz, int32_t* scratch_chroma_nnz,
    uint8_t* out, int64_t cap) {
  BitWriter bw{out, cap, 0, acc, nbits, false};
  NcState st{scratch_luma_nnz, {scratch_chroma_nnz, scratch_chroma_nnz + R * 2 * C * 2},
             C * 4, C * 2};
  memset(scratch_luma_nnz, 0, sizeof(int32_t) * R * 4 * C * 4);
  memset(scratch_chroma_nnz, 0, sizeof(int32_t) * 2 * R * 2 * C * 2);

  for (int r = 0; r < R; ++r) {
    for (int c = 0; c < C; ++c) {
      int mb = r * C + c;
      const int32_t* mb_ac = ac + mb * 16 * 15;
      const int32_t* mb_cdc = cdc + mb * 2 * 4;
      const int32_t* mb_cac = cac + mb * 2 * 4 * 15;
      int cbp_luma = any_nonzero(mb_ac, 16 * 15) ? 15 : 0;
      int cbp_chroma = any_nonzero(mb_cac, 2 * 4 * 15) ? 2
                       : (any_nonzero(mb_cdc, 2 * 4) ? 1 : 0);
      int mb_type = 1 + mode16[mb] + 4 * cbp_chroma + 12 * (cbp_luma ? 1 : 0);
      bw.ue(mb_type);
      bw.ue(chroma_mode[mb]);
      bw.se(0);  // mb_qp_delta
      // Luma DC
      int n_c = st.nc_luma(r * 4, c * 4);
      encode_block(bw, dc + mb * 16, 16, n_c);
      if (cbp_luma) {
        for (int zi = 0; zi < 16; ++zi) {
          int bi = kZscanToRaster[zi];
          int by = r * 4 + bi / 4, bx = c * 4 + bi % 4;
          int nc2 = st.nc_luma(by, bx);
          int tc = encode_block(bw, mb_ac + bi * 15, 15, nc2);
          st.luma[by * st.lw + bx] = tc;
        }
      } else {
        for (int dy = 0; dy < 4; ++dy)
          for (int dx = 0; dx < 4; ++dx)
            st.luma[(r * 4 + dy) * st.lw + c * 4 + dx] = 0;
      }
      write_chroma_residual(bw, st, r, c, mb_cdc, mb_cac, cbp_chroma);
      if (bw.overflow) return -1;
    }
  }
  bw.rbsp_trailing();
  return bw.overflow ? -1 : bw.nbytes;
}

// P slice macroblocks (P_L0_16x16 / P_Skip). mv is quarter-pel.
int64_t mtpu_write_slice_p(
    uint64_t acc, int nbits,
    const int32_t* mv, const int32_t* luma,
    const int32_t* cdc, const int32_t* cac,
    int R, int C,
    int32_t* scratch_luma_nnz, int32_t* scratch_chroma_nnz, int32_t* scratch_mv,
    uint8_t* out, int64_t cap) {
  BitWriter bw{out, cap, 0, acc, nbits, false};
  NcState st{scratch_luma_nnz, {scratch_chroma_nnz, scratch_chroma_nnz + R * 2 * C * 2},
             C * 4, C * 2};
  memset(scratch_luma_nnz, 0, sizeof(int32_t) * R * 4 * C * 4);
  memset(scratch_chroma_nnz, 0, sizeof(int32_t) * 2 * R * 2 * C * 2);
  // scratch_mv: (R*C*2) quarter-pel MV map (all MBs inter here).
  int32_t* mvm = scratch_mv;

  auto predict = [&](int r, int c, int* px, int* py) {
    // Median MV prediction, mirroring pipeline/mv_pred.py (all MBs inter).
    bool a_av = c > 0, b_av = r > 0;
    bool c_av = r > 0 && c + 1 < C;
    int cax = 0, cay = 0;
    if (c_av) {
      cax = mvm[((r - 1) * C + c + 1) * 2];
      cay = mvm[((r - 1) * C + c + 1) * 2 + 1];
    } else if (r > 0 && c > 0) {
      c_av = true;
      cax = mvm[((r - 1) * C + c - 1) * 2];
      cay = mvm[((r - 1) * C + c - 1) * 2 + 1];
    }
    int ax = a_av ? mvm[(r * C + c - 1) * 2] : 0;
    int ay = a_av ? mvm[(r * C + c - 1) * 2 + 1] : 0;
    int bx = b_av ? mvm[((r - 1) * C + c) * 2] : 0;
    int by = b_av ? mvm[((r - 1) * C + c) * 2 + 1] : 0;
    if (a_av && !b_av && !c_av) { *px = ax; *py = ay; return; }
    // 8.4.1.3.2 rule 2: exactly one available neighbor -> its MV alone
    // (only differs from the median for C == 1, r > 0: selects mvB).
    int n_av = (a_av ? 1 : 0) + (b_av ? 1 : 0) + (c_av ? 1 : 0);
    if (n_av == 1) {
      if (a_av) { *px = ax; *py = ay; }
      else if (b_av) { *px = bx; *py = by; }
      else { *px = cax; *py = cay; }
      return;
    }
    *px = median3(ax, bx, cax);
    *py = median3(ay, by, cay);
  };

  auto skip_mv = [&](int r, int c, int* sx, int* sy) {
    if (r == 0 || c == 0) { *sx = 0; *sy = 0; return; }
    int ax = mvm[(r * C + c - 1) * 2], ay = mvm[(r * C + c - 1) * 2 + 1];
    int bx = mvm[((r - 1) * C + c) * 2], by = mvm[((r - 1) * C + c) * 2 + 1];
    if ((ax == 0 && ay == 0) || (bx == 0 && by == 0)) { *sx = 0; *sy = 0; return; }
    predict(r, c, sx, sy);
  };

  int skip_run = 0;
  for (int r = 0; r < R; ++r) {
    for (int c = 0; c < C; ++c) {
      int mb = r * C + c;
      int qx = mv[mb * 2], qy = mv[mb * 2 + 1];
      const int32_t* mb_luma = luma + mb * 16 * 16;
      const int32_t* mb_cdc = cdc + mb * 2 * 4;
      const int32_t* mb_cac = cac + mb * 2 * 4 * 15;

      int cbp_luma = 0;
      for (int g8 = 0; g8 < 4; ++g8) {
        for (int k = 0; k < 4; ++k) {
          int b = kZscanToRaster[g8 * 4 + k];
          if (any_nonzero(mb_luma + b * 16, 16)) { cbp_luma |= 1 << g8; break; }
        }
      }
      int cbp_chroma = any_nonzero(mb_cac, 2 * 4 * 15) ? 2
                       : (any_nonzero(mb_cdc, 2 * 4) ? 1 : 0);
      int cbp = cbp_luma | (cbp_chroma << 4);

      int sx, sy;
      skip_mv(r, c, &sx, &sy);
      if (cbp == 0 && qx == sx && qy == sy) {
        ++skip_run;
        mvm[mb * 2] = qx;
        mvm[mb * 2 + 1] = qy;
        for (int dy = 0; dy < 4; ++dy)
          for (int dx = 0; dx < 4; ++dx)
            st.luma[(r * 4 + dy) * st.lw + c * 4 + dx] = 0;
        for (int comp = 0; comp < 2; ++comp)
          for (int dy = 0; dy < 2; ++dy)
            for (int dx = 0; dx < 2; ++dx)
              st.chroma[comp][(r * 2 + dy) * st.cw + c * 2 + dx] = 0;
        continue;
      }

      bw.ue(skip_run);
      skip_run = 0;
      bw.ue(0);  // mb_type P_L0_16x16
      int px, py;
      predict(r, c, &px, &py);
      bw.se(qx - px);
      bw.se(qy - py);
      mvm[mb * 2] = qx;
      mvm[mb * 2 + 1] = qy;
      bw.ue(kCbpCodeInter[cbp]);
      if (cbp) bw.se(0);  // mb_qp_delta
      for (int g8 = 0; g8 < 4; ++g8) {
        if (!((cbp_luma >> g8) & 1)) {
          for (int k = 0; k < 4; ++k) {
            int b = kZscanToRaster[g8 * 4 + k];
            st.luma[(r * 4 + b / 4) * st.lw + c * 4 + b % 4] = 0;
          }
          continue;
        }
        for (int k = 0; k < 4; ++k) {
          int b = kZscanToRaster[g8 * 4 + k];
          int by = r * 4 + b / 4, bx = c * 4 + b % 4;
          int n_c = st.nc_luma(by, bx);
          int tc = encode_block(bw, mb_luma + b * 16, 16, n_c);
          st.luma[by * st.lw + bx] = tc;
        }
      }
      write_chroma_residual(bw, st, r, c, mb_cdc, mb_cac, cbp_chroma);
      if (bw.overflow) return -1;
    }
  }
  if (skip_run) bw.ue(skip_run);
  bw.rbsp_trailing();
  return bw.overflow ? -1 : bw.nbytes;
}

// RBSP -> EBSP (emulation prevention). Returns escaped length or -1.
int64_t mtpu_escape_rbsp(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
  int64_t j = 0;
  int zeros = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint8_t b = in[i];
    if (zeros >= 2 && b <= 3) {
      if (j >= cap) return -1;
      out[j++] = 3;
      zeros = 0;
    }
    if (j >= cap) return -1;
    out[j++] = b;
    zeros = b == 0 ? zeros + 1 : 0;
  }
  return j;
}

}  // extern "C"
