// Sanitizer harness for the port's native codec paths (ASan/UBSan build).
//
// A copy of the JAX package's csrc/sanitize_test.cpp over the port's own
// copies of the C++ entropy coders (media_tpu_torch/csrc/{cavlc,cabac}_
// {pack,parse}.cpp) and the cavlc_tables.inc that
// media_tpu_torch/native/gen_tables.py generates. The coders are per-call
// stateless, and this harness proves the memory/UB hygiene of every
// exported hot path under AddressSanitizer + UBSan:
//   CAVLC write -> parse round trip, CABAC P write -> parse (with and
//   without a per-MB QP map), CABAC I write -> parse (I_16x16 + I_4x4),
//   CAVLC -> CABAC transcode -> parse (also at 1080p, 68 x 120 MBs), RBSP
//   escaping, and the CABAC engine alone (mtpu_cabac_engine_bins) into
//   buffers of exactly the size it needs and smaller, so that a carry into
//   the byte before the first, or a byte past the end, is caught.
//
// Build + run:  make sanitize-torch
// (g++ -fsanitize=address,undefined over the port's four TUs + this main.)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
int64_t mtpu_write_slice_p(uint64_t acc, int nbits, const int32_t* mv,
                           const int32_t* luma, const int32_t* cdc,
                           const int32_t* cac, int R, int C,
                           int32_t* scratch_luma_nnz,
                           int32_t* scratch_chroma_nnz, int32_t* scratch_mv,
                           uint8_t* out, int64_t cap);
int64_t mtpu_parse_slice_p(const uint8_t* data, int64_t nbits, int64_t bitpos,
                           int R, int C, int qp, int32_t* mv, int32_t* luma,
                           int32_t* cdc, int32_t* cac, int32_t* qp_map);
int64_t mtpu_cabac_write_slice_p(const int32_t* mv, const int32_t* luma,
                                 const int32_t* cdc, const int32_t* cac,
                                 int R, int C, int qp, const int32_t* init_mn,
                                 const int32_t* qp_map, uint8_t* out,
                                 int64_t cap);
int64_t mtpu_cabac_parse_slice_p(const uint8_t* data, int64_t nbytes,
                                 int64_t bitpos, int R, int C, int qp,
                                 const int32_t* init_mn, int32_t* mv,
                                 int32_t* luma, int32_t* cdc, int32_t* cac,
                                 int32_t* qp_map);
int64_t mtpu_cabac_write_slice_i(const int32_t* mode16,
                                 const int32_t* chroma_mode,
                                 const int32_t* dc, const int32_t* ac,
                                 const int32_t* cdc, const int32_t* cac,
                                 const int32_t* is_i4, const int32_t* modes4,
                                 const int32_t* luma4, int R, int C, int qp,
                                 const int32_t* init_mn, uint8_t* out,
                                 int64_t cap);
int64_t mtpu_cabac_parse_slice_i(const uint8_t* data, int64_t nbytes,
                                 int64_t bitpos, int R, int C, int qp,
                                 const int32_t* init_mn, int32_t* mode16,
                                 int32_t* chroma_mode, int32_t* dc,
                                 int32_t* ac, int32_t* cdc, int32_t* cac,
                                 int32_t* is_i4, int32_t* modes4,
                                 int32_t* luma4);
int64_t mtpu_transcode_pslice(const uint8_t* data, int64_t nbits,
                              int64_t bitpos, int R, int C, int qp,
                              const int32_t* init_mn, uint8_t* out,
                              int64_t cap);
int64_t mtpu_escape_rbsp(const uint8_t* in, int64_t n, uint8_t* out,
                         int64_t cap);
int64_t mtpu_cabac_engine_bins(const int32_t* ctx_idx, const int32_t* bins,
                               const int32_t* kinds, int64_t n, int qp,
                               const int32_t* init_mn, uint8_t* out,
                               int64_t cap);
}

namespace {

uint32_t g_seed = 12345;
int rnd(int lo, int hi) {  // inclusive
  g_seed = g_seed * 1664525u + 1013904223u;
  return lo + (int)((g_seed >> 8) % (uint32_t)(hi - lo + 1));
}

#define CHECK(cond)                                                     \
  do {                                                                  \
    if (!(cond)) {                                                      \
      std::fprintf(stderr, "CHECK failed at %s:%d: %s\n", __FILE__,     \
                   __LINE__, #cond);                                    \
      std::exit(1);                                                     \
    }                                                                   \
  } while (0)

struct PSyms {
  std::vector<int32_t> mv, luma, cdc, cac;
  PSyms(int R, int C) {
    int n = R * C;
    mv.assign((size_t)n * 2, 0);
    luma.assign((size_t)n * 256, 0);
    cdc.assign((size_t)n * 8, 0);
    cac.assign((size_t)n * 120, 0);
    for (int m = 0; m < n; m++) {
      bool zero_mb = rnd(0, 9) < 3;
      if (!zero_mb) {
        mv[m * 2] = rnd(-64, 64);
        mv[m * 2 + 1] = rnd(-64, 64);
        for (int i = 0; i < 256; i++)
          if (rnd(0, 5) == 0) luma[(size_t)m * 256 + i] = rnd(-20, 20);
        for (int i = 0; i < 8; i++)
          if (rnd(0, 3) == 0) cdc[(size_t)m * 8 + i] = rnd(-9, 9);
        for (int i = 0; i < 120; i++)
          if (rnd(0, 7) == 0) cac[(size_t)m * 120 + i] = rnd(-9, 9);
      }
    }
  }
};

void roundtrip_cavlc(int R, int C, int qp) {
  int n = R * C;
  PSyms s(R, C);
  std::vector<int32_t> snnz((size_t)R * 4 * C * 4), scnnz((size_t)2 * R * 2 * C * 2),
      smv((size_t)n * 2);
  std::vector<uint8_t> out((size_t)n * 512 + 4096);
  int64_t nbytes = mtpu_write_slice_p(0, 0, s.mv.data(), s.luma.data(),
                                      s.cdc.data(), s.cac.data(), R, C,
                                      snnz.data(), scnnz.data(), smv.data(),
                                      out.data(), (int64_t)out.size());
  CHECK(nbytes > 0);
  std::vector<int32_t> mv2((size_t)n * 2), luma2((size_t)n * 256),
      cdc2((size_t)n * 8), cac2((size_t)n * 120), qpm((size_t)n);
  int64_t covered = mtpu_parse_slice_p(out.data(), nbytes * 8, 0, R, C, qp,
                                       mv2.data(), luma2.data(), cdc2.data(),
                                       cac2.data(), qpm.data());
  CHECK(covered == n);
  CHECK(mv2 == s.mv && luma2 == s.luma && cdc2 == s.cdc && cac2 == s.cac);

  // CAVLC -> CABAC transcode of the same slice, then CABAC parse back.
  std::vector<int32_t> init((size_t)460 * 2);
  for (int i = 0; i < 460; i++) {
    init[i * 2] = 0;
    init[i * 2 + 1] = 64;  // uniform init: engine hygiene, not conformance
  }
  std::vector<uint8_t> cab((size_t)n * 512 + 4096);
  int64_t cb = mtpu_transcode_pslice(out.data(), nbytes * 8, 0, R, C, qp,
                                     init.data(), cab.data(),
                                     (int64_t)cab.size());
  CHECK(cb > 0);
  int64_t cov2 = mtpu_cabac_parse_slice_p(cab.data(), cb, 0, R, C, qp,
                                          init.data(), mv2.data(),
                                          luma2.data(), cdc2.data(),
                                          cac2.data(), qpm.data());
  CHECK(cov2 == n);
  CHECK(mv2 == s.mv && luma2 == s.luma && cdc2 == s.cdc && cac2 == s.cac);
}

void roundtrip_cabac_p(int R, int C, int qp, bool with_qp_map) {
  int n = R * C;
  PSyms s(R, C);
  std::vector<int32_t> init((size_t)460 * 2);
  for (int i = 0; i < 460; i++) {
    init[i * 2] = rnd(-20, 20);
    init[i * 2 + 1] = rnd(40, 90);
  }
  std::vector<int32_t> qmap;
  if (with_qp_map) {
    qmap.resize((size_t)n);
    for (int i = 0; i < n; i++) qmap[i] = qp + rnd(-3, 3);
  }
  std::vector<uint8_t> out((size_t)n * 512 + 4096);
  int64_t nbytes = mtpu_cabac_write_slice_p(
      s.mv.data(), s.luma.data(), s.cdc.data(), s.cac.data(), R, C, qp,
      init.data(), with_qp_map ? qmap.data() : nullptr, out.data(),
      (int64_t)out.size());
  CHECK(nbytes > 0);
  std::vector<int32_t> mv2((size_t)n * 2), luma2((size_t)n * 256),
      cdc2((size_t)n * 8), cac2((size_t)n * 120), qpm((size_t)n);
  int64_t covered = mtpu_cabac_parse_slice_p(
      out.data(), nbytes, 0, R, C, qp, init.data(), mv2.data(), luma2.data(),
      cdc2.data(), cac2.data(), qpm.data());
  CHECK(covered == n);
  CHECK(mv2 == s.mv && luma2 == s.luma && cdc2 == s.cdc && cac2 == s.cac);
  if (with_qp_map) {
    // Deltas are only coded on cbp != 0 MBs: verify those exactly.
    for (int m = 0; m < n; m++) {
      bool coded = false;
      for (int i = 0; i < 256 && !coded; i++)
        coded = s.luma[(size_t)m * 256 + i] != 0;
      for (int i = 0; i < 8 && !coded; i++)
        coded = s.cdc[(size_t)m * 8 + i] != 0;
      for (int i = 0; i < 120 && !coded; i++)
        coded = s.cac[(size_t)m * 120 + i] != 0;
      if (coded) CHECK(qpm[m] == qmap[m]);
    }
  }
}

void roundtrip_cabac_i(int R, int C, int qp) {
  int n = R * C;
  std::vector<int32_t> mode16((size_t)n), cmode((size_t)n), dc((size_t)n * 16),
      ac((size_t)n * 240), cdc((size_t)n * 8), cac((size_t)n * 120),
      is_i4((size_t)n), modes4((size_t)n * 16), luma4((size_t)n * 256);
  for (int m = 0; m < n; m++) {
    is_i4[m] = rnd(0, 1);
    cmode[m] = rnd(0, 3);
    if (is_i4[m]) {
      for (int i = 0; i < 16; i++) modes4[(size_t)m * 16 + i] = rnd(0, 8);
      for (int i = 0; i < 256; i++)
        if (rnd(0, 4) == 0) luma4[(size_t)m * 256 + i] = rnd(-9, 9);
    } else {
      mode16[m] = rnd(0, 3);
      for (int i = 0; i < 16; i++)
        if (rnd(0, 2) == 0) dc[(size_t)m * 16 + i] = rnd(-9, 9);
      for (int i = 0; i < 240; i++)
        if (rnd(0, 4) == 0) ac[(size_t)m * 240 + i] = rnd(-9, 9);
    }
    for (int i = 0; i < 8; i++)
      if (rnd(0, 3) == 0) cdc[(size_t)m * 8 + i] = rnd(-9, 9);
    for (int i = 0; i < 120; i++)
      if (rnd(0, 6) == 0) cac[(size_t)m * 120 + i] = rnd(-9, 9);
  }
  std::vector<int32_t> init((size_t)460 * 2);
  for (int i = 0; i < 460; i++) {
    init[i * 2] = 0;
    init[i * 2 + 1] = 64;
  }
  std::vector<uint8_t> out((size_t)n * 1024 + 4096);
  int64_t nbytes = mtpu_cabac_write_slice_i(
      mode16.data(), cmode.data(), dc.data(), ac.data(), cdc.data(),
      cac.data(), is_i4.data(), modes4.data(), luma4.data(), R, C, qp,
      init.data(), out.data(), (int64_t)out.size());
  CHECK(nbytes > 0);
  std::vector<int32_t> m2((size_t)n), c2((size_t)n), dc2((size_t)n * 16),
      ac2((size_t)n * 240), cd2((size_t)n * 8), ca2((size_t)n * 120),
      i42((size_t)n), mo2((size_t)n * 16), l42((size_t)n * 256);
  int64_t covered = mtpu_cabac_parse_slice_i(
      out.data(), nbytes, 0, R, C, qp, init.data(), m2.data(), c2.data(),
      dc2.data(), ac2.data(), cd2.data(), ca2.data(), i42.data(), mo2.data(),
      l42.data());
  CHECK(covered == n);
  CHECK(m2 == mode16 && c2 == cmode && dc2 == dc && ac2 == ac &&
        cd2 == cdc && ca2 == cac && i42 == is_i4 && mo2 == modes4 &&
        l42 == luma4);
}

void roundtrip_escape() {
  std::vector<uint8_t> raw(5000);
  for (auto& b : raw) b = (uint8_t)rnd(0, 3);  // EPB-dense content
  std::vector<uint8_t> esc(raw.size() * 2);
  int64_t ne = mtpu_escape_rbsp(raw.data(), (int64_t)raw.size(), esc.data(),
                                (int64_t)esc.size());
  CHECK(ne >= (int64_t)raw.size());
  // de-escape by hand and compare
  std::vector<uint8_t> back;
  int zeros = 0;
  for (int64_t i = 0; i < ne; i++) {
    uint8_t b = esc[i];
    if (zeros >= 2 && b == 3 && i + 1 < ne && esc[i + 1] <= 3) {
      zeros = 0;
      continue;
    }
    back.push_back(b);
    zeros = b == 0 ? zeros + 1 : 0;
  }
  CHECK(back == raw);
}

// Streams of every kind of bin, long bypass runs of 1s among them. Each is
// coded into a heap buffer of exactly the payload plus the slack byte (the
// same bytes), of the payload alone and of fewer bytes (-1, nothing written
// outside the buffer).
void engine_bins() {
  std::vector<int32_t> init((size_t)460 * 2);
  for (int i = 0; i < 460; i++) {
    init[i * 2] = rnd(-20, 20);
    init[i * 2 + 1] = rnd(20, 110);
  }
  for (int trial = 0; trial < 200; trial++) {
    int n = trial < 40 ? trial % 21 : rnd(0, 3000);
    std::vector<int32_t> ctx((size_t)n), bins((size_t)n), kinds((size_t)n);
    int ones_from = rnd(0, n), ones_to = rnd(ones_from, n);
    for (int i = 0; i < n; i++) {
      int k = rnd(0, 9);
      kinds[i] = k < 6 ? 0 : (k < 9 ? 1 : 2);
      ctx[i] = rnd(0, 459);
      bins[i] = kinds[i] == 2 ? 0 : rnd(0, 1);
      if (i >= ones_from && i < ones_to) {
        kinds[i] = 1;
        bins[i] = 1;
      }
    }
    int qp = rnd(0, 51);
    std::vector<uint8_t> big((size_t)n + 64);
    int64_t len = mtpu_cabac_engine_bins(ctx.data(), bins.data(), kinds.data(),
                                         n, qp, init.data(), big.data(),
                                         (int64_t)big.size());
    CHECK(len > 0);
    for (int64_t cap : {len + 1, len, len / 2, (int64_t)1, (int64_t)0}) {
      uint8_t* exact = new uint8_t[cap > 0 ? cap : 1];
      int64_t got = mtpu_cabac_engine_bins(ctx.data(), bins.data(),
                                           kinds.data(), n, qp, init.data(),
                                           exact, cap);
      if (cap > len) {
        CHECK(got == len && std::memcmp(exact, big.data(), len) == 0);
      } else {
        CHECK(got == -1);
      }
      delete[] exact;
    }
  }
}

}  // namespace

int main() {
  for (int trial = 0; trial < 3; trial++) {
    int R = rnd(2, 6), C = rnd(2, 9), qp = rnd(18, 40);
    roundtrip_cavlc(R, C, qp);
    roundtrip_cabac_p(R, C, qp, false);
    roundtrip_cabac_p(R, C, qp, true);
    roundtrip_cabac_i(R, C, qp);
  }
  roundtrip_escape();
  engine_bins();
  // The benchmark's 1080p picture through the transcode.
  roundtrip_cavlc(68, 120, 32);
  // A width-1 picture exercises the single-neighbor MV prediction rule.
  roundtrip_cavlc(5, 1, 28);
  roundtrip_cabac_p(5, 1, 28, false);
  std::puts("sanitize_test: all round trips clean");
  return 0;
}
