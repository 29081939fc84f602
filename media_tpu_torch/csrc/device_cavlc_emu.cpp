// The C ABI of csrc/device_cavlc.cu built for the host, for the CPU tests
// (tests/test_torch_device_cavlc.py builds it with g++ and hands it to the
// wrapper in place of the kernel library): device_cavlc_launch runs the same
// per-MB, per-chunk and placement functions (device_cavlc.cuh) the kernels
// call, serially, with the kernels' scans and the tree's group sums written
// as plain loops over the whole slice. Pointers are to host memory; scratch
// and stream are not used. Returns 0, or -1 on a bad argument.

#include <stdint.h>

#include <vector>

#include "device_cavlc.cuh"

using namespace media_cavlc;

namespace {

struct HostOr {
  void operator()(uint64_t* word, uint32_t bits) const { *word |= bits; }
};

}  // namespace

extern "C" long long device_cavlc_scratch_bytes(int, int) { return 0; }

extern "C" int device_cavlc_launch(
    const int32_t* mv, const int32_t* luma, const int32_t* cdc,
    const int32_t* cac, const int64_t* strides, const int32_t* qp_map,
    const int32_t* slice_qp, int slice_qp_value, const void* const* tables,
    int levels, const int64_t* caps, const int64_t* wraps, int64_t* out,
    long long out_words, int64_t* total_bits, void*, int R, int C, void*) {
  if (R <= 0 || C <= 0 || levels < 1 || levels > kMaxLevels || out_words < 1)
    return -1;
  const int n = R * C;
  const int64_t n_chunks = (int64_t)kChunksPerMb * n + 1;
  const Symbols s = symbols_of(mv, luma, cdc, cac, strides, qp_map, slice_qp,
                               slice_qp_value, R, C);
  const Tables t = tables_of(tables);
  const Schedule sc = schedule_of(levels, caps, wraps, out_words);
  std::vector<int32_t> info(n), mvd(2 * n), skip_run(n), qp_delta(n), trail(1);
  std::vector<uint8_t> nnz(24 * n);
  MbState st{info.data(),     mvd.data(),      nnz.data(),
             skip_run.data(), qp_delta.data(), trail.data()};

  for (int mb = 0; mb < n; ++mb) mb_metadata(s, t, mb, st);
  const int seed = qp_map ? slice_qp_of(s) : 0;
  int prev = -1, prev_cbp = -1;
  for (int i = 0; i < n; ++i) {
    skip_run[i] = i - prev - 1;
    if (qp_map)
      qp_delta[i] = qp_delta_of(qp_map[i], prev_cbp >= 0 ? qp_map[prev_cbp]
                                                         : seed);
    if (!(info[i] & 64)) {
      prev = i;
      if (info[i] & 63) prev_cbp = i;
    }
  }
  trail[0] = n - 1 - prev;

  std::vector<int64_t> bits(n_chunks), before(n_chunks + 1, 0);
  for (int64_t ch = 0; ch < n_chunks; ++ch) {
    Count count;
    chunk_codes(s, t, st, ch, count);
    bits[ch] = count.bits;
    before[ch + 1] = before[ch] + count.bits;
  }
  for (int64_t i = 0; i < out_words; ++i) out[i] = 0;
  for (int64_t ch = 0; ch < n_chunks; ++ch) {
    if (bits[ch] == 0) continue;
    auto prefix = [&](int L) {
      const int64_t a0 = (ch >> (3 * (L - 1))) << (3 * (L - 1));
      const int64_t g0 = (ch >> (3 * L)) << (3 * L);
      return before[a0] - before[g0];
    };
    int64_t shift, keep;
    place(sc, slot_bits_of(s, ch), bits[ch], prefix, &shift, &keep);
    if (keep <= 0) continue;
    Writer<HostOr> w{reinterpret_cast<uint64_t*>(out), shift, keep, HostOr()};
    chunk_codes(s, t, st, ch, w);
    w.flush();
  }
  bool fail = false;
  for (int L = 1; L <= levels; ++L) {
    const int64_t span = (int64_t)1 << (3 * L);
    for (int64_t g0 = 0; g0 < n_chunks; g0 += span) {
      const int64_t g1 = g0 + span < n_chunks ? g0 + span : n_chunks;
      if (before[g1] - before[g0] > sc.cap_bits[L - 1]) fail = true;
    }
  }
  *total_bits = fail ? sc.out_bits + 1 : before[n_chunks];
  return 0;
}
