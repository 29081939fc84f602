// The C ABI of csrc/pframe_core.cu built for the host, for the CPU tests
// (tests/test_torch_pframe_kernel.py builds it with g++ and hands it to the
// wrapper in place of the kernel library): each entry point runs the same
// per-MB function (pframe_core.cuh's mb_pframe) the kernel runs, over the
// MBs in order, as one thread of a block of one; the packed helpers are the
// header's byte loops, which pframe_packed_ops hands to the tests. Pointers
// are to host memory; the stream is not used. Returns 0, or -1 on a bad
// argument.

#include <stdint.h>

#include <vector>

#include "pframe_core.cuh"

using namespace media_pcore;

namespace {

template <typename Pix>
int run(const Args<Pix>& a) {
  if (a.R <= 0 || a.C <= 0 || a.rs < 0 || a.rs > kMaxRange) return -1;
  if (a.sad_total) *a.sad_total = 0;
  std::vector<uint32_t> smem(Smem::words(a.rs));
  const Smem s(smem.data(), a.rs);
  for (int mb = 0; mb < a.R * a.C; ++mb) mb_pframe(a, mb, s, 0, 1);
  return 0;
}

}  // namespace

extern "C" int pframe_core_launch(
    const int32_t* cur_y, const int32_t* cur_u, const int32_t* cur_v,
    const int32_t* ref_y, const int32_t* ref_u, const int32_t* ref_v,
    const int64_t* strides, const int32_t* qp, int qp_stride, int qp_value,
    const int32_t* qp_c, int qp_c_stride, int qp_c_value, const int32_t* mf,
    const int32_t* v, const int64_t* zz, int16_t* symbols, uint8_t* recon_y,
    uint8_t* recon_u, uint8_t* recon_v, int32_t* sad_total, int R, int C,
    int rs, void*) {
  return run(core_args(cur_y, cur_u, cur_v, ref_y, ref_u, ref_v, strides, qp,
                       qp_stride, qp_value, qp_c, qp_c_stride, qp_c_value, mf,
                       v, zz, symbols, recon_y, recon_u, recon_v, sad_total, R,
                       C, rs, 0));
}

extern "C" int pframe_core_u8_launch(
    const uint8_t* cur_y, const uint8_t* cur_u, const uint8_t* cur_v,
    const uint8_t* ref_y, const uint8_t* ref_u, const uint8_t* ref_v,
    const int64_t* strides, const int32_t* qp, int qp_stride, int qp_value,
    const int32_t* qp_c, int qp_c_stride, int qp_c_value, const int32_t* mf,
    const int32_t* v, const int64_t* zz, int16_t* symbols, uint8_t* recon_y,
    uint8_t* recon_u, uint8_t* recon_v, int32_t* sad_total, int R, int C,
    int rs, int whole, void*) {
  return run(core_args(cur_y, cur_u, cur_v, ref_y, ref_u, ref_v, strides, qp,
                       qp_stride, qp_value, qp_c, qp_c_stride, qp_c_value, mf,
                       v, zz, symbols, recon_y, recon_u, recon_v, sad_total, R,
                       C, rs, whole));
}

extern "C" int pframe_search_launch(const int32_t* cur, const int32_t* ref_y,
                                    long long ref_row, int32_t* qmv,
                                    int32_t* pred, int32_t* cost, int R, int C,
                                    int rs, void*) {
  return run(search_args(cur, ref_y, ref_row, qmv, pred, cost, R, C, rs));
}

// The packed helpers on n word pairs, for the tests: for each i, out[6 i]
// = sad4(a[i], b[i], acc[i]), out[6 i + 1] = avg4(a[i], b[i]) and
// out[6 i + 2 + n] = align4(a[i], b[i], n) for n = 0..3.
extern "C" void pframe_packed_ops(const uint32_t* a, const uint32_t* b,
                                  const uint32_t* acc, int n, uint32_t* out) {
  for (int i = 0; i < n; ++i) {
    out[6 * i] = sad4(a[i], b[i], acc[i]);
    out[6 * i + 1] = avg4(a[i], b[i]);
    for (int k = 0; k < 4; ++k) out[6 * i + 2 + k] = align4(a[i], b[i], k);
  }
}
