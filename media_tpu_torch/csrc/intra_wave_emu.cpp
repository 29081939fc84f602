// The C ABI of csrc/intra_wave.cu built for the host, for the CPU tests
// (tests/test_torch_intra_kernel.py builds it with g++ and hands it to the
// wrappers in place of the kernel library): each entry point runs the same
// per-MB function (intra_wave.cuh's mb_intra_encode, mb_intra_recon) the
// kernels run, as one thread of a block of one, over the MBs of the same
// waves in the same order as the kernel launches (one wave after another,
// a wave's blocks in turn), so that the tests also hold the schedule: an
// MB the waves missed, or one run before a neighbour, would show. Pointers
// are to host memory; the stream is not used. Returns 0, or -1 on a bad
// argument.

#include <stdint.h>

#include <memory>

#include "intra_wave.cuh"

using namespace media_intra;

namespace {

bool bad(int R, int C, int qp, int qp_c) {
  return R <= 0 || C <= 0 || qp < 0 || qp > 51 || qp_c < 0 || qp_c > 51;
}

// intra_wave.cu's launch_waves, block by block: mb(r, c) for block b of
// wave k.
template <typename F>
void run_waves(int R, int C, int skew, F&& mb) {
  for (int k = 0; k < n_waves(R, C, skew); ++k) {
    const int lo = wave_first_row(k, C, skew);
    const int n = wave_last_row(k, R, skew) - lo + 1;
    for (int b = 0; b < n; ++b) mb(lo + b, k - skew * (lo + b));
  }
}

}  // namespace

extern "C" int intra_encode_launch(
    const int32_t* y, const int32_t* u, const int32_t* v,
    const int64_t* strides, const uint8_t* has_top, int qp, int qp_c,
    const int32_t* mf, const int32_t* vt, const int64_t* zz,
    const int32_t* taps, int32_t* mode16, int32_t* chroma_mode, int32_t* dc,
    int32_t* ac, int32_t* cdc, int32_t* cac, uint8_t* is_i4, int32_t* modes4,
    int32_t* luma4, uint8_t* recon_y, uint8_t* recon_u, uint8_t* recon_v,
    int R, int C, int i4x4, void*) {
  if (bad(R, C, qp, qp_c)) return -1;
  const EncArgs a{y, u, v, strides[0], strides[1], strides[2], has_top, qp,
                  qp_c, mf, vt, zz, taps, mode16, chroma_mode, dc, ac, cdc,
                  cac, is_i4, modes4, luma4, recon_y, recon_u, recon_v, R, C};
  const auto s = std::make_unique<Smem>();
  if (i4x4)
    run_waves(R, C, 2, [&](int r, int c) {
      mb_intra_encode<true>(a, r, c, *s, 0, 1);
    });
  else
    run_waves(R, C, 1, [&](int r, int c) {
      mb_intra_encode<false>(a, r, c, *s, 0, 1);
    });
  return 0;
}

extern "C" int intra_recon_launch(
    const int32_t* mode16, const int32_t* chroma_mode, const int32_t* dc,
    const int32_t* ac, const int32_t* cdc, const int32_t* cac,
    const uint8_t* is_i4, const int32_t* modes4, const int32_t* luma4,
    const uint8_t* has_top, int qp, int qp_c, const int32_t* mf,
    const int32_t* vt, const int64_t* zz, const int32_t* taps,
    uint8_t* recon_y, uint8_t* recon_u, uint8_t* recon_v, int R, int C,
    void*) {
  if (bad(R, C, qp, qp_c)) return -1;
  const RecArgs a{mode16, chroma_mode, dc,  ac,      cdc,     cac,
                  is_i4,  modes4,      luma4, has_top, qp,      qp_c,
                  mf,     vt,          zz,  taps,    recon_y, recon_u,
                  recon_v, R,          C};
  const auto s = std::make_unique<Smem>();
  if (is_i4)
    run_waves(R, C, 2, [&](int r, int c) {
      mb_intra_recon<true>(a, r, c, *s, 0, 1);
    });
  else
    run_waves(R, C, 1, [&](int r, int c) {
      mb_intra_recon<false>(a, r, c, *s, 0, 1);
    });
  return 0;
}
