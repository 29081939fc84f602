// The intra wavefront of the encoder's IDR and of the decoder's I picture,
// for sm_90a.
//
// Replaces what the JAX package compiles with XLA into one program a
// picture (no Pallas kernel): media_tpu/pipeline/encoder.py:451
// _encode_iframe_device (a lax.scan over the waves; the I_4x4 decision at
// :522-602) and media_tpu/pipeline/decoder_tpu.py:323 _recon_iframe_device
// and :430 _recon_iframe_mixed_device. Their plain PyTorch twins,
// pipeline/encoder.py:intra_encode_plain and
// pipeline/decoder_tpu.py:intra_recon_plain, run a Python loop over the
// waves of some 600 eager launches each (117144 an I_16x16 IDR at 1080p).
// The arithmetic per MB is intra_wave.cuh's.
//
// Bound on the card: at 1080p the encoder reads the int32 planes (12.5 MB)
// and writes the int32 symbols (up to 22 MB with I_4x4) and 3.1 MB of
// recon, some 0.01 ms at the memory rate; its operations are fewer still.
// What bounds it is the chain of dependent waves: MB (r, c) needs the
// reconstruction of its left, top (and, for I_4x4, top-right) neighbours,
// so there are R + C - 1 waves (2 (R - 1) + C with I_4x4), each at most
// min(R, C) MBs wide. The design is the simple one: one launch a wave, the
// kernel boundary the barrier between waves, one block of 256 threads an
// MB, the MB's neighbours, tables and candidates in shared memory; the
// waves are enqueued from C on the caller's stream with no host read
// between them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "intra_wave.cuh"

namespace {

using namespace media_intra;

constexpr int kThreads = 256;

template <bool kI4>
__global__ void __launch_bounds__(kThreads)
    intra_encode_kernel(EncArgs a, int k, int first_row) {
  __shared__ Smem s;
  const int r = first_row + blockIdx.x;
  mb_intra_encode<kI4>(a, r, k - (kI4 ? 2 : 1) * r, s, threadIdx.x,
                       blockDim.x);
}

template <bool kI4>
__global__ void __launch_bounds__(kThreads)
    intra_recon_kernel(RecArgs a, int k, int first_row) {
  __shared__ Smem s;
  const int r = first_row + blockIdx.x;
  mb_intra_recon<kI4>(a, r, k - (kI4 ? 2 : 1) * r, s, threadIdx.x,
                      blockDim.x);
}

// One launch a wave, in wave order, on `stream`. With skew 2 and one MB
// column the odd waves hold no MB and launch nothing.
template <typename Args>
int launch_waves(void (*kernel)(Args, int, int), const Args& a, int skew,
                 void* stream) {
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  for (int k = 0; k < n_waves(a.R, a.C, skew); ++k) {
    const int lo = wave_first_row(k, a.C, skew);
    const int n = wave_last_row(k, a.R, skew) - lo + 1;
    if (n <= 0) continue;
    kernel<<<(unsigned)n, kThreads, 0, cs>>>(a, k, lo);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

bool bad_qp(int qp) { return qp < 0 || qp > 51; }

}  // namespace

// The IDR of an (R, C) MB grid; see intra_wave.cuh's EncArgs (device
// memory; strides: the three planes' row strides). Enqueues R + C - 1
// kernels (2 (R - 1) + C with i4x4) on `stream`; returns a cudaError_t.
extern "C" int intra_encode_launch(
    const int32_t* y, const int32_t* u, const int32_t* v,
    const int64_t* strides, const uint8_t* has_top, int qp, int qp_c,
    const int32_t* mf, const int32_t* vt, const int64_t* zz,
    const int32_t* taps, int32_t* mode16, int32_t* chroma_mode, int32_t* dc,
    int32_t* ac, int32_t* cdc, int32_t* cac, uint8_t* is_i4, int32_t* modes4,
    int32_t* luma4, uint8_t* recon_y, uint8_t* recon_u, uint8_t* recon_v,
    int R, int C, int i4x4, void* stream) {
  if (R <= 0 || C <= 0 || bad_qp(qp) || bad_qp(qp_c))
    return (int)cudaErrorInvalidValue;
  const EncArgs a{y, u, v, strides[0], strides[1], strides[2], has_top, qp,
                  qp_c, mf, vt, zz, taps, mode16, chroma_mode, dc, ac, cdc,
                  cac, is_i4, modes4, luma4, recon_y, recon_u, recon_v, R, C};
  return i4x4 ? launch_waves(intra_encode_kernel<true>, a, 2, stream)
              : launch_waves(intra_encode_kernel<false>, a, 1, stream);
}

// The reconstruction of an I picture of (R, C) MBs from its modes and
// levels; see intra_wave.cuh's RecArgs (device memory; is_i4, modes4, luma4
// null for a picture with no I_4x4 MB). Enqueues R + C - 1 kernels
// (2 (R - 1) + C with I_4x4 MBs) on `stream`; returns a cudaError_t.
extern "C" int intra_recon_launch(
    const int32_t* mode16, const int32_t* chroma_mode, const int32_t* dc,
    const int32_t* ac, const int32_t* cdc, const int32_t* cac,
    const uint8_t* is_i4, const int32_t* modes4, const int32_t* luma4,
    const uint8_t* has_top, int qp, int qp_c, const int32_t* mf,
    const int32_t* vt, const int64_t* zz, const int32_t* taps,
    uint8_t* recon_y, uint8_t* recon_u, uint8_t* recon_v, int R, int C,
    void* stream) {
  if (R <= 0 || C <= 0 || bad_qp(qp) || bad_qp(qp_c))
    return (int)cudaErrorInvalidValue;
  const RecArgs a{mode16, chroma_mode, dc,  ac,      cdc,     cac,
                  is_i4,  modes4,      luma4, has_top, qp,      qp_c,
                  mf,     vt,          zz,  taps,    recon_y, recon_u,
                  recon_v, R,          C};
  return is_i4 ? launch_waves(intra_recon_kernel<true>, a, 2, stream)
               : launch_waves(intra_recon_kernel<false>, a, 1, stream);
}
