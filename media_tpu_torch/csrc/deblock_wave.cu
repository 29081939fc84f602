// Whole-frame H.264 in-loop deblocking (spec 8.7) in one launch, for sm_90a.
//
// Replaces media_tpu/ops/deblock_wave_pallas.py:deblock_wavemajor_pallas.
// It computes the same function as its plain PyTorch twin,
// media_tpu_torch/ops/deblock_wave.py:deblock_wave_plain: uint8 planes
// filtered in place, given a per-MB meta row of 120 int32 (bS, tc0 and
// alpha/beta per edge; layout in ops/deblock.py:META_COLS).
//
// Bound: the chain of dependent macroblock steps, not bytes (a 1080p frame
// and its meta are 10 MB, 3 us of memory time) or arithmetic. MB (r, c)
// filters its own 16x16 block, the 3 columns left of it and the 3 rows above
// it, so it needs (r, c-1), (r-1, c) and (r-1, c+1) finished: 2R+C-2 steps
// in a row (254 at 1080p) that H.264 does not let anybody shorten. The
// design makes one step of that chain short and takes the rest off it.
//
// Design: a dataflow wavefront, one thread block per MB row, all rows in
// flight. Block r walks row r left to right. A block is two warps that never
// meet: warp 0 filters luma, warp 1 both chroma planes (luma and chroma do
// not interact), so every barrier is a __syncwarp(). Per MB a warp
//   1. has the MB's own 16x16 (8x8) samples and its meta row already in
//      shared memory: nobody writes them before this step, so they are
//      brought in kStages - 1 steps ahead with cp.async into a ring of
//      20x20 / 12x12 patches (own samples at [4:, 4:]);
//   2. takes the patch's left 4 columns from its own previous step, shared
//      memory to shared memory;
//   3. filters the vertical edges, one thread per sample row (they need
//      nothing of the row above, so they run before the wait, and behind a
//      first look at the mailbox whose round trip to L2 they hide);
//   4. waits for the sample rows above the MB, which row r-1 hands over
//      (below): the one wait on the chain;
//   5. filters the horizontal edges, one thread per sample column;
//   6. hands its own last sample rows on to row r+1, and stores what is
//      final to the planes.
//
// The hand-over, and the progress rule. A step's horizontal edges read the
// last 4 (chroma: 2) sample rows of MB row r-1 and change up to 3 (1) of
// them. Block r-1 does not store those rows to the planes at all: it passes
// them to block r through a mailbox in device memory, and block r stores
// them once it has filtered them, so every sample of the planes has one
// writer and no block reads a plane sample that another block wrote. A
// mailbox slot is 8 bytes: 4 samples and a tag, written with one 8-byte
// store and polled with 8-byte loads (st/ld.relaxed.gpu, single-copy atomic,
// served by L2: L1 is not coherent between SMs), so the samples have arrived
// when the tag has, without a fence and without a flag. After step (r, c)
// block r hands over sample columns 16c-4 .. 16c+11 (the last 4 columns of
// an MB are final only after step (r, c+1) has filtered the MB's right
// edge; the last MB of a row hands them over too). Step (r, c) needs columns
// 16c .. 16c+15 of the rows above, so it can run once row r-1 has finished
// MB c+1, or its whole row where c is the last column: each lane simply
// polls the slot it needs. The reader empties a slot after reading it, and
// every slot is written once and read once per launch, so the mailbox is
// all zero again when the launch ends; it is scratch that the caller
// provides (zero before the first launch) and nothing resets it on the host.
// The plane pointers carry neither const nor __restrict__.
//
// A grid that does not fit is serialised, not refused and never hung: the
// launch takes G = min(R, resident blocks the device can hold) persistent
// blocks, and block b filters rows b, b+G, b+2G, ... in ascending order. Row
// r waits only for row r-1, and the lowest unfinished row always belongs to
// a resident block that has finished all its earlier rows, so it always
// advances. A wait that sees nothing arrive for kSpinLimit polls traps
// instead of hanging the device.
//
// kFilter = false compiles the same kernel without the edge filters: the
// hand-overs, loads and stores alone, the floor that the dependent chain
// sets for this design.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "deblock_filters.cuh"

namespace {

using media_deblock::chroma_horizontal;
using media_deblock::chroma_vertical;
using media_deblock::kChroma;
using media_deblock::kLuma;
using media_deblock::kMetaCols;
using media_deblock::luma_horizontal;
using media_deblock::luma_vertical;

constexpr int kThreads = 64;       // warp 0: luma, warp 1: chroma
constexpr int kStages = 4;         // patches in the ring; kStages - 1 ahead
constexpr int kSpinLimit = 1 << 24;
constexpr int kLumaWords = kLuma / 4, kChromaWords = kChroma / 4;
constexpr int kLumaHand = 4, kChromaHand = 2;  // sample rows handed down
constexpr int kMaxDevices = 64;

struct alignas(16) LumaStage {
  uint8_t patch[kLuma * kLuma];
  int meta[kMetaCols];  // columns 0-63 and 96-111 are filled
};

struct alignas(16) ChromaStage {
  uint8_t patch[2][kChroma * kChroma];  // U, V
  int meta[kMetaCols];  // columns 64-95 and 112-119 are filled
};

__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One mailbox slot: 4 samples in the low word, the tag 1 in the high word.
__device__ __forceinline__ void hand_over(unsigned long long* slot,
                                          uint32_t samples) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(slot),
               "l"(1ull << 32 | samples)
               : "memory");
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* slot) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(slot)
               : "memory");
  return v;
}

// Wait for a slot, take its 4 samples and leave it empty. `v` is an earlier
// look at the slot: where the samples were there already (the row above is
// far ahead), the load's round trip to L2 was hidden behind the work between
// the look and this call.
__device__ __forceinline__ uint32_t take_over(unsigned long long* slot,
                                              unsigned long long v) {
  for (int spins = 0; (v >> 32) == 0; v = peek(slot))
    if (++spins > kSpinLimit) __trap();
  *slot = 0;
  return static_cast<uint32_t>(v);
}

// Warp 0: the luma plane of MB row r. mail: R rows of kLumaHand sample rows
// of 4C slots.
template <bool kFilter>
__device__ void luma_row(uint8_t* y, const int* meta, unsigned long long* mail,
                         int r, int R, int C, LumaStage* ring, int lane) {
  const int wy = 16 * C;
  uint8_t* own = y + static_cast<size_t>(16 * r) * wy;  // first own row
  unsigned long long* outbox =
      mail + static_cast<size_t>(r) * kLumaHand * 4 * C;
  unsigned long long* inbox = outbox - kLumaHand * 4 * C;  // of row r-1
  const bool last_row = r + 1 == R;
  const int own_rows = last_row ? 16 : 16 - kLumaHand;  // stored by this row

  auto prefetch = [&](int c) {
    if (c < C) {
      LumaStage& s = ring[c % kStages];
      for (int i = lane; i < 16 * 4; i += 32) {  // 16 rows of 4 words
        const int row = i >> 2, w = i & 3;
        cp_async_4(s.patch + (4 + row) * kLuma + 4 + 4 * w,
                   own + row * wy + 16 * c + 4 * w);
      }
      if (lane < 20) {  // meta columns 0-63 and 96-111, 16 bytes each
        const int i = lane < 16 ? 4 * lane : 96 + 4 * (lane - 16);
        cp_async_16(s.meta + i,
                    meta + static_cast<size_t>(r * C + c) * kMetaCols + i);
      }
    }
    cp_async_commit();  // one group per step, empty past the row's end
  };

  for (int c = 0; c < kStages - 1; ++c) prefetch(c);
  for (int c = 0; c < C; ++c) {
    prefetch(c + kStages - 1);
    cp_async_wait<kStages - 1>();  // this lane's copies of step c landed
    __syncwarp();                  // ... and every other lane's
    LumaStage& s = ring[c % kStages];
    uint32_t* words = reinterpret_cast<uint32_t*>(s.patch);
    const int i4 = lane >> 2, j4 = lane & 3;  // 4 sample rows of 4 words

    // The 4 rows above the MB, columns 16c .. 16c+15: one slot per lane.
    unsigned long long* slot = inbox + i4 * 4 * C + 4 * c + j4;
    const bool takes = r > 0 && lane < 16;
    const unsigned long long early = takes ? peek(slot) : 0;
    if (kFilter && lane < 16) luma_vertical(s.patch, s.meta, lane, c > 0);
    if (takes) words[i4 * kLumaWords + 1 + j4] = take_over(slot, early);
    __syncwarp();
    if (kFilter && lane < 16) luma_horizontal(s.patch, s.meta, lane, r > 0);
    __syncwarp();

    // Columns 16c-4 .. 16c+11 of the own rows are final for this row (from
    // 16c in the first MB of the row, up to 16c+15 in the last): the last
    // rows go to the next row's block, the others to the plane.
    const int w0 = c > 0 ? 0 : 1, w1 = c == C - 1 ? 5 : 4;
    if (!last_row && lane < 4 * kLumaWords) {
      const int row = lane / kLumaWords, w = lane % kLumaWords;
      if (w >= w0 && w < w1)
        hand_over(outbox + row * 4 * C + 4 * c - 1 + w,
                  words[(4 + own_rows + row) * kLumaWords + w]);
    }
    for (int i = lane; i < own_rows * kLumaWords; i += 32) {
      const int row = i / kLumaWords, w = i % kLumaWords;
      if (w >= w0 && w < w1)
        *reinterpret_cast<uint32_t*>(own + row * wy + 16 * c - 4 + 4 * w) =
            words[(4 + row) * kLumaWords + w];
    }
    if (r > 0 && lane < 16)  // the 4 rows above, columns 16c .. 16c+15
      *reinterpret_cast<uint32_t*>(own - (4 - i4) * wy + 16 * c + 4 * j4) =
          words[i4 * kLumaWords + 1 + j4];
    if (c + 1 < C && lane < 16)  // the last 4 columns go on to the next step
      reinterpret_cast<uint32_t*>(
          ring[(c + 1) % kStages].patch)[(4 + lane) * kLumaWords] =
          words[(4 + lane) * kLumaWords + 4];
    __syncwarp();
  }
}

// Warp 1: the two chroma planes of MB row r. Filter lanes 0-7 are the lines
// of U, 8-15 those of V. mail: 2 planes of R rows of kChromaHand sample rows
// of 2C slots.
template <bool kFilter>
__device__ void chroma_row(uint8_t* u, uint8_t* v, const int* meta,
                           unsigned long long* mail, int r, int R, int C,
                           ChromaStage* ring, int lane) {
  const int wc = 8 * C;
  const size_t first = static_cast<size_t>(8 * r) * wc;  // first own row
  const size_t plane_mail = static_cast<size_t>(R) * kChromaHand * 2 * C;
  const bool last_row = r + 1 == R;
  const int own_rows = last_row ? 8 : 8 - kChromaHand;  // stored by this row
  auto own = [&](int p) { return (p ? v : u) + first; };
  auto outbox = [&](int p) {
    return mail + p * plane_mail +
           static_cast<size_t>(r) * kChromaHand * 2 * C;
  };
  auto inbox = [&](int p) {  // the outbox of row r-1
    return outbox(p) - kChromaHand * 2 * C;
  };

  auto prefetch = [&](int c) {
    if (c < C) {
      ChromaStage& s = ring[c % kStages];
      {  // 2 planes of 8 rows of 2 words: one word per lane
        const int p = lane >> 4, row = (lane >> 1) & 7, w = lane & 1;
        cp_async_4(s.patch[p] + (4 + row) * kChroma + 4 + 4 * w,
                   own(p) + row * wc + 8 * c + 4 * w);
      }
      if (lane < 10) {  // meta columns 64-95 and 112-119, 16 bytes each
        const int i = lane < 8 ? 64 + 4 * lane : 112 + 4 * (lane - 8);
        cp_async_16(s.meta + i,
                    meta + static_cast<size_t>(r * C + c) * kMetaCols + i);
      }
    }
    cp_async_commit();
  };

  for (int c = 0; c < kStages - 1; ++c) prefetch(c);
  for (int c = 0; c < C; ++c) {
    prefetch(c + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncwarp();
    ChromaStage& s = ring[c % kStages];
    const int fp = (lane >> 3) & 1, cl = lane & 7;  // filter plane and line
    // 2 planes of 2 sample rows of 2 words, for the rows handed over.
    const int hp = (lane >> 2) & 1, hi = (lane >> 1) & 1, hj = lane & 1;
    uint32_t* hwords = reinterpret_cast<uint32_t*>(s.patch[hp]);

    // The 2 rows above the MB, columns 8c .. 8c+7: one slot per lane.
    unsigned long long* slot = inbox(hp) + hi * 2 * C + 2 * c + hj;
    const bool takes = r > 0 && lane < 8;
    const unsigned long long early = takes ? peek(slot) : 0;
    if (kFilter && lane < 16) chroma_vertical(s.patch[fp], s.meta, cl, c > 0);
    if (takes)
      hwords[(2 + hi) * kChromaWords + 1 + hj] = take_over(slot, early);
    __syncwarp();
    if (kFilter && lane < 16)
      chroma_horizontal(s.patch[fp], s.meta, cl, r > 0);
    __syncwarp();

    // Columns 8c-4 .. 8c+3 of the own rows are final for this row (from 8c
    // in the first MB of the row, up to 8c+7 in the last).
    const int w0 = c > 0 ? 0 : 1, w1 = c == C - 1 ? 3 : 2;
    if (!last_row && lane < 2 * kChromaHand * kChromaWords) {
      const int p = lane / (kChromaHand * kChromaWords);
      const int row = lane / kChromaWords % kChromaHand;
      const int w = lane % kChromaWords;
      if (w >= w0 && w < w1)
        hand_over(outbox(p) + row * 2 * C + 2 * c - 1 + w,
                  reinterpret_cast<const uint32_t*>(
                      s.patch[p])[(4 + own_rows + row) * kChromaWords + w]);
    }
    for (int i = lane; i < 2 * own_rows * kChromaWords; i += 32) {
      const int p = i / (own_rows * kChromaWords);
      const int row = i / kChromaWords % own_rows, w = i % kChromaWords;
      if (w >= w0 && w < w1)
        *reinterpret_cast<uint32_t*>(own(p) + row * wc + 8 * c - 4 + 4 * w) =
            reinterpret_cast<const uint32_t*>(
                s.patch[p])[(4 + row) * kChromaWords + w];
    }
    if (r > 0 && lane < 8)  // the 2 rows above, columns 8c .. 8c+7
      *reinterpret_cast<uint32_t*>(own(hp) - (2 - hi) * wc + 8 * c + 4 * hj) =
          hwords[(2 + hi) * kChromaWords + 1 + hj];
    if (c + 1 < C && lane < 16)  // the last 4 columns go on to the next step
      reinterpret_cast<uint32_t*>(
          ring[(c + 1) % kStages].patch[fp])[(4 + cl) * kChromaWords] =
          reinterpret_cast<const uint32_t*>(
              s.patch[fp])[(4 + cl) * kChromaWords + 2];
    __syncwarp();
  }
}

template <bool kFilter>
__global__ void __launch_bounds__(kThreads)
deblock_wave_kernel(uint8_t* y, uint8_t* u, uint8_t* v, const int* meta,
                    unsigned long long* mail, int R, int C) {
  __shared__ LumaStage luma_ring[kStages];
  __shared__ ChromaStage chroma_ring[kStages];
  const int lane = threadIdx.x & 31;
  unsigned long long* chroma_mail =
      mail + static_cast<size_t>(R) * kLumaHand * 4 * C;
  for (int r = blockIdx.x; r < R; r += gridDim.x) {
    if (threadIdx.x < 32)
      luma_row<kFilter>(y, meta, mail, r, R, C, luma_ring, lane);
    else
      chroma_row<kFilter>(u, v, meta, chroma_mail, r, R, C, chroma_ring,
                          lane);
  }
}

// Blocks of the kernel that the current device holds at once.
template <bool kFilter>
cudaError_t resident_blocks(int* blocks) {
  static int cache[kMaxDevices] = {};
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cache[dev] > 0) {
    *blocks = cache[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, deblock_wave_kernel<kFilter>, kThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = sms * per_sm;
  if (dev < kMaxDevices) cache[dev] = *blocks;
  return cudaSuccess;
}

template <bool kFilter>
int launch(uint8_t* y, uint8_t* u, uint8_t* v, const int32_t* meta,
           unsigned long long* mail, int R, int C, int max_blocks,
           cudaStream_t stream) {
  int blocks = 0;
  const cudaError_t err = resident_blocks<kFilter>(&blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (max_blocks > 0) blocks = std::min(blocks, max_blocks);
  if (blocks < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  deblock_wave_kernel<kFilter><<<std::min(R, blocks), kThreads, 0, stream>>>(
      y, u, v, meta, mail, R, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mail: 24 * R * C slots of 8 bytes of scratch (per MB row, luma 4 sample
// rows of 4C slots and each chroma plane 2 sample rows of 2C slots), zero at
// the first launch (the kernel leaves them zero). filter = 0 runs
// the hand-overs, loads and stores without the edge filters. max_blocks > 0
// caps the grid below what the device holds (rows are then shared out among
// fewer persistent blocks).
extern "C" int deblock_wave_launch(uint8_t* y, uint8_t* u, uint8_t* v,
                                   const int32_t* meta, void* mail, int R,
                                   int C, int filter, int max_blocks,
                                   void* stream) {
  if (R <= 0 || C <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* m = static_cast<unsigned long long*>(mail);
  return filter ? launch<true>(y, u, v, meta, m, R, C, max_blocks, s)
                : launch<false>(y, u, v, meta, m, R, C, max_blocks, s);
}

extern "C" const char* media_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
