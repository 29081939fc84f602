// On-device CAVLC packing of one P slice (spec 9.2, 7.3.4-7.3.5), for sm_90a.
//
// Replaces the packer that the JAX package compiles with XLA,
// media_tpu/entropy/device_cavlc.py:pack_pslice_device (no Pallas kernel:
// XLA fuses it into the P batch's program), whose plain PyTorch twin is
// media_tpu_torch/entropy/device_cavlc.py:pack_pslice_plain. That twin runs
// as some 4500 eager launches a 1080p frame; this is four launches and two
// memsets. The arithmetic per MB and per chunk is device_cavlc.cuh's.
//
// Bound on the card: bytes. The packer reads the int32 symbols once (386
// a MB, 12.6 MB at 1080p) and writes a stream of at most a few hundred KB;
// its integer work is a few thousand operations a MB. The design is the
// simple one, one thread per MB or per chunk:
//   1. mb_meta_kernel, a thread per MB: nnz of every block, coded block
//      pattern, the MV prediction and the skip decision;
//   2. mb_scan_kernel, one block: the raster scans over MBs, i.e. each coded
//      MB's mb_skip_run, the trailing skip run, and with a QP map the
//      running QP that mb_qp_delta is coded against (seeded with the slice
//      QP, read on the device);
//   3. chunk_bits_kernel, a thread per chunk in tiles of 512 chunks: each
//      chunk's bit count from its codewords, and each tile's sum;
//   4. chunk_write_kernel, the same tiles: an exclusive scan of the tile's
//      bit counts (with the sums of the tiles before it) gives every
//      chunk's place in the reference's 8-ary bitcat tree, whose capacity
//      schedule decides overflow exactly as the reference does; each chunk
//      then produces its codewords again and ORs them into the zeroed
//      stream at its offset (chunks share at most their boundary words, so
//      the ORs commute); the last tile to finish writes total_bits.
// A tile is one node of level 3 of the tree, so the tree's levels 1-3 lie
// inside a tile and levels 4 and up are whole tiles.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_cavlc.cuh"

namespace {

using namespace media_cavlc;

constexpr int kMetaThreads = 128;
constexpr int kScanThreads = 1024;
constexpr int kAcc = 2 + 2 * (kMaxLevels - 3);  // tile prefixes a tile needs

struct Control {
  int fail;           // some group of the tree overflowed its capacity
  unsigned int done;  // tiles finished (the last one writes total_bits)
};

struct AtomicOr {
  MTPU_HD void operator()(uint64_t* word, uint32_t bits) const {
#ifdef __CUDA_ARCH__
    atomicOr(reinterpret_cast<unsigned long long*>(word),
             (unsigned long long)bits);
#endif
  }
};

// A chunk's prefix at level L of the tree (see place): the bits before its
// ancestor inside that ancestor's group of 8. Levels 1-3 from the scan
// inside the tile, levels above from the prefixes of the tile sums.
struct TilePrefix {
  const long long* eloc;  // exclusive prefix of the chunk bits in the tile
  const long long* pre;   // see chunk_write_kernel
  int l;                  // the chunk's index in the tile
  MTPU_HD int64_t operator()(int L) const {
    if (L <= kTileLog8) {
      const int a0 = (l >> (3 * (L - 1))) << (3 * (L - 1));
      const int g0 = (l >> (3 * L)) << (3 * L);
      return eloc[a0] - eloc[g0];
    }
    return (L == 4 ? pre[0] : pre[1 + L - 5]) - pre[1 + L - 4];
  }
};

// Exclusive scan over the block under an associative op; *total gets the
// reduction over the whole block. blockDim.x is a multiple of 32.
template <typename T, typename Op>
__device__ T block_exclusive_scan(T v, T id, Op op, T* warp_tot, T* total) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  T x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x = op(y, x);
  }
  if (lane == 31) warp_tot[wid] = x;
  __syncthreads();
  if (wid == 0) {
    T w = lane < nw ? warp_tot[lane] : id;
    for (int d = 1; d < 32; d <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w = op(y, w);
    }
    if (lane < nw) warp_tot[lane] = w;
  }
  __syncthreads();
  const T before = wid > 0 ? warp_tot[wid - 1] : id;
  const T left = __shfl_up_sync(0xffffffffu, x, 1);
  const T out = lane > 0 ? op(before, left) : before;
  *total = warp_tot[nw - 1];
  __syncthreads();
  return out;
}

struct MaxOp {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};
struct SumOp {
  __device__ long long operator()(long long a, long long b) const {
    return a + b;
  }
};

__global__ void __launch_bounds__(kMetaThreads)
    mb_meta_kernel(Symbols s, Tables t, MbState st) {
  const int mb = blockIdx.x * kMetaThreads + threadIdx.x;
  if (mb < s.R * s.C) mb_metadata(s, t, mb, st);
}

// Each thread takes a contiguous run of MBs: the last coded and the last
// coded-with-cbp MB of the runs before it come from a block max-scan.
__global__ void __launch_bounds__(kScanThreads)
    mb_scan_kernel(Symbols s, MbState st) {
  __shared__ int warp_tot[32];
  const int n = s.R * s.C;
  const int per = (n + kScanThreads - 1) / kScanThreads;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  int last = -1, last_cbp = -1;
  for (int i = lo; i < hi; ++i) {
    const int info = st.info[i];
    if (!(info & 64)) {
      last = i;
      if (info & 63) last_cbp = i;
    }
  }
  int last_all, unused;
  int prev = block_exclusive_scan(last, -1, MaxOp(), warp_tot, &last_all);
  int prev_cbp =
      block_exclusive_scan(last_cbp, -1, MaxOp(), warp_tot, &unused);
  const int seed = s.qp_map ? slice_qp_of(s) : 0;
  for (int i = lo; i < hi; ++i) {
    const int info = st.info[i];
    st.skip_run[i] = i - prev - 1;
    if (s.qp_map)
      st.qp_delta[i] =
          qp_delta_of(s.qp_map[i], prev_cbp >= 0 ? s.qp_map[prev_cbp] : seed);
    if (!(info & 64)) {
      prev = i;
      if (info & 63) prev_cbp = i;
    }
  }
  if (threadIdx.x == 0) *st.trailing = n - 1 - last_all;
}

__global__ void __launch_bounds__(kTile)
    chunk_bits_kernel(Symbols s, Tables t, MbState st, int* cbits,
                      long long* tile_sum) {
  __shared__ long long warp_tot[32];
  const int64_t n_chunks = (int64_t)kChunksPerMb * s.R * s.C + 1;
  const int64_t ch = (int64_t)blockIdx.x * kTile + threadIdx.x;
  Count count;
  if (ch < n_chunks) {
    chunk_codes(s, t, st, ch, count);
    cbits[ch] = count.bits;
  }
  long long total;
  block_exclusive_scan((long long)count.bits, 0LL, SumOp(), warp_tot, &total);
  if (threadIdx.x == 0) tile_sum[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kTile)
    chunk_write_kernel(Symbols s, Tables t, MbState st, Schedule sc,
                       const int* cbits, const long long* tile_sum,
                       Control* ctl, uint64_t* out, int64_t* total_bits) {
  __shared__ long long warp_tot[32];
  __shared__ long long eloc[kTile + 1];  // exclusive prefix inside the tile
  __shared__ long long part[kAcc][kTile / 32];
  __shared__ long long pre[kAcc];  // prefixes of the tile sums
  __shared__ bool last_tile;
  const int64_t n_chunks = (int64_t)kChunksPerMb * s.R * s.C + 1;
  const int n_tiles = gridDim.x, tile = blockIdx.x, l = threadIdx.x;
  const int64_t ch = (int64_t)tile * kTile + l;
  const int bits = ch < n_chunks ? cbits[ch] : 0;

  long long tile_bits;
  eloc[l] = block_exclusive_scan((long long)bits, 0LL, SumOp(), warp_tot,
                                 &tile_bits);
  if (l == 0) eloc[kTile] = tile_bits;

  // Tile indices whose prefix (the bits of all tiles before it) this tile
  // needs: its own; for each level L >= 4 the first tile of its group
  // (index 1 + L - 4) and the end of that group (index kMaxLevels - 2 +
  // L - 4); and the end of the slice (last index).
  int idx[kAcc];
  idx[0] = tile;
  for (int L = 4; L < kMaxLevels + 1; ++L) {
    const int sh = 3 * (L - 3);
    const int first = L <= sc.levels ? (tile >> sh) << sh : 0;
    const int64_t end = first + (1LL << sh);
    idx[1 + L - 4] = first;
    idx[kMaxLevels - 2 + L - 4] =
        L <= sc.levels ? (int)(end < n_tiles ? end : n_tiles) : 0;
  }
  idx[kAcc - 1] = n_tiles;
  long long acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0;
  for (int j = l; j < n_tiles; j += kTile) {
    const long long v = tile_sum[j];
#pragma unroll
    for (int a = 0; a < kAcc; ++a) acc[a] += j < idx[a] ? v : 0;
  }
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    long long x = acc[a];
    for (int d = 16; d > 0; d >>= 1) x += __shfl_down_sync(0xffffffffu, x, d);
    if ((l & 31) == 0) part[a][l >> 5] = x;
  }
  __syncthreads();
  if (l < kAcc) {
    long long x = 0;
    for (int w = 0; w < kTile / 32; ++w) x += part[l][w];
    pre[l] = x;
  }
  __syncthreads();

  if (bits > 0) {
    int64_t shift, keep;
    place(sc, slot_bits_of(s, ch), bits, TilePrefix{eloc, pre, l}, &shift,
          &keep);
    if (keep > 0) {
      Writer<AtomicOr> w{out, shift, keep, AtomicOr()};
      chunk_codes(s, t, st, ch, w);
      w.flush();
    }
  }

  // Overflow: a group of the tree holds more bits than its level's
  // capacity. Groups of levels 1-3 lie in the tile; each group of a level
  // above is checked by its first tile.
  bool fail = false;
  for (int L = 1; L <= kTileLog8 && L <= sc.levels; ++L) {
    const int g = 1 << (3 * L);
    if ((l & (g - 1)) == 0 &&
        eloc[l + g < kTile ? l + g : kTile] - eloc[l] > sc.cap_bits[L - 1])
      fail = true;
  }
  if (l == 0) {
    for (int L = 4; L <= sc.levels; ++L)
      if (idx[1 + L - 4] == tile &&
          pre[kMaxLevels - 2 + L - 4] - pre[0] > sc.cap_bits[L - 1])
        fail = true;
  }
  fail = __syncthreads_or(fail);
  if (l == 0) {
    if (fail) atomicOr(&ctl->fail, 1);
    __threadfence();
    last_tile = atomicAdd(&ctl->done, 1u) == (unsigned)n_tiles - 1;
  }
  __syncthreads();
  if (last_tile && l == 0) {
    __threadfence();
    const int any = atomicOr(&ctl->fail, 0);
    *total_bits = any ? sc.out_bits + 1 : pre[kAcc - 1];
  }
}

size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// The scratch of one call, carved from one buffer.
struct Layout {
  size_t ctl, tile_sum, cbits, info, mvd, skip_run, qp_delta, trailing, nnz,
      bytes;
  Layout(int64_t n, int64_t n_chunks, int64_t n_tiles) {
    size_t at = 0;
    auto take = [&](size_t b) {
      const size_t off = at;
      at = align16(at + b);
      return off;
    };
    ctl = take(sizeof(Control));
    tile_sum = take(8 * n_tiles);
    cbits = take(4 * n_chunks);
    info = take(4 * n);
    mvd = take(8 * n);
    skip_run = take(4 * n);
    qp_delta = take(4 * n);
    trailing = take(4);
    nnz = take(24 * n);
    bytes = at;
  }
};

int64_t chunks_of(int R, int C) { return (int64_t)kChunksPerMb * R * C + 1; }
int64_t tiles_of(int R, int C) { return (chunks_of(R, C) + kTile - 1) / kTile; }

}  // namespace

// Bytes of scratch device_cavlc_launch needs for an R x C slice.
extern "C" long long device_cavlc_scratch_bytes(int R, int C) {
  return (long long)Layout((int64_t)R * C, chunks_of(R, C), tiles_of(R, C))
      .bytes;
}

// Pack one P slice. Device pointers: the four int32 symbol tensors (MB
// strides in `strides`), the (R*C) int32 QP map or null, the int32 slice QP
// or null (then slice_qp_value), the tables, the (out_words) int64 stream
// and the int64 total_bits, and `scratch` of device_cavlc_scratch_bytes.
// Host arrays as symbols_of, tables_of and schedule_of take them (caps and
// wraps from device_cavlc.py:bitcat_schedule). Enqueues two memsets and
// four kernels on `stream`; returns a cudaError_t.
extern "C" int device_cavlc_launch(
    const int32_t* mv, const int32_t* luma, const int32_t* cdc,
    const int32_t* cac, const int64_t* strides, const int32_t* qp_map,
    const int32_t* slice_qp, int slice_qp_value, const void* const* tables,
    int levels, const int64_t* caps, const int64_t* wraps, int64_t* out,
    long long out_words, int64_t* total_bits, void* scratch, int R, int C,
    void* stream) {
  if (R <= 0 || C <= 0 || levels < 1 || levels > kMaxLevels || out_words < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int64_t n = (int64_t)R * C, n_chunks = chunks_of(R, C);
  const int64_t n_tiles = tiles_of(R, C);
  const Layout lay(n, n_chunks, n_tiles);
  char* base = static_cast<char*>(scratch);
  const Symbols s = symbols_of(mv, luma, cdc, cac, strides, qp_map, slice_qp,
                               slice_qp_value, R, C);
  const Tables t = tables_of(tables);
  const Schedule sc = schedule_of(levels, caps, wraps, out_words);
  MbState st{reinterpret_cast<int32_t*>(base + lay.info),
             reinterpret_cast<int32_t*>(base + lay.mvd),
             reinterpret_cast<uint8_t*>(base + lay.nnz),
             reinterpret_cast<int32_t*>(base + lay.skip_run),
             reinterpret_cast<int32_t*>(base + lay.qp_delta),
             reinterpret_cast<int32_t*>(base + lay.trailing)};
  Control* ctl = reinterpret_cast<Control*>(base + lay.ctl);
  int* cbits = reinterpret_cast<int*>(base + lay.cbits);
  long long* tile_sum = reinterpret_cast<long long*>(base + lay.tile_sum);

  cudaError_t err = cudaMemsetAsync(out, 0, 8 * out_words, cs);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(ctl, 0, sizeof(Control), cs);
  if (err != cudaSuccess) return (int)err;
  mb_meta_kernel<<<(unsigned)((n + kMetaThreads - 1) / kMetaThreads),
                   kMetaThreads, 0, cs>>>(s, t, st);
  mb_scan_kernel<<<1, kScanThreads, 0, cs>>>(s, st);
  chunk_bits_kernel<<<(unsigned)n_tiles, kTile, 0, cs>>>(s, t, st, cbits,
                                                         tile_sum);
  chunk_write_kernel<<<(unsigned)n_tiles, kTile, 0, cs>>>(
      s, t, st, sc, cbits, tile_sum, ctl, reinterpret_cast<uint64_t*>(out),
      total_bits);
  return (int)cudaGetLastError();
}
