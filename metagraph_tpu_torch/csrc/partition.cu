// Stable partition (compaction) of packed uint32 lanes by a keep mask,
// for any number of lanes L.
//
// Replaces the Pallas kernel metagraph_tpu/common/merge.py:634
// _partition_call / _make_partition_kernel (reached from
// partition_compact), which takes any L too. Semantics: every kept entry
// moves to the front in its original order; lanes past the count are PAD
// (0xFFFFFFFF) and payloads past it are `extra_fill`; entries at or past
// `capacity` are dropped, while the count written back is the TRUE count.
//
// What bounds it on the card: memory bandwidth. It reads (L+E)*4*N + N
// bytes and writes (L+E)*4*capacity bytes, with no arithmetic to speak
// of. The design streams every array once, coalesced, in ONE launch
// whatever L is:
//   * tiles are taken in order (lookback.cuh); a tile reads its keep
//     bytes once, 16 per thread in one 16-byte load, counts them, ranks
//     them by a block scan and keeps each entry's rank in shared memory;
//   * a one-bin decoupled look-back (one warp reads 32 earlier tiles at a
//     time) gives the kept entries of the earlier tiles, so kept entry i
//     goes to (that prefix) + (its rank);
//   * then the L lanes and E payloads pass through two shared stages of
//     a word a slot, one array at a time: the tile's kept entries gather
//     there in their compacted order by asynchronous copies (cp.async)
//     and leave as one contiguous run. Array a + 1 is read into one
//     stage while array a leaves the other (one barrier an array), and
//     array 0's reads are in flight during the look-back. Shared memory
//     does not grow with L, and the mask, the scan and the look-back are
//     paid once for every lane;
//   * the tail needs no count: the dropped entries write PAD and
//     extra_fill from the end down, the tile's as one run ending at
//     n - (dropped entries of earlier tiles); together they cover
//     exactly [count, n);
//   * blocks past the last tile fill [n, capacity) when capacity > n;
//   * every write at or past capacity is skipped, and the last tile's
//     inclusive prefix is the count.
// The TPU kernel's bit-shift compaction rounds, MXU prefix matmul and
// SMEM carry existed because a TPU grid runs in order; CUDA blocks do
// not, so the order across tiles comes from the look-back instead.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;                   // keep bytes per thread
constexpr int kTile = kThreads * kItems;     // entries per tile

using mg::Word;

__global__ void __launch_bounds__(kThreads)
partition_kernel(const uint32_t* __restrict__ lanes, int L, long long n,
                 const uint8_t* __restrict__ keep,
                 const uint32_t* __restrict__ ex0,
                 const uint32_t* __restrict__ ex1, int n_extra,
                 uint32_t* __restrict__ out, uint32_t* __restrict__ oex0,
                 uint32_t* __restrict__ oex1, long long capacity,
                 uint32_t extra_fill, Word* __restrict__ status,
                 unsigned* __restrict__ counter, int* __restrict__ count_out,
                 long long tiles) {
  // kept entries: their rank in the tile; dropped: -1
  __shared__ short info[kTile];
  __shared__ uint32_t stage[2][kTile];
  __shared__ int scan[kThreads / 32 + 1];
  __shared__ long long kept_before;

  const unsigned tile = mg::take_tile(counter);
  if (tile >= tiles) {                       // fill [n, capacity)
    const long long p0 = n + (long long)(tile - tiles) * kTile;
    for (long long p = p0 + threadIdx.x; p < min(p0 + kTile, capacity);
         p += kThreads) {
      for (int j = 0; j < L; ++j) {
        out[(long long)j * capacity + p] = 0xFFFFFFFFu;
      }
      if (n_extra > 0) oex0[p] = extra_fill;
      if (n_extra > 1) oex1[p] = extra_fill;
    }
    return;
  }
  const long long base = (long long)tile * kTile;
  const int cnt = (int)min((long long)kTile, n - base);

  // this thread's keep bytes: entries [16 t, 16 t + 16) of the tile
  const int first = threadIdx.x * kItems;
  uint8_t kb[kItems];
  if (first + kItems <= cnt &&
      ((reinterpret_cast<uintptr_t>(keep + base) & 15) == 0)) {
    const uint4 v = *reinterpret_cast<const uint4*>(keep + base + first);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < kItems; ++j) kb[j] = (w[j / 4] >> (8 * (j % 4))) & 0xFF;
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      kb[j] = first + j < cnt ? keep[base + first + j] : 0;
    }
  }
  int c = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) c += kb[j] != 0;
  int tile_kept;
  int r = mg::block_exclusive_scan<kThreads>(c, scan, &tile_kept);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int p = first + j;
    if (p < cnt) info[p] = kb[j] ? (short)r++ : (short)-1;
  }
  if (threadIdx.x == 0) mg::publish(status, 1, tile, 0, tile_kept);
  __syncthreads();                           // info is complete
  const int tile_dropped = cnt - tile_kept;
  const int arrays = L + n_extra;
  // the kept entries of array a into stage[buf], in compacted order, by
  // asynchronous copies (the thread waits for them only before the write)
  auto gather = [&](int a, int buf) {
    const uint32_t* src =
        a < L ? lanes + (long long)a * n : (a == L ? ex0 : ex1);
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int p = threadIdx.x + it * kThreads;
      if (p < cnt && info[p] >= 0) {
        __pipeline_memcpy_async(&stage[buf][info[p]], src + base + p, 4);
      }
    }
    __pipeline_commit();
  };
  gather(0, 0);                              // in flight during the look-back
  if (threadIdx.x < 32) {                    // warp 0: the look-back
    const long long before = (long long)mg::lookback_warp(
        status, 1, tile, 0, (Word)tile_kept);
    if (threadIdx.x == 0) {
      kept_before = before;
      if (tile == tiles - 1) *count_out = (int)(before + tile_kept);
    }
  }
  // array by array, any number of lanes, two stage buffers: array a + 1
  // is read into one while array a leaves the other, its kept entries as
  // one contiguous run and its dropped entries' PAD / extra_fill as
  // another; one barrier an array
  for (int a = 0; a < arrays; ++a) {
    __pipeline_wait_prior(0);
    __syncthreads();     // array a staged; array a - 1's buffer drained
    if (a + 1 < arrays) gather(a + 1, (a + 1) & 1);
    const long long kept0 = kept_before;
    const long long dropped0 = base - kept0;
    uint32_t* dst = a < L ? out + (long long)a * capacity
                          : (a == L ? oex0 : oex1);
    const uint32_t fill = a < L ? 0xFFFFFFFFu : extra_fill;
    for (int k = threadIdx.x; k < tile_kept && kept0 + k < capacity;
         k += kThreads) {
      dst[kept0 + k] = stage[a & 1][k];
    }
    const long long d0 = n - dropped0 - tile_dropped;
    for (int k = threadIdx.x; k < tile_dropped && d0 + k < capacity;
         k += kThreads) {
      dst[d0 + k] = fill;
    }
  }
}

}  // namespace

// Entries per tile: the wrapper sizes the status words as
// ceil(n / tile) + 1 int64 (the look-back's, then the tile counter).
extern "C" int mg_partition_tile() { return kTile; }

// lanes (L, n) and payloads (n,) in; out (L, capacity) and payloads
// (capacity,) out, any L >= 1; status holds ceil(n / tile) + 1 int64 of
// scratch; *count_out receives the true kept count. One kernel launch
// (after the scratch's memset). Returns
// the first error (cudaError_t), 0 on success.
extern "C" int mg_partition(const void* lanes, int L, long long n,
                            const void* keep, const void* ex0,
                            const void* ex1, int n_extra, void* out,
                            void* oex0, void* oex1, long long capacity,
                            unsigned int extra_fill, void* status,
                            void* count_out, void* stream) {
  if (L < 1 || n_extra < 0 || n_extra > 2 || n < 0 ||
      capacity < 0 || n >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = (n + kTile - 1) / kTile;
  const long long fills =
      capacity > n ? (capacity - n + kTile - 1) / kTile : 0;
  cudaError_t err = cudaMemsetAsync(
      status, 0, (size_t)(tiles + 1) * sizeof(Word), s);
  if (err == cudaSuccess && tiles == 0) {
    err = cudaMemsetAsync(count_out, 0, sizeof(int), s);
  }
  if (err != cudaSuccess) return (int)err;
  if (tiles + fills == 0) return (int)cudaSuccess;
  Word* st = (Word*)status;
  partition_kernel<<<(unsigned)(tiles + fills), kThreads, 0, s>>>(
      (const uint32_t*)lanes, L, n, (const uint8_t*)keep,
      (const uint32_t*)ex0, (const uint32_t*)ex1, n_extra, (uint32_t*)out,
      (uint32_t*)oex0, (uint32_t*)oex1, capacity, extra_fill, st,
      (unsigned*)(st + tiles), (int*)count_out, tiles);
  return (int)cudaGetLastError();
}
