// Stable merge of two sorted packed-lane arrays with payloads, for any
// number of lanes L up to what one tile's shared memory holds.
//
// Replaces the Pallas kernel metagraph_tpu/common/merge.py:333
// _merge_call / _make_kernel (bitonic network, with merge_path_splits;
// reached from merge_sorted), which takes any L too. Keys are L uint32
// lanes compared lexicographically, lane 0 most significant; PAD (all
// ones) is the largest key, so PAD tails act as +inf with no special
// case. Unlike the bitonic TPU kernel this merge is STABLE with A first
// on ties: exactly the stable sort of concat(A, B) that the CPU oracle
// computes.
//
// What bounds it on the card: memory bandwidth. It reads and writes
// (L+E)*4*(Na+Nb) bytes; the comparisons are a few integer ops per
// element. The design moves each element through the SM once, in two
// launches:
//   1. splits: one thread per output tile boundary runs the merge-path
//      diagonal binary search (A first on ties) over device memory;
//   2. merge: one block per output tile (merge_tile.cuh) stages whole
//      keys, (L + 1) words an output, in dynamic shared memory by
//      asynchronous copies (cp.async: every read of a thread in flight
//      at once, no register held), merges there and writes back
//      coalesced; a tile fed by one side is staged and written back in
//      order. Ties go to A, so the merge is stable. A tile
//      is 1024 outputs (256 threads x 4) while (L + 1) * 4 KB fits in
//      the block's opt-in shared memory (227 KB on an H100: L <= 55);
//      wider keys halve the tile, first the items a thread, then the
//      threads, down to one warp of one item (L <= 1815 there). Past
//      48 KB the launch opts in once per device and size
//      (cudaFuncSetAttribute). mg_merge_tile(L) reports the tile, 0 past
//      the widest L; mg_merge_max_lanes() that widest L.
// The TPU kernel's bitonic network and reversed-B windows suit its
// vector unit; here a thread walks its sub-diagonal in shared memory.

#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

#include "merge_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = kThreads * mg::kMaxItems;
constexpr int kMinTile = 32;                 // one warp, one item each
constexpr size_t kDefaultSmem = 48 * 1024;   // no opt-in needed below
constexpr int kMaxDevices = 64;

__global__ void splits_kernel(const uint32_t* __restrict__ a, long long na,
                              const uint32_t* __restrict__ b, long long nb,
                              int L, int tile, long long g,
                              long long* __restrict__ splits) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t > g) return;
  const long long d = min(t * tile, na + nb);
  splits[t] = mg::merge_path(a, na, 0, na, b, nb, 0, nb, d, L);
}

// At most 51 registers a thread, so that 5 blocks fit an SM: as many as
// the shared memory of a 9-lane tile allows (measured faster at 2-9 lanes
// than the 56 registers the compiler picks alone).
__global__ void __launch_bounds__(kThreads, 5)
merge_kernel(const uint32_t* __restrict__ a, long long na,
             const uint32_t* __restrict__ b, long long nb, int L, int tile,
             int items, const uint32_t* __restrict__ ea0,
             const uint32_t* __restrict__ ea1,
             const uint32_t* __restrict__ eb0,
             const uint32_t* __restrict__ eb1, int n_extra,
             uint32_t* __restrict__ out, uint32_t* __restrict__ oe0,
             uint32_t* __restrict__ oe1,
             const long long* __restrict__ splits) {
  extern __shared__ uint32_t smem[];    // [L][tile] keys, [tile] slots
  const long long ntot = na + nb;
  const long long d0 = (long long)blockIdx.x * tile;
  const long long d1 = min(d0 + tile, ntot);
  const long long a0 = splits[blockIdx.x];
  const int na_t = (int)(splits[blockIdx.x + 1] - a0);
  mg::merge_tile(a, na, a0, na_t, b, nb, d0 - a0, (int)(d1 - d0) - na_t, L,
                 tile, items, ea0, ea1, eb0, eb1, n_extra, out, ntot, d0,
                 oe0, oe1, smem);
}

size_t smem_bytes(int L, int tile) {
  return (size_t)(L + 1) * tile * sizeof(uint32_t);
}

// The opt-in shared memory a block of the current device may use.
cudaError_t smem_limit(int* dev, size_t* limit) {
  cudaError_t err = cudaGetDevice(dev);
  int v = 0;
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 *dev);
  }
  *limit = (size_t)v;
  return err;
}

// The largest tile whose keys fit, 0 if none.
int tile_for(int L, size_t limit) {
  for (int tile = kMaxTile; tile >= kMinTile; tile /= 2) {
    if (smem_bytes(L, tile) <= limit) return tile;
  }
  return 0;
}

// Raise merge_kernel's dynamic shared memory cap on the current device to
// at least `bytes`: the attribute only grows, under a lock, so a launch
// never finds it below what it asked for.
cudaError_t opt_in(int dev, size_t bytes) {
  static std::mutex lock;
  static size_t granted[kMaxDevices] = {};
  if (bytes <= kDefaultSmem) return cudaSuccess;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> guard(lock);
  if (granted[dev] >= bytes) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) granted[dev] = bytes;
  return err;
}

}  // namespace

// Output elements per tile at L lanes on the current device: the wrapper
// sizes the splits scratch as ceil((na + nb) / tile) + 1 int64s. 0 when
// not even the smallest tile holds L lanes (or the device cannot be read).
extern "C" int mg_merge_tile(int L) {
  int dev;
  size_t limit;
  if (L < 1 || smem_limit(&dev, &limit) != cudaSuccess) return 0;
  return tile_for(L, limit);
}

// The widest L the merge takes on the current device (0 on an error).
extern "C" int mg_merge_max_lanes() {
  int dev;
  size_t limit;
  if (smem_limit(&dev, &limit) != cudaSuccess) return 0;
  return (int)(limit / (kMinTile * sizeof(uint32_t))) - 1;
}

// a (L, na) and b (L, nb) sorted, with 0-2 payloads (na,)/(nb,) each;
// out (L, na+nb) and payloads (na+nb,); splits holds
// ceil((na + nb) / mg_merge_tile(L)) + 1 int64 of scratch. Two launches
// (splits, then tiles). Returns the first error (cudaError_t), 0 on
// success.
extern "C" int mg_merge(const void* a, long long na, const void* b,
                        long long nb, int L, const void* ea0,
                        const void* ea1, const void* eb0, const void* eb1,
                        int n_extra, void* out, void* oe0, void* oe1,
                        void* splits, void* stream) {
  if (L < 1 || n_extra < 0 || n_extra > 2) {
    return (int)cudaErrorInvalidValue;
  }
  int dev;
  size_t limit;
  cudaError_t err = smem_limit(&dev, &limit);
  if (err != cudaSuccess) return (int)err;
  const int tile = tile_for(L, limit);
  if (tile == 0) return (int)cudaErrorInvalidValue;
  const long long ntot = na + nb;
  if (ntot == 0) return (int)cudaGetLastError();
  const int threads = tile < kThreads ? tile : kThreads;
  const size_t shmem = smem_bytes(L, tile);
  err = opt_in(dev, shmem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const long long g = (ntot + tile - 1) / tile;
  long long* sp = (long long*)splits;
  const unsigned split_blocks =
      (unsigned)((g + 1 + kThreads - 1) / kThreads);
  splits_kernel<<<split_blocks, kThreads, 0, s>>>(
      (const uint32_t*)a, na, (const uint32_t*)b, nb, L, tile, g, sp);
  merge_kernel<<<(unsigned)g, threads, shmem, s>>>(
      (const uint32_t*)a, na, (const uint32_t*)b, nb, L, tile,
      tile / threads, (const uint32_t*)ea0, (const uint32_t*)ea1,
      (const uint32_t*)eb0, (const uint32_t*)eb1, n_extra, (uint32_t*)out,
      (uint32_t*)oe0, (uint32_t*)oe1, sp);
  return (int)cudaGetLastError();
}
