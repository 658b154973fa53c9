// Stable full sort of packed lanes with payloads.
//
// Replaces metagraph_tpu/common/merge.py sort_packed: batched lax.sort
// leaf runs, then log2(N / leaf) levels of segmented merges
// (_segment_splits + the Pallas _merge_call). Keys are L uint32 lanes
// compared lexicographically, lane 0 most significant; PAD (all ones)
// sorts last. The TPU version is unstable; this one is STABLE (equal
// keys keep their input order, payloads included), so its output equals
// the stable torch.sort passes of packed.sort bit for bit.
//
// What bounds it on the card: memory bandwidth. The least work reads the
// (L + E) * 4 * N input bytes once and writes as many; a comparison sort
// moves them once per level. The design keeps the TPU kernel's shape:
//   1. leaf: one block of 1024 threads sorts a tile of kLeaf = 2048
//      entries in shared memory with a bitonic network over
//      (key, position in the tile). The position makes every entry
//      distinct, so the network's result is the stable order; slots past
//      N are PAD keys with positions above every real one, so they sort
//      to the tile's end and are not written.
//   2. levels: runs of kLeaf, 2 kLeaf, ... merge pairwise, one launch per
//      level, ping-ponging between the output and a scratch buffer (the
//      leaf writes to whichever makes the last level land in the
//      output). One block per output tile of kMergeTile: the tile lies in
//      one run pair (2 * run is a multiple of the tile), its first two
//      threads find its window in the pair by the merge-path search, and
//      merge_tile.cuh merges it with ties to A, the earlier run. A lone
//      trailing run has an empty B and is copied through.
// Element offsets are 64-bit: L * N passes 2^31 at L = 4, N = 2^25.

#include <cstdint>
#include <cuda_runtime.h>

#include "merge_tile.cuh"

namespace {

using mg::kMaxLanes;
using mg::kMergeThreads;
using mg::kMergeTile;

constexpr int kLeaf = 2048;
constexpr int kLeafThreads = kLeaf / 2;     // one compare-exchange each

// (keys[:, i], pos[i]) > (keys[:, l], pos[l]); keys lane stride kLeaf
__device__ __forceinline__ bool gt_entry(const uint32_t* keys,
                                         const uint32_t* pos, int i, int l,
                                         int L) {
  for (int j = 0; j < L; ++j) {
    const uint32_t x = keys[j * kLeaf + i];
    const uint32_t y = keys[j * kLeaf + l];
    if (x != y) return x > y;
  }
  return pos[i] > pos[l];
}

__global__ void __launch_bounds__(kLeafThreads)
leaf_kernel(const uint32_t* __restrict__ x, long long n, int L,
            const uint32_t* __restrict__ e0, const uint32_t* __restrict__ e1,
            int n_extra, uint32_t* __restrict__ out,
            uint32_t* __restrict__ oe0, uint32_t* __restrict__ oe1) {
  extern __shared__ uint32_t smem[];          // [L][kLeaf] keys + [kLeaf]
  uint32_t* keys = smem;
  uint32_t* pos = smem + L * kLeaf;
  const long long base = (long long)blockIdx.x * kLeaf;
  const int cnt = (int)min((long long)kLeaf, n - base);
  for (int p = threadIdx.x; p < kLeaf; p += kLeafThreads) {
    for (int j = 0; j < L; ++j) {
      keys[j * kLeaf + p] = p < cnt ? x[j * n + base + p] : 0xFFFFFFFFu;
    }
    pos[p] = p;
  }
  __syncthreads();

  const int t = threadIdx.x;
  for (int k = 2; k <= kLeaf; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int i = 2 * t - (t & (j - 1));    // pair (i, i + j)
      const int l = i + j;
      const bool up = (i & k) == 0;
      if (gt_entry(keys, pos, i, l, L) == up) {
        for (int q = 0; q < L; ++q) {
          const uint32_t v = keys[q * kLeaf + i];
          keys[q * kLeaf + i] = keys[q * kLeaf + l];
          keys[q * kLeaf + l] = v;
        }
        const uint32_t v = pos[i];
        pos[i] = pos[l];
        pos[l] = v;
      }
      __syncthreads();
    }
  }

  for (int p = threadIdx.x; p < cnt; p += kLeafThreads) {
    for (int j = 0; j < L; ++j) out[j * n + base + p] = keys[j * kLeaf + p];
    if (n_extra > 0) oe0[base + p] = e0[base + pos[p]];
    if (n_extra > 1) oe1[base + p] = e1[base + pos[p]];
  }
}

__global__ void __launch_bounds__(kMergeThreads)
level_kernel(const uint32_t* __restrict__ src, long long n, int L,
             long long run, const uint32_t* __restrict__ se0,
             const uint32_t* __restrict__ se1, int n_extra,
             uint32_t* __restrict__ dst, uint32_t* __restrict__ de0,
             uint32_t* __restrict__ de1) {
  extern __shared__ uint32_t smem[];          // [L][kMergeTile] + slots
  __shared__ long long split[2];
  const long long d0 = (long long)blockIdx.x * kMergeTile;
  const long long d1 = min(d0 + kMergeTile, n);
  const long long a_beg = d0 / (2 * run) * (2 * run);   // the run pair
  const long long b_beg = min(a_beg + run, n);
  const long long nb = min(a_beg + 2 * run, n) - b_beg;
  if (threadIdx.x < 2) {
    const long long d = (threadIdx.x == 0 ? d0 : d1) - a_beg;
    split[threadIdx.x] = mg::merge_path(src, n, a_beg, b_beg - a_beg, src,
                                        n, b_beg, nb, d, L);
  }
  __syncthreads();
  const int na_t = (int)(split[1] - split[0]);
  mg::merge_tile(src, n, a_beg + split[0], na_t, src, n,
                 b_beg + (d0 - a_beg - split[0]), (int)(d1 - d0) - na_t, L,
                 se0, se1, se0, se1, n_extra, dst, n, d0, de0, de1, smem);
}

}  // namespace

// Entries a leaf block sorts.
extern "C" int mg_sort_leaf() { return kLeaf; }

// x (L, n) with 0-2 four-byte payloads (n,) -> out (L, n) and payloads
// (n,) sorted stably; tmp (L, n) and te* (n,) are scratch of the same
// shapes. Returns the first launch error (cudaError_t), 0 on success.
extern "C" int mg_sort(const void* x, long long n, int L, const void* e0,
                       const void* e1, int n_extra, void* out, void* oe0,
                       void* oe1, void* tmp, void* te0, void* te1,
                       void* stream) {
  if (L < 1 || L > kMaxLanes || n_extra < 0 || n_extra > 2 || n < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  int levels = 0;
  for (long long run = kLeaf; run < n; run *= 2) ++levels;
  uint32_t* buf[2][3] = {
      {(uint32_t*)out, (uint32_t*)oe0, (uint32_t*)oe1},
      {(uint32_t*)tmp, (uint32_t*)te0, (uint32_t*)te1}};
  int cur = levels & 1;        // the last level then writes to out

  const size_t leaf_smem = (size_t)(L + 1) * kLeaf * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      leaf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)((kMaxLanes + 1) * kLeaf * sizeof(uint32_t)));
  if (err != cudaSuccess) return (int)err;
  leaf_kernel<<<(unsigned)((n + kLeaf - 1) / kLeaf), kLeafThreads, leaf_smem,
                s>>>((const uint32_t*)x, n, L, (const uint32_t*)e0,
                     (const uint32_t*)e1, n_extra, buf[cur][0], buf[cur][1],
                     buf[cur][2]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t merge_smem = (size_t)(L + 1) * kMergeTile * sizeof(uint32_t);
  const unsigned tiles = (unsigned)((n + kMergeTile - 1) / kMergeTile);
  for (long long run = kLeaf; run < n; run *= 2) {
    level_kernel<<<tiles, kMergeThreads, merge_smem, s>>>(
        buf[cur][0], n, L, run, buf[cur][1], buf[cur][2], n_extra,
        buf[cur ^ 1][0], buf[cur ^ 1][1], buf[cur ^ 1][2]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cur ^= 1;
  }
  return (int)cudaSuccess;
}
