// Stable merge of two sorted packed-lane arrays with payloads.
//
// Replaces the Pallas kernel metagraph_tpu/common/merge.py _merge_call /
// _make_kernel (bitonic network, with merge_path_splits; reached from
// merge_sorted). Keys are L uint32 lanes compared lexicographically,
// lane 0 most significant; PAD (all ones) is the largest key, so PAD
// tails act as +inf with no special case. Unlike the bitonic TPU kernel
// this merge is STABLE with A first on ties: exactly the stable sort of
// concat(A, B) that the CPU oracle computes.
//
// What bounds it on the card: memory bandwidth. It reads and writes
// (L+E)*4*(Na+Nb) bytes; the comparisons are a few integer ops per
// element. The design moves each element through the SM once:
//   1. splits: one thread per output tile boundary runs the merge-path
//      diagonal binary search (A first on ties) over device memory;
//   2. merge: one block per output tile of kMergeTile elements
//      (merge_tile.cuh, shared with the merge levels of sort.cu).
// The tile stages whole keys in shared memory and takes at most
// kMaxLanes lanes. Wider keys take the co-rank route (mg_merge_corank):
// one thread per element of A or B finds the element's rank in the other
// side by a binary search over all L lanes in device memory (lower bound
// for an element of A, upper bound for one of B, so ties go to A), and
// writes its lanes and payloads to its own index plus that rank.

#include <cstdint>
#include <cuda_runtime.h>

#include "merge_tile.cuh"

namespace {

using mg::kMaxLanes;
using mg::kMergeThreads;
using mg::kMergeTile;

__global__ void splits_kernel(const uint32_t* __restrict__ a, long long na,
                              const uint32_t* __restrict__ b, long long nb,
                              int L, long long g,
                              long long* __restrict__ splits) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t > g) return;
  const long long d = min(t * kMergeTile, na + nb);
  splits[t] = mg::merge_path(a, na, 0, na, b, nb, 0, nb, d, L);
}

__global__ void merge_kernel(const uint32_t* __restrict__ a, long long na,
                             const uint32_t* __restrict__ b, long long nb,
                             int L, const uint32_t* __restrict__ ea0,
                             const uint32_t* __restrict__ ea1,
                             const uint32_t* __restrict__ eb0,
                             const uint32_t* __restrict__ eb1, int n_extra,
                             uint32_t* __restrict__ out,
                             uint32_t* __restrict__ oe0,
                             uint32_t* __restrict__ oe1,
                             const long long* __restrict__ splits) {
  extern __shared__ uint32_t smem[];    // [L][kMergeTile] keys + slots
  const long long ntot = na + nb;
  const long long d0 = (long long)blockIdx.x * kMergeTile;
  const long long d1 = min(d0 + kMergeTile, ntot);
  const long long a0 = splits[blockIdx.x];
  const int na_t = (int)(splits[blockIdx.x + 1] - a0);
  mg::merge_tile(a, na, a0, na_t, b, nb, d0 - a0, (int)(d1 - d0) - na_t, L,
                 ea0, ea1, eb0, eb1, n_extra, out, ntot, d0, oe0, oe1, smem);
}

// Element t of concat(A, B) to its place in the merge: A's own index plus
// the count of B's keys < it, or B's own index plus the count of A's keys
// <= it. Both sides are sorted, so positions are distinct and each side
// keeps its order.
__global__ void corank_kernel(const uint32_t* __restrict__ a, long long na,
                              const uint32_t* __restrict__ b, long long nb,
                              int L, const uint32_t* __restrict__ ea0,
                              const uint32_t* __restrict__ ea1,
                              const uint32_t* __restrict__ eb0,
                              const uint32_t* __restrict__ eb1, int n_extra,
                              uint32_t* __restrict__ out,
                              uint32_t* __restrict__ oe0,
                              uint32_t* __restrict__ oe1) {
  const long long ntot = na + nb;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= ntot) return;
  const bool in_a = t < na;
  const uint32_t* self = in_a ? a : b;
  const uint32_t* other = in_a ? b : a;
  const long long ns = in_a ? na : nb;
  const long long no = in_a ? nb : na;
  const long long i = in_a ? t : t - na;
  long long lo = 0, hi = no;
  while (lo < hi) {
    const long long m = (lo + hi) >> 1;
    // A: step right past B's keys < self (not self <= other[m]);
    // B: step right past A's keys <= self
    const bool right = in_a ? !mg::le_lanes(self, ns, i, other, no, m, L)
                            : mg::le_lanes(other, no, m, self, ns, i, L);
    if (right) {
      lo = m + 1;
    } else {
      hi = m;
    }
  }
  const long long pos = i + lo;
  for (int j = 0; j < L; ++j) out[j * ntot + pos] = self[j * ns + i];
  if (n_extra > 0) oe0[pos] = in_a ? ea0[i] : eb0[i];
  if (n_extra > 1) oe1[pos] = in_a ? ea1[i] : eb1[i];
}

}  // namespace

// Output elements per block: the wrapper sizes the splits scratch as
// ceil((na + nb) / tile) + 1 int64s.
extern "C" int mg_merge_tile() { return kMergeTile; }

// a (L, na) and b (L, nb) sorted, with 0-2 payloads (na,)/(nb,) each;
// out (L, na+nb) and payloads (na+nb,). Returns cudaGetLastError().
extern "C" int mg_merge(const void* a, long long na, const void* b,
                        long long nb, int L, const void* ea0,
                        const void* ea1, const void* eb0, const void* eb1,
                        int n_extra, void* out, void* oe0, void* oe1,
                        void* splits, void* stream) {
  if (L < 1 || L > kMaxLanes || n_extra < 0 || n_extra > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const long long ntot = na + nb;
  if (ntot == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const long long g = (ntot + kMergeTile - 1) / kMergeTile;
  long long* sp = (long long*)splits;
  const unsigned split_blocks =
      (unsigned)((g + 1 + kMergeThreads - 1) / kMergeThreads);
  splits_kernel<<<split_blocks, kMergeThreads, 0, s>>>(
      (const uint32_t*)a, na, (const uint32_t*)b, nb, L, g, sp);
  const size_t shmem = (size_t)(L + 1) * kMergeTile * sizeof(uint32_t);
  merge_kernel<<<(unsigned)g, kMergeThreads, shmem, s>>>(
      (const uint32_t*)a, na, (const uint32_t*)b, nb, L,
      (const uint32_t*)ea0, (const uint32_t*)ea1, (const uint32_t*)eb0,
      (const uint32_t*)eb1, n_extra, (uint32_t*)out, (uint32_t*)oe0,
      (uint32_t*)oe1, sp);
  return (int)cudaGetLastError();
}

// The co-rank route, for any L >= 1 (the wrapper takes it past kMaxLanes):
// the same operands as mg_merge, no scratch. Returns cudaGetLastError().
extern "C" int mg_merge_corank(const void* a, long long na, const void* b,
                               long long nb, int L, const void* ea0,
                               const void* ea1, const void* eb0,
                               const void* eb1, int n_extra, void* out,
                               void* oe0, void* oe1, void* stream) {
  if (L < 1 || n_extra < 0 || n_extra > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const long long ntot = na + nb;
  if (ntot == 0) return (int)cudaGetLastError();
  constexpr int kThreads = 256;
  corank_kernel<<<(unsigned)((ntot + kThreads - 1) / kThreads), kThreads, 0,
                  (cudaStream_t)stream>>>(
      (const uint32_t*)a, na, (const uint32_t*)b, nb, L,
      (const uint32_t*)ea0, (const uint32_t*)ea1, (const uint32_t*)eb0,
      (const uint32_t*)eb1, n_extra, (uint32_t*)out, (uint32_t*)oe0,
      (uint32_t*)oe1);
  return (int)cudaGetLastError();
}
