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
//   2. merge: one block per output tile of kTile elements. A tile fed by
//      one side only (most tiles when one input is far smaller, as when
//      the few dummy edges merge into the real edges) is a coalesced
//      copy. Otherwise the block stages its A and B windows' keys in
//      shared memory, each thread finds its own sub-diagonal by binary
//      search and merges kItems outputs sequentially, recording each
//      output's source slot; the block then writes lanes and payloads
//      back coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kMaxLanes = 8;

// a[:, ia] <= b[:, ib] over L lanes (lane stride sa / sb)
__device__ __forceinline__ bool le_lanes(const uint32_t* a, long long sa,
                                         long long ia, const uint32_t* b,
                                         long long sb, long long ib, int L) {
  for (int j = 0; j < L; ++j) {
    const uint32_t x = a[j * sa + ia];
    const uint32_t y = b[j * sb + ib];
    if (x != y) return x < y;
  }
  return true;
}

__global__ void splits_kernel(const uint32_t* __restrict__ a, long long na,
                              const uint32_t* __restrict__ b, long long nb,
                              int L, long long g,
                              long long* __restrict__ splits) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t > g) return;
  const long long d = min(t * kTile, na + nb);
  long long lo = max(0LL, d - nb);
  long long hi = min(d, na);
  while (lo < hi) {
    const long long m = (lo + hi) >> 1;
    if (le_lanes(a, na, m, b, nb, d - m - 1, L)) {
      lo = m + 1;
    } else {
      hi = m;
    }
  }
  splits[t] = lo;
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
  extern __shared__ uint32_t smem[];          // [L][kTile] keys + kTile slots
  uint32_t* keys = smem;
  int* src = (int*)(smem + L * kTile);
  const long long ntot = na + nb;
  const long long d0 = (long long)blockIdx.x * kTile;
  const long long d1 = min(d0 + kTile, ntot);
  const long long a0 = splits[blockIdx.x];
  const long long a1 = splits[blockIdx.x + 1];
  const long long b0 = d0 - a0;
  const int cnt = (int)(d1 - d0);
  const int na_t = (int)(a1 - a0);
  const int nb_t = cnt - na_t;

  if (nb_t == 0 || na_t == 0) {               // one-sided tile: a copy
    const bool from_a = nb_t == 0;
    const uint32_t* s = from_a ? a : b;
    const long long ss = from_a ? na : nb;
    const long long s0 = from_a ? a0 : b0;
    for (int p = threadIdx.x; p < cnt; p += kThreads) {
      for (int j = 0; j < L; ++j) out[j * ntot + d0 + p] = s[j * ss + s0 + p];
      if (n_extra > 0) oe0[d0 + p] = (from_a ? ea0 : eb0)[s0 + p];
      if (n_extra > 1) oe1[d0 + p] = (from_a ? ea1 : eb1)[s0 + p];
    }
    return;
  }

  // stage the windows: slots [0, na_t) hold A, [na_t, cnt) hold B
  for (int p = threadIdx.x; p < cnt; p += kThreads) {
    for (int j = 0; j < L; ++j) {
      keys[j * kTile + p] =
          p < na_t ? a[j * na + a0 + p] : b[j * nb + b0 + (p - na_t)];
    }
  }
  __syncthreads();

  const int diag = min((int)threadIdx.x * kItems, cnt);
  int lo = max(0, diag - nb_t);
  int hi = min(diag, na_t);
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (le_lanes(keys, kTile, m, keys, kTile, na_t + diag - m - 1, L)) {
      lo = m + 1;
    } else {
      hi = m;
    }
  }
  int ai = lo;
  int bi = diag - lo;
  for (int k = 0; k < kItems && diag + k < cnt; ++k) {
    const bool take_a =
        bi >= nb_t ||
        (ai < na_t && le_lanes(keys, kTile, ai, keys, kTile, na_t + bi, L));
    src[diag + k] = take_a ? ai++ : na_t + bi++;
  }
  __syncthreads();

  for (int p = threadIdx.x; p < cnt; p += kThreads) {
    const int s = src[p];
    for (int j = 0; j < L; ++j) out[j * ntot + d0 + p] = keys[j * kTile + s];
    if (n_extra > 0) {
      oe0[d0 + p] = s < na_t ? ea0[a0 + s] : eb0[b0 + (s - na_t)];
    }
    if (n_extra > 1) {
      oe1[d0 + p] = s < na_t ? ea1[a0 + s] : eb1[b0 + (s - na_t)];
    }
  }
}

}  // namespace

// Output elements per block: the wrapper sizes the splits scratch as
// ceil((na + nb) / tile) + 1 int64s.
extern "C" int mg_merge_tile() { return kTile; }

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
  const long long g = (ntot + kTile - 1) / kTile;
  long long* sp = (long long*)splits;
  const unsigned split_blocks = (unsigned)((g + 1 + kThreads - 1) / kThreads);
  splits_kernel<<<split_blocks, kThreads, 0, s>>>(
      (const uint32_t*)a, na, (const uint32_t*)b, nb, L, g, sp);
  const size_t shmem = (size_t)(L + 1) * kTile * sizeof(uint32_t);
  merge_kernel<<<(unsigned)g, kThreads, shmem, s>>>(
      (const uint32_t*)a, na, (const uint32_t*)b, nb, L,
      (const uint32_t*)ea0, (const uint32_t*)ea1, (const uint32_t*)eb0,
      (const uint32_t*)eb1, n_extra, (uint32_t*)out, (uint32_t*)oe0,
      (uint32_t*)oe1, sp);
  return (int)cudaGetLastError();
}
