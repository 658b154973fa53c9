// The merge step of merge.cu: the lexicographic lane compare, the
// merge-path diagonal search and the shared-memory merge of one output
// tile. Keys are L uint32 lanes, lane 0 most significant, any L >= 1;
// PAD (all ones) is the largest key. Ties take A, so a merge of an
// earlier run A with a later run B is stable.

#pragma once

#include <cstdint>
#include <cuda_pipeline.h>

namespace mg {

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

// How many of the first d outputs of merge(A, B) come from A, where A is
// a[:, a_off : a_off + na] and B is b[:, b_off : b_off + nb] (ties to A).
__device__ __forceinline__ long long merge_path(
    const uint32_t* a, long long sa, long long a_off, long long na,
    const uint32_t* b, long long sb, long long b_off, long long nb,
    long long d, int L) {
  long long lo = max(0LL, d - nb);
  long long hi = min(d, na);
  while (lo < hi) {
    const long long m = (lo + hi) >> 1;
    if (le_lanes(a, sa, a_off + m, b, sb, b_off + d - m - 1, L)) {
      lo = m + 1;
    } else {
      hi = m;
    }
  }
  return lo;
}

// Items a thread at most: a tile is blockDim.x * items outputs,
// items <= kMaxItems.
constexpr int kMaxItems = 4;

// One block of blockDim.x threads writes out[:, d0 : d0 + na_t + nb_t]
// (lane stride so, at most `tile` = blockDim.x * items outputs) as the
// merge of A = a[:, a0 : a0 + na_t] and B = b[:, b0 : b0 + nb_t], with
// 0-2 payloads indexed like their keys. The block stages both windows'
// keys in dynamic shared memory ((L + 1) * tile words: L lanes of keys,
// then a source slot per output) by asynchronous copies (cp.async: a
// thread issues all its L * items copies before it waits, and holds no
// register for them); each thread finds its sub-diagonal by binary
// search and merges `items` outputs, recording each one's source slot
// (a tile fed by one side only skips the search: its slots are in
// order); then the block writes lanes and payloads back coalesced, a
// thread's payload reads all issued before their stores. Every thread
// of the block must call it.
__device__ __forceinline__ void merge_tile(
    const uint32_t* __restrict__ a, long long sa, long long a0, int na_t,
    const uint32_t* __restrict__ b, long long sb, long long b0, int nb_t,
    int L, int tile, int items, const uint32_t* __restrict__ ea0,
    const uint32_t* __restrict__ ea1, const uint32_t* __restrict__ eb0,
    const uint32_t* __restrict__ eb1, int n_extra,
    uint32_t* __restrict__ out, long long so, long long d0,
    uint32_t* __restrict__ oe0, uint32_t* __restrict__ oe1,
    uint32_t* smem) {
  const int cnt = na_t + nb_t;
  const int threads = blockDim.x;
  const bool one_sided = nb_t == 0 || na_t == 0;

  // stage the windows: slots [0, na_t) hold A, [na_t, cnt) hold B
  uint32_t* keys = smem;
  int* src = (int*)(smem + (size_t)L * tile);
  for (int j = 0; j < L; ++j) {
    for (int p = threadIdx.x; p < cnt; p += threads) {
      __pipeline_memcpy_async(
          keys + j * tile + p,
          p < na_t ? a + j * sa + a0 + p : b + j * sb + b0 + (p - na_t), 4);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  if (!one_sided) {
    const int diag = min((int)threadIdx.x * items, cnt);
    const int lo = (int)merge_path(keys, tile, 0, na_t, keys, tile, na_t,
                                   nb_t, diag, L);
    int ai = lo;
    int bi = diag - lo;
    for (int k = 0; k < items && diag + k < cnt; ++k) {
      const bool take_a =
          bi >= nb_t ||
          (ai < na_t && le_lanes(keys, tile, ai, keys, tile, na_t + bi, L));
      src[diag + k] = take_a ? ai++ : na_t + bi++;
    }
    __syncthreads();
  }

  for (int p = threadIdx.x; p < cnt; p += threads) {
    const int s = one_sided ? p : src[p];
    for (int j = 0; j < L; ++j) out[j * so + d0 + p] = keys[j * tile + s];
  }
  for (int e = 0; e < n_extra; ++e) {
    const uint32_t* xa = e == 0 ? ea0 : ea1;
    const uint32_t* xb = e == 0 ? eb0 : eb1;
    uint32_t* oe = e == 0 ? oe0 : oe1;
    uint32_t v[kMaxItems];
#pragma unroll
    for (int i = 0; i < kMaxItems; ++i) {
      const int p = threadIdx.x + i * threads;
      if (i < items && p < cnt) {
        const int s = one_sided ? p : src[p];
        v[i] = s < na_t ? xa[a0 + s] : xb[b0 + (s - na_t)];
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxItems; ++i) {
      const int p = threadIdx.x + i * threads;
      if (i < items && p < cnt) oe[d0 + p] = v[i];
    }
  }
}

}  // namespace mg
