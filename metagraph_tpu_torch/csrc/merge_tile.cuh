// The merge step shared by merge.cu (one merge of two sorted arrays) and
// sort.cu (the merge levels of the full sort): the lexicographic lane
// compare, the merge-path diagonal search and the shared-memory merge of
// one output tile. Keys are L uint32 lanes, lane 0 most significant;
// PAD (all ones) is the largest key. Ties take A, so a merge of an
// earlier run A with a later run B is stable.

#pragma once

#include <cstdint>

namespace mg {

constexpr int kMergeThreads = 256;
constexpr int kMergeItems = 4;
constexpr int kMergeTile = kMergeThreads * kMergeItems;
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

// One block of kMergeThreads writes out[:, d0 : d0 + na_t + nb_t] (lane
// stride so) as the merge of A = a[:, a0 : a0 + na_t] and
// B = b[:, b0 : b0 + nb_t], with 0-2 payloads indexed like their keys.
// A tile fed by one side only is a coalesced copy. Otherwise the block
// stages both windows' keys in smem ((L + 1) * kMergeTile words), each
// thread finds its sub-diagonal by binary search and merges kMergeItems
// outputs, recording each one's source slot; then the block writes lanes
// and payloads back coalesced. Every thread of the block must call it.
__device__ __forceinline__ void merge_tile(
    const uint32_t* __restrict__ a, long long sa, long long a0, int na_t,
    const uint32_t* __restrict__ b, long long sb, long long b0, int nb_t,
    int L, const uint32_t* __restrict__ ea0, const uint32_t* __restrict__ ea1,
    const uint32_t* __restrict__ eb0, const uint32_t* __restrict__ eb1,
    int n_extra, uint32_t* __restrict__ out, long long so, long long d0,
    uint32_t* __restrict__ oe0, uint32_t* __restrict__ oe1, uint32_t* smem) {
  const int cnt = na_t + nb_t;
  if (nb_t == 0 || na_t == 0) {               // one-sided tile: a copy
    const bool from_a = nb_t == 0;
    const uint32_t* s = from_a ? a : b;
    const long long ss = from_a ? sa : sb;
    const long long s0 = from_a ? a0 : b0;
    for (int p = threadIdx.x; p < cnt; p += kMergeThreads) {
      for (int j = 0; j < L; ++j) out[j * so + d0 + p] = s[j * ss + s0 + p];
      if (n_extra > 0) oe0[d0 + p] = (from_a ? ea0 : eb0)[s0 + p];
      if (n_extra > 1) oe1[d0 + p] = (from_a ? ea1 : eb1)[s0 + p];
    }
    return;
  }

  // stage the windows: slots [0, na_t) hold A, [na_t, cnt) hold B
  uint32_t* keys = smem;
  int* src = (int*)(smem + L * kMergeTile);
  for (int p = threadIdx.x; p < cnt; p += kMergeThreads) {
    for (int j = 0; j < L; ++j) {
      keys[j * kMergeTile + p] =
          p < na_t ? a[j * sa + a0 + p] : b[j * sb + b0 + (p - na_t)];
    }
  }
  __syncthreads();

  const int diag = min((int)threadIdx.x * kMergeItems, cnt);
  const int lo = (int)merge_path(keys, kMergeTile, 0, na_t, keys, kMergeTile,
                                 na_t, nb_t, diag, L);
  int ai = lo;
  int bi = diag - lo;
  for (int k = 0; k < kMergeItems && diag + k < cnt; ++k) {
    const bool take_a =
        bi >= nb_t || (ai < na_t && le_lanes(keys, kMergeTile, ai, keys,
                                             kMergeTile, na_t + bi, L));
    src[diag + k] = take_a ? ai++ : na_t + bi++;
  }
  __syncthreads();

  for (int p = threadIdx.x; p < cnt; p += kMergeThreads) {
    const int s = src[p];
    for (int j = 0; j < L; ++j) out[j * so + d0 + p] = keys[j * kMergeTile + s];
    if (n_extra > 0) {
      oe0[d0 + p] = s < na_t ? ea0[a0 + s] : eb0[b0 + (s - na_t)];
    }
    if (n_extra > 1) {
      oe1[d0 + p] = s < na_t ? ea1[a0 + s] : eb1[b0 + (s - na_t)];
    }
  }
}

}  // namespace mg
