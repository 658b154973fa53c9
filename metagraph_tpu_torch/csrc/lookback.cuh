// Decoupled look-back (Merrill & Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back"), shared by sort.cu (one radix pass:
// 257 bins) and partition.cu (a stable partition: one bin).
//
// Tiles are taken in order by a dynamic tile index (take_tile), so every
// tile a block waits on belongs to a block that is already running and
// the look-back cannot deadlock. Each tile publishes, per bin, a 64-bit
// status word: the top two bits are the flag (0 nothing yet, kAggregate
// the tile's own count, kInclusive the count of this and every earlier
// tile), the rest the count. A word carries flag and count together, so
// one relaxed store publishes both and no fence is needed; 62 bits of
// count take any N.
//
// The status array is [tiles][bins] words and must be zero before the
// launch; the tile counter too.

#pragma once

#include <cstdint>

namespace mg {

using Word = unsigned long long;
constexpr int kShift = 62;
constexpr Word kAggregate = Word(1) << kShift;
constexpr Word kInclusive = Word(2) << kShift;
constexpr Word kCount = (Word(1) << kShift) - 1;

__device__ __forceinline__ void store_relaxed(Word* p, Word v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}
__device__ __forceinline__ Word load_relaxed(const Word* p) {
  Word v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// The block's tile index, in the order blocks start; every thread gets it.
__device__ __forceinline__ unsigned take_tile(unsigned* counter) {
  __shared__ unsigned tile;
  if (threadIdx.x == 0) tile = atomicAdd(counter, 1u);
  __syncthreads();
  return tile;
}

// Publish the tile's own `count` in `bin` (tile 0's is already its
// inclusive count). A block publishes every bin before it looks back in
// any, so no tile waits on another's look-back.
__device__ __forceinline__ void publish(Word* status, int bins,
                                        unsigned tile, int bin, Word count) {
  store_relaxed(status + (size_t)tile * bins + bin,
                (tile == 0 ? kInclusive : kAggregate) | count);
}

// After publish: the sum of the counts of every earlier tile in `bin`,
// and this tile's inclusive count published; one thread per bin.
__device__ Word lookback(Word* status, int bins, unsigned tile, int bin,
                         Word count) {
  if (tile == 0) return 0;
  Word sum = 0;
  for (long long p = (long long)tile - 1;; --p) {
    const Word* w = status + (size_t)p * bins + bin;
    Word s = load_relaxed(w);
    // not yet there; a tile that never publishes is a fault: trap (the
    // launch then fails) rather than hang the card
    for (long long spins = 0; (s >> kShift) == 0; s = load_relaxed(w)) {
      if (++spins > (1LL << 32)) __trap();
    }
    sum += s & kCount;
    if ((s >> kShift) == 2) break;                   // inclusive: done
  }
  store_relaxed(status + (size_t)tile * bins + bin,
                kInclusive | (sum + count));
  return sum;
}

// lookback by a whole warp: 32 earlier tiles read at once (lane i reads
// tile - 1 - i), so a walk over aggregates costs one load per 32 tiles;
// a wait backs off with __nanosleep, which measured faster for the
// partition. Every lane gets the sum; lane 0 publishes the inclusive
// count.
__device__ Word lookback_warp(Word* status, int bins, unsigned tile, int bin,
                              Word count) {
  if (tile == 0) return 0;
  const int lane = threadIdx.x & 31;
  Word sum = 0;
  for (long long top = (long long)tile - 1;; top -= 32) {
    const long long p = top - lane;
    const Word* w = status + (size_t)(p < 0 ? 0 : p) * bins + bin;
    Word s = p < 0 ? kInclusive : load_relaxed(w);
    for (long long spins = 0;
         !__all_sync(0xffffffffu, (s >> kShift) != 0);) {
      if ((s >> kShift) == 0) s = load_relaxed(w);
      __nanosleep(32);                     // back off: spare the L2
      if (++spins > (1LL << 32)) __trap();
    }
    // stop at the nearest inclusive count: lanes past it add nothing
    const unsigned inc = __ballot_sync(0xffffffffu, (s >> kShift) == 2);
    const int stop = inc ? __ffs(inc) - 1 : 32;
    Word v = lane <= stop ? (s & kCount) : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    sum += v;
    if (inc) break;
  }
  if (lane == 0) {
    store_relaxed(status + (size_t)tile * bins + bin,
                  kInclusive | (sum + count));
  }
  return sum;
}

// Exclusive prefix sum of one value per thread over a block of kThreads
// (a multiple of 32); *total gets the block's sum. `warp_sums` is shared
// scratch of kThreads / 32 + 1 entries. Ends with the block in step.
template <int kThreads, typename T>
__device__ __forceinline__ T block_exclusive_scan(T v, T* warp_sums,
                                                  T* total) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    T run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const T c = warp_sums[w];
      warp_sums[w] = run;
      run += c;
    }
    warp_sums[kWarps] = run;
  }
  __syncthreads();
  const T out = warp_sums[warp] + incl - v;
  *total = warp_sums[kWarps];
  __syncthreads();
  return out;
}

}  // namespace mg
