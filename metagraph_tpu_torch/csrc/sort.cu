// Stable full sort of packed lanes with payloads: an LSD radix sort in
// the manner of Onesweep (Adinets & Merrill, arXiv:2206.01784).
//
// Replaces metagraph_tpu/common/merge.py sort_packed (batched lax.sort
// leaf runs, then segmented merges by the Pallas _merge_call). Keys are
// L uint32 lanes compared lexicographically, lane 0 most significant;
// PAD (all ones) sorts last. The TPU version is unstable; this one is
// STABLE (equal keys keep their input order, payloads included), so its
// output equals the stable torch.sort passes of packed.sort bit for bit.
//
// What bounds it on the card: memory bandwidth. The least work reads the
// (L + E) * 4 * N input bytes once and writes as many. A radix sort moves
// them once per 8-bit digit that runs, so the design runs as few digits
// as it can and moves the data once in each:
//   1. radix_hist_kernel, one launch: one read of the lanes counts, for
//      each of the 4 L digits (digit 0 = the low byte of lane L - 1), a
//      256-bin histogram of the non-PAD keys, and the PADs.
//   2. the host (common/merge.py radix_passes) copies the histograms back
//      and keeps only the digits on which the non-PAD keys differ.
//   3. radix_pass_kernel, one launch per digit that runs: tiles taken in
//      order (lookback.cuh) rank their keys stably per bin (warp ballots
//      over the bin's bits, per-warp bin counts), publish their bin
//      counts, stage the lanes and payloads in shared memory in sorted
//      order, then find each bin's offset among the earlier tiles by
//      decoupled look-back (late, so few threads spin) and scatter, each
//      bin's run of the tile as contiguous writes. PAD is bin 256, after
//      0xFF, in every pass: PADs end last in input order, and a non-PAD
//      key that reads 0xFF on every digit that runs still sorts before
//      them.
// What holds it back (PERF.md): the scatter's short runs (a tile of 4096
// keys leaves ~16 per bin) and each tile's chain of round trips; the
// histogram's shared-memory atomics.
// Element offsets, counts and the look-back's status words are 64-bit,
// so any N fits.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kMaxLanes = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 257;                  // 256 digit values + PAD
constexpr int kPadBin = 256;
constexpr int kNoBin = 257;                 // past N in the last tile
constexpr int kHistThreads = 512;
constexpr int kUnroll = 4;                  // histogram keys per thread
                                            // and round

// Keys per thread and pass tile. Only the keys' bins and positions sit
// in registers; the lanes and payloads stage in shared memory. Measured
// on the card (PERF.md): 8, 12 and 24
// keys per thread were slower than 16 at L = 2, and 8 to 13 at L = 4.
__host__ __device__ constexpr int items_for(int L) {
  return L <= 4 ? 16 : 12;
}

__global__ void __launch_bounds__(kHistThreads)
radix_hist_kernel(const uint32_t* __restrict__ x, long long n, int L,
                  unsigned long long* __restrict__ hist) {
  extern __shared__ uint32_t h[];             // [4 L][256] + [1] PAD
  const int digits = 4 * L;
  for (int i = threadIdx.x; i <= digits * 256; i += kHistThreads) h[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kHistThreads * kUnroll;
  // warp-uniform loop: every lane of a warp takes each round together;
  // a round loads kUnroll keys per thread, all in flight at once
  for (long long i0 = ((long long)blockIdx.x * kHistThreads +
                       (threadIdx.x & ~31)) * kUnroll;
       i0 < n; i0 += stride) {
    uint32_t v[kUnroll][kMaxLanes];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * 32 + lane;
#pragma unroll
      for (int j = 0; j < kMaxLanes; ++j) {
        if (j < L) v[u][j] = i < n ? x[j * n + i] : 0xFFFFFFFFu;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool valid = i0 + u * 32 + lane < n;
      bool pad = true;
#pragma unroll
      for (int j = 0; j < kMaxLanes; ++j) {
        if (j < L) pad = pad && v[u][j] == 0xFFFFFFFFu;
      }
      const bool key = valid && !pad;
      const unsigned pads = __ballot_sync(0xffffffffu, valid && pad);
      const unsigned keys = __ballot_sync(0xffffffffu, key);
      if (lane == 0 && pads) {
        atomicAdd(&h[digits * 256], (uint32_t)__popc(pads));
      }
#pragma unroll
      for (int j = 0; j < kMaxLanes; ++j) {
        if (j >= L) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t b = (v[u][j] >> (8 * q)) & 0xFFu;
          uint32_t* row = h + (4 * (L - 1 - j) + q) * 256;
          // one atomic for a warp whose keys share the byte (constant
          // digits, the common case on real keys), else one per key
          const uint32_t b0 = __shfl_sync(0xffffffffu, b, 0);
          const unsigned same = __ballot_sync(0xffffffffu, key && b == b0);
          if (same == keys) {
            if (lane == 0 && keys) {
              atomicAdd(&row[b0], (uint32_t)__popc(keys));
            }
          } else if (key) {
            atomicAdd(&row[b], 1u);
          }
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i <= digits * 256; i += kHistThreads) {
    if (h[i]) atomicAdd(&hist[i], (unsigned long long)h[i]);
  }
}

template <int L>
__global__ void __launch_bounds__(kThreads)
radix_pass_kernel(const uint32_t* __restrict__ src, long long n,
                  const uint32_t* __restrict__ se0,
                  const uint32_t* __restrict__ se1, int n_extra,
                  uint32_t* __restrict__ dst, uint32_t* __restrict__ de0,
                  uint32_t* __restrict__ de1,
                  const unsigned long long* __restrict__ hist, int digit,
                  int first_pass, mg::Word* __restrict__ status,
                  unsigned* __restrict__ counter) {
  constexpr int kItems = items_for(L);
  constexpr int kTile = kThreads * kItems;
  extern __shared__ uint32_t stage[];        // [L + n_extra][kTile]
  __shared__ uint32_t warp_cnt[kWarps][kBins];  // counts, then offsets
  __shared__ uint32_t bin_total[kBins];
  __shared__ uint32_t bin_start[kBins];
  __shared__ long long gbase[kBins];         // out index - local position
  __shared__ uint16_t sbin[kTile];
  __shared__ unsigned long long scan_ull[kWarps + 1];
  __shared__ uint32_t scan_u[kWarps + 1];

  const unsigned tile = mg::take_tile(counter);
  const long long base = (long long)tile * kTile;
  const int cnt = (int)min((long long)kTile, n - base);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;

  // the keys' digit lane first, so that its loads are in flight while
  // the block scans the histogram; item i of warp w sits at
  // w * 32 kItems + i * 32 + lane. The first pass tests every lane for
  // PAD; each pass leaves the PADs last, so later passes know them by
  // position.
  const uint32_t* dlane = src + (long long)(L - 1 - digit / 4) * n;
  const int shift = 8 * (digit % 4);
  uint32_t kv[kItems];
  bool pad[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int p = warp * 32 * kItems + i * 32 + lane;
    const long long g = base + p;
    kv[i] = p < cnt ? dlane[g] : 0u;
    pad[i] = p < cnt && first_pass;
    if (pad[i]) {
#pragma unroll
      for (int j = 0; j < L; ++j) {
        pad[i] = pad[i] && src[j * n + g] == 0xFFFFFFFFu;
      }
    }
  }
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) {
    (&warp_cnt[0][0])[i] = 0;
  }
  // this digit's bin offsets over the whole array: an exclusive scan of
  // its histogram; PAD after every non-PAD key
  unsigned long long keys_total;
  const unsigned long long doff = mg::block_exclusive_scan<kThreads>(
      hist[digit * 256 + threadIdx.x], scan_ull, &keys_total);
  int bin[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int p = warp * 32 * kItems + i * 32 + lane;
    if (!first_pass) pad[i] = base + p >= (long long)keys_total;
    bin[i] = p >= cnt ? kNoBin
                      : (pad[i] ? kPadBin : (int)((kv[i] >> shift) & 0xFFu));
  }

  // stable rank within the warp, items in order and lanes in order: the
  // lanes that share a bin (9 ballots over the bin's bits) take their
  // places after the bin's count so far, which their lowest lane bumps
  int pos[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    unsigned peers = 0xffffffffu;
#pragma unroll
    for (int bit = 0; bit < 9; ++bit) {
      const bool on = (bin[i] >> bit) & 1;
      const unsigned bal = __ballot_sync(0xffffffffu, on);
      peers &= on ? bal : ~bal;
    }
    const int leader = __ffs(peers) - 1;
    uint32_t before = 0;
    if (lane == leader && bin[i] != kNoBin) {
      before = atomicAdd(&warp_cnt[warp][bin[i]], (uint32_t)__popc(peers));
    }
    pos[i] = (int)__shfl_sync(0xffffffffu, before, leader) +
             __popc(peers & lt);
  }
  __syncthreads();

  // per bin: the warps' offsets and the tile's count, published at once;
  // the look-back waits until the tile has staged its keys, so that the
  // earlier tiles have mostly published and few threads spin on them
  for (int b = threadIdx.x; b < kBins; b += kThreads) {
    uint32_t run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = warp_cnt[w][b];
      warp_cnt[w][b] = run;
      run += c;
    }
    bin_total[b] = run;
    mg::publish(status, kBins, tile, b, run);
  }
  __syncthreads();
  // the bins' starts inside the tile, PAD's after all 256 others
  uint32_t tile_keys;
  bin_start[threadIdx.x] = mg::block_exclusive_scan<kThreads>(
      bin_total[threadIdx.x], scan_u, &tile_keys);
  if (threadIdx.x == 0) bin_start[kPadBin] = tile_keys;
  __syncthreads();

  // each key's position in the tile's sorted order; stage every lane and
  // payload there (all of a thread's loads in flight at once)
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (bin[i] == kNoBin) continue;
    pos[i] += (int)(bin_start[bin[i]] + warp_cnt[warp][bin[i]]);
    sbin[pos[i]] = (uint16_t)bin[i];
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int p = warp * 32 * kItems + i * 32 + lane;
      if (bin[i] != kNoBin) stage[j * kTile + pos[i]] = src[j * n + base + p];
    }
  }
  for (int e = 0; e < n_extra; ++e) {
    const uint32_t* se = e ? se1 : se0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int p = warp * 32 * kItems + i * 32 + lane;
      if (bin[i] != kNoBin) stage[(L + e) * kTile + pos[i]] = se[base + p];
    }
  }
  // the earlier tiles' counts per bin: the write offsets
  for (int b = threadIdx.x; b < kBins; b += kThreads) {
    const long long off = b == kPadBin ? (long long)keys_total
                                       : (long long)doff;
    gbase[b] = off - bin_start[b] +
               (long long)mg::lookback(status, kBins, tile, b, bin_total[b]);
  }
  __syncthreads();

  // scatter: each bin's run of the tile leaves as contiguous writes,
  // cached in L2 only (st.cg: measured 7-10 % faster at L = 4), where the
  // runs of neighbouring tiles meet
  for (int p = threadIdx.x; p < cnt; p += kThreads) {
    const long long g = gbase[sbin[p]] + p;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      __stcg(&dst[j * n + g], stage[j * kTile + p]);
    }
    if (n_extra > 0) __stcg(&de0[g], stage[L * kTile + p]);
    if (n_extra > 1) __stcg(&de1[g], stage[(L + 1) * kTile + p]);
  }
}

template <int L>
cudaError_t launch_pass(const void* src, long long n, const void* se0,
                        const void* se1, int n_extra, void* dst, void* de0,
                        void* de1, const void* hist, int digit,
                        int first_pass, void* status, cudaStream_t s) {
  constexpr int kTile = kThreads * items_for(L);
  const long long tiles = (n + kTile - 1) / kTile;
  const size_t smem = (size_t)(L + n_extra) * kTile * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      radix_pass_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)((L + 2) * kTile * sizeof(uint32_t)));
  if (err != cudaSuccess) return err;
  // the status words and, after them, the tile counter start at zero
  err = cudaMemsetAsync(status, 0,
                        (size_t)(tiles * kBins + 1) * sizeof(mg::Word), s);
  if (err != cudaSuccess) return err;
  mg::Word* st = (mg::Word*)status;
  radix_pass_kernel<L><<<(unsigned)tiles, kThreads, smem, s>>>(
      (const uint32_t*)src, n, (const uint32_t*)se0, (const uint32_t*)se1,
      n_extra, (uint32_t*)dst, (uint32_t*)de0, (uint32_t*)de1,
      (const unsigned long long*)hist, digit, first_pass, st,
      (unsigned*)(st + tiles * kBins));
  return cudaGetLastError();
}

}  // namespace

// Keys per pass tile at L lanes: the wrapper sizes the status words as
// ceil(n / tile) * 257 + 1 int64.
extern "C" int mg_sort_tile(int L) { return kThreads * items_for(L); }

// hist (4 L * 256 + 1) uint64: per digit (digit 0 = the low byte of lane
// L - 1) the counts of the non-PAD keys in each bin, then the PAD count.
// Returns the first error (cudaError_t), 0 on success.
extern "C" int mg_sort_hist(const void* x, long long n, int L, void* hist,
                            void* stream) {
  if (L < 1 || L > kMaxLanes || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t words = (size_t)4 * L * 256 + 1;
  cudaError_t err = cudaMemsetAsync(hist, 0, words * 8, s);
  if (err != cudaSuccess || n == 0) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  constexpr int kRound = kHistThreads * kUnroll;
  long long blocks = (n + kRound - 1) / kRound;
  if (blocks > 2LL * sms) blocks = 2LL * sms;
  radix_hist_kernel<<<(unsigned)blocks, kHistThreads,
                      words * sizeof(uint32_t), s>>>(
      (const uint32_t*)x, n, L, (unsigned long long*)hist);
  return (int)cudaGetLastError();
}

// One stable pass on `digit`: src (L, n) lanes and 0-2 payloads (n,) ->
// dst, with hist from mg_sort_hist and status of ceil(n / tile) * 257 + 1
// int64 of scratch. `first_pass` makes it test every lane for PAD; it may
// be 0 when src holds no PAD or the output of an earlier pass (its PADs
// last, known by position). Returns the first error (cudaError_t), 0 on
// success.
extern "C" int mg_sort_pass(const void* src, long long n, int L,
                            const void* se0, const void* se1, int n_extra,
                            void* dst, void* de0, void* de1,
                            const void* hist, int digit, int first_pass,
                            void* status, void* stream) {
  if (L < 1 || L > kMaxLanes || n_extra < 0 || n_extra > 2 || n < 1 ||
      digit < 0 || digit >= 4 * L) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (L) {
#define MG_PASS(LL)                                                       \
  case LL:                                                                \
    err = launch_pass<LL>(src, n, se0, se1, n_extra, dst, de0, de1, hist, \
                          digit, first_pass, status, s);                  \
    break;
    MG_PASS(1) MG_PASS(2) MG_PASS(3) MG_PASS(4)
    MG_PASS(5) MG_PASS(6) MG_PASS(7) MG_PASS(8)
#undef MG_PASS
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
