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
// data once per 8-bit digit that runs, so the design runs as few digits
// as it can and moves as few bytes as it can in each:
//   1. one histogram launch for any L counts, for each of the 4 L digits
//      (digit 0 = the low byte of lane L - 1), a 256-bin histogram of the
//      non-PAD keys, and the PADs: lanes_hist_kernel for the lanes route,
//      index_hist_kernel (a block a chunk of 8 lanes) for the index route,
//      which also marks the PADs and copies each key's lanes into one row
//      for the final gather.
//   2. the host (common/merge.py radix_passes) copies the histograms back
//      and keeps only the digits on which the non-PAD keys differ;
//      common/merge.py sort_route picks the route by L and E.
//   3. one launch per digit that runs. Tiles taken in order (lookback.cuh)
//      rank their keys stably per bin (warp ballots over the bin's bits,
//      per-warp bin counts), publish their bin counts, stage in shared
//      memory in sorted order, then find each bin's offset among the
//      earlier tiles by decoupled look-back (late, so few threads spin)
//      and scatter, each bin's run of the tile as contiguous writes. PAD is
//      bin 256, after 0xFF, in every pass: PADs end last in input order,
//      and a non-PAD key that reads 0xFF on every digit that runs still
//      sorts before them.
//      - The lanes route (lanes_pass_kernel, up to 3 lanes) moves every
//        lane and payload in every pass: 8 (L + E) bytes a key a pass.
//      - The index route sorts (lane value, 32-bit index) pairs one lane
//        at a time, least significant first: 16 bytes a key a pass
//        whatever L is. A lane's first pass (index_pass_kernel) reads the
//        lane through the index, so the gather happens inside the pass;
//        its later passes are lanes_pass_kernel<1> passes over the pairs;
//        a lane with no digit to run is never read. Then gather_kernel
//        writes the lanes, from the rows, and the payloads in sorted
//        order, once.
// What holds it back (PERF.md): the scatter's short runs (a tile of 4096
// keys leaves ~16 per bin) and each tile's chain of round trips; the
// histogram's shared-memory atomics; in the index route, the random
// 4-byte read of each lane's first pass (a 32-byte sector each: that
// pass takes about three times a later one).
// Element offsets, counts and the look-back's status words are 64-bit,
// so any N fits the lanes route; the index route takes N < 2^32.

#include <cstdint>
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kLanesRouteMax = 3;           // the lanes route's widest
constexpr int kChunk = 8;                   // lanes in registers at once
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 257;                  // 256 digit values + PAD
constexpr int kPadBin = 256;
constexpr int kNoBin = 257;                 // past N in the last tile
constexpr int kHistThreads = 512;
constexpr int kUnroll = 4;                  // histogram keys per thread
                                            // and round

// Keys per thread and pass tile, both routes. Only the keys' bins and
// positions sit in registers; the lanes and payloads stage in shared
// memory. Measured on the card (PERF.md): 8, 12 and 24 keys per thread
// were slower than 16 at L = 2, and 8 to 13 at L = 4.
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;

// Words a key's row of L lanes takes in the index route's row copy: a
// multiple of 4, so that rows start on 16 bytes.
__host__ __device__ constexpr int row_words(int L) { return (L + 3) / 4 * 4; }

// The lanes route's histogram: one block holds every lane of its keys
// (L <= kLanesRouteMax), tests them for PAD and counts the others.
__global__ void __launch_bounds__(kHistThreads)
lanes_hist_kernel(const uint32_t* __restrict__ x, long long n, int L,
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
    uint32_t v[kUnroll][kChunk];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * 32 + lane;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (j < L) v[u][j] = i < n ? x[j * n + i] : 0xFFFFFFFFu;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool valid = i0 + u * 32 + lane < n;
      bool pad = true;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (j < L) pad = pad && v[u][j] == 0xFFFFFFFFu;
      }
      const bool key = valid && !pad;
      const unsigned pads = __ballot_sync(0xffffffffu, valid && pad);
      const unsigned keys = __ballot_sync(0xffffffffu, key);
      if (lane == 0 && pads) {
        atomicAdd(&h[digits * 256], (uint32_t)__popc(pads));
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
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

// The index route's histogram, any L: one block counts the digits of one
// chunk of up to kChunk lanes (blockIdx.y), so that the histogram fits
// shared memory. Every valid key is counted, PAD or not: a PAD reads 0xFF
// in every digit, so the blocks of the first chunk, which test for PAD
// (reading the later lanes only where the first chunk's all read all
// ones), take their PADs out of bin 0xFF of every digit at the end and
// mark them in padmask. Where rows is not null, each block also writes
// its chunk of each key's row (row_words(L) words a key) for the final
// gather. Two keys a thread a round: with four, the values, the PAD
// test and the row stores spilled registers to the stack.
__global__ void __launch_bounds__(kHistThreads, 2)
index_hist_kernel(const uint32_t* __restrict__ x, long long n, int L,
                  unsigned long long* __restrict__ hist,
                  uint8_t* __restrict__ padmask,
                  uint32_t* __restrict__ rows) {
  constexpr int kKeys = 2;                    // keys a thread a round
  extern __shared__ uint32_t h[];             // [4 C][256] + [1] PAD
  const int c0 = blockIdx.y * kChunk;         // lanes [c0, c0 + C)
  const int C = min(kChunk, L - c0);
  const int digits = 4 * C;
  const bool pad_block = blockIdx.y == 0;
  for (int i = threadIdx.x; i <= digits * 256; i += kHistThreads) h[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int w = row_words(L);
  const long long stride = (long long)gridDim.x * kHistThreads * kKeys;
  for (long long i0 = ((long long)blockIdx.x * kHistThreads +
                       (threadIdx.x & ~31)) * kKeys;
       i0 < n; i0 += stride) {
    uint32_t v[kKeys][kChunk];
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      const long long i = i0 + u * 32 + lane;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        v[u][jj] = jj < C && i < n ? x[(c0 + jj) * n + i] : 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < kKeys; ++u) {
      const long long i = i0 + u * 32 + lane;
      const bool valid = i < n;
      if (rows && valid) {
        uint4* r = reinterpret_cast<uint4*>(rows + i * w + c0);
        r[0] = make_uint4(v[u][0], v[u][1], v[u][2], v[u][3]);
        if (C > 4) r[1] = make_uint4(v[u][4], v[u][5], v[u][6], v[u][7]);
      }
      if (pad_block) {
        bool pad = valid;
#pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          if (jj < C) pad = pad && v[u][jj] == 0xFFFFFFFFu;
        }
        // the later lanes of the PAD candidates, a chunk's loads at once
        for (int c = kChunk; c < L && __any_sync(0xffffffffu, pad);
             c += kChunk) {
          uint32_t m[kChunk];
#pragma unroll
          for (int jj = 0; jj < kChunk; ++jj) {
            m[jj] = pad && c + jj < L ? x[(c + jj) * n + i] : 0xFFFFFFFFu;
          }
#pragma unroll
          for (int jj = 0; jj < kChunk; ++jj) pad = pad && m[jj] == ~0u;
        }
        const unsigned pads = __ballot_sync(0xffffffffu, pad);
        if (lane == 0 && pads) {
          atomicAdd(&h[digits * 256], (uint32_t)__popc(pads));
        }
        if (padmask && valid) padmask[i] = pad;
      }
      const unsigned keys = __ballot_sync(0xffffffffu, valid);
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        if (jj >= C) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t b = (v[u][jj] >> (8 * q)) & 0xFFu;
          uint32_t* row = h + (4 * (C - 1 - jj) + q) * 256;
          const uint32_t b0 = __shfl_sync(0xffffffffu, b, 0);
          const unsigned same = __ballot_sync(0xffffffffu,
                                              valid && b == b0);
          if (same == keys) {
            if (lane == 0 && keys) {
              atomicAdd(&row[b0], (uint32_t)__popc(keys));
            }
          } else if (valid) {
            atomicAdd(&row[b], 1u);
          }
        }
      }
    }
  }
  __syncthreads();
  unsigned long long* chunk_hist = hist + (size_t)4 * (L - c0 - C) * 256;
  for (int i = threadIdx.x; i < digits * 256; i += kHistThreads) {
    if (h[i]) atomicAdd(&chunk_hist[i], (unsigned long long)h[i]);
  }
  const uint32_t pads = h[digits * 256];
  if (!pad_block || !pads) return;
  if (threadIdx.x == 0) {
    atomicAdd(&hist[4 * L * 256], (unsigned long long)pads);
  }
  // minus pads in bin 0xFF of every digit (mod 2^64: the sum of every
  // block's adds ends right)
  for (int d = threadIdx.x; d < 4 * L; d += kHistThreads) {
    atomicAdd(&hist[d * 256 + 255], 0ull - pads);
  }
}

// One pass tile's ranking state in shared memory.
struct PassTile {
  uint32_t warp_cnt[kWarps][kBins];           // counts, then offsets
  uint32_t bin_total[kBins];
  uint32_t bin_start[kBins];
  long long gbase[kBins];                     // out index - local position
  uint16_t sbin[kTile];
  unsigned long long scan_ull[kWarps + 1];
  uint32_t scan_u[kWarps + 1];
};

// Key i of this thread sits at tile position warp * 32 kItems + i * 32 +
// lane.
__device__ __forceinline__ int key_pos(int i) {
  return (threadIdx.x >> 5) * 32 * kItems + i * 32 + (threadIdx.x & 31);
}

// The digit's bin offsets over the whole array (an exclusive scan of its
// histogram: bin threadIdx.x's, returned) and the count of non-PAD keys;
// clears the warps' bin counts.
__device__ __forceinline__ unsigned long long digit_offsets(
    PassTile& t, const unsigned long long* __restrict__ hist, int digit,
    unsigned long long* keys_total) {
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) {
    (&t.warp_cnt[0][0])[i] = 0;
  }
  return mg::block_exclusive_scan<kThreads>(
      hist[digit * 256 + threadIdx.x], t.scan_ull, keys_total);
}

// Each key's bin: kNoBin past the tile's count, PAD (the first pass
// tests for it; later passes know PADs by position: they are last), else
// the digit.
__device__ __forceinline__ void key_bins(const uint32_t (&kv)[kItems],
                                         const bool (&pad)[kItems],
                                         int (&bin)[kItems], int cnt,
                                         long long base, int shift,
                                         bool pad_known,
                                         unsigned long long keys_total) {
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int p = key_pos(i);
    const bool is_pad = pad_known ? pad[i]
                                  : base + p >= (long long)keys_total;
    bin[i] = p >= cnt ? kNoBin
                      : (is_pad ? kPadBin : (int)((kv[i] >> shift) & 0xFFu));
  }
}

// Stable rank within the tile: the lanes of a warp that share a bin (9
// ballots over the bin's bits) take their places after the bin's count
// so far, which their lowest lane bumps; items in order, warps in order.
// Publishes the tile's count per bin for the look-back, then leaves in
// pos[i] each key's position in the tile's sorted order and in sbin its
// bin.
__device__ __forceinline__ void rank_tile(PassTile& t,
                                          const int (&bin)[kItems],
                                          int (&pos)[kItems], unsigned tile,
                                          mg::Word* status) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
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
      before = atomicAdd(&t.warp_cnt[warp][bin[i]], (uint32_t)__popc(peers));
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
      const uint32_t c = t.warp_cnt[w][b];
      t.warp_cnt[w][b] = run;
      run += c;
    }
    t.bin_total[b] = run;
    mg::publish(status, kBins, tile, b, run);
  }
  __syncthreads();
  // the bins' starts inside the tile, PAD's after all 256 others
  uint32_t tile_keys;
  t.bin_start[threadIdx.x] = mg::block_exclusive_scan<kThreads>(
      t.bin_total[threadIdx.x], t.scan_u, &tile_keys);
  if (threadIdx.x == 0) t.bin_start[kPadBin] = tile_keys;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (bin[i] == kNoBin) continue;
    pos[i] += (int)(t.bin_start[bin[i]] + t.warp_cnt[warp][bin[i]]);
    t.sbin[pos[i]] = (uint16_t)bin[i];
  }
}

// After rank_tile and the stage: each bin's write offset (gbase: out
// index - local position) from the earlier tiles' counts by look-back;
// PAD after every non-PAD key. Ends with the block in step.
__device__ __forceinline__ void tile_offsets(PassTile& t, unsigned tile,
                                             mg::Word* status,
                                             unsigned long long doff,
                                             unsigned long long keys_total) {
  for (int b = threadIdx.x; b < kBins; b += kThreads) {
    const long long off = b == kPadBin ? (long long)keys_total
                                       : (long long)doff;
    t.gbase[b] = off - t.bin_start[b] +
                 (long long)mg::lookback(status, kBins, tile, b,
                                         t.bin_total[b]);
  }
  __syncthreads();
}

// The lanes route: one pass moves all L lanes and the payloads.
template <int L>
__global__ void __launch_bounds__(kThreads)
lanes_pass_kernel(const uint32_t* __restrict__ src, long long n,
                  const uint32_t* __restrict__ se0,
                  const uint32_t* __restrict__ se1, int n_extra,
                  uint32_t* __restrict__ dst, uint32_t* __restrict__ de0,
                  uint32_t* __restrict__ de1,
                  const unsigned long long* __restrict__ hist, int digit,
                  int first_pass, mg::Word* __restrict__ status,
                  unsigned* __restrict__ counter) {
  extern __shared__ uint32_t stage[];        // [L + n_extra][kTile]
  __shared__ PassTile t;

  const unsigned tile = mg::take_tile(counter);
  const long long base = (long long)tile * kTile;
  const int cnt = (int)min((long long)kTile, n - base);

  // the keys' digit lane first, so that its loads are in flight while
  // the block scans the histogram. The first pass tests every lane for
  // PAD; each pass leaves the PADs last, so later passes know them by
  // position.
  const uint32_t* dlane = src + (long long)(L - 1 - digit / 4) * n;
  uint32_t kv[kItems];
  bool pad[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int p = key_pos(i);
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
  unsigned long long keys_total;
  const unsigned long long doff = digit_offsets(t, hist, digit, &keys_total);
  int bin[kItems];
  key_bins(kv, pad, bin, cnt, base, 8 * (digit % 4), first_pass != 0,
           keys_total);
  int pos[kItems];
  rank_tile(t, bin, pos, tile, status);

  // stage every lane and payload at the key's sorted position (all of a
  // thread's loads in flight at once)
#pragma unroll
  for (int j = 0; j < L; ++j) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (bin[i] != kNoBin) {
        stage[j * kTile + pos[i]] = src[j * n + base + key_pos(i)];
      }
    }
  }
  for (int e = 0; e < n_extra; ++e) {
    const uint32_t* se = e ? se1 : se0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (bin[i] != kNoBin) {
        stage[(L + e) * kTile + pos[i]] = se[base + key_pos(i)];
      }
    }
  }
  tile_offsets(t, tile, status, doff, keys_total);

  // scatter: each bin's run of the tile leaves as contiguous writes,
  // cached in L2 only (st.cg: measured 7-10 % faster at L = 4), where the
  // runs of neighbouring tiles meet
  for (int p = threadIdx.x; p < cnt; p += kThreads) {
    const long long g = t.gbase[t.sbin[p]] + p;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      __stcg(&dst[j * n + g], stage[j * kTile + p]);
    }
    if (n_extra > 0) __stcg(&de0[g], stage[L * kTile + p]);
    if (n_extra > 1) __stcg(&de1[g], stage[(L + 1) * kTile + p]);
  }
}

// The index route's first pass of a lane: `digit` of lane j = L - 1 -
// digit / 4 sorts (value, index) pairs whose values it reads through the
// index, x[j][iin[i]], or, with iin == nullptr (the sort's first pass),
// straight from the lane, the index being the identity. vout ==
// nullptr: the lane has no other pass; only the index is written. Later
// passes of the lane run lanes_pass_kernel<1> on the pairs (the value as
// its lane, the index as its payload), which measured 0.43 ms a pass at
// 2^25 keys against 0.66 for this kernel. padmask != nullptr: the sort's
// first pass where PADs are present; a key is PAD where the histogram's
// mask says so (measured 1-2 % faster than testing the other lanes where
// this one reads all ones).
__global__ void __launch_bounds__(kThreads)
index_pass_kernel(const uint32_t* __restrict__ x, long long n, int L,
                  const uint32_t* __restrict__ iin,
                  uint32_t* __restrict__ vout, uint32_t* __restrict__ iout,
                  const unsigned long long* __restrict__ hist, int digit,
                  const uint8_t* __restrict__ padmask,
                  mg::Word* __restrict__ status,
                  unsigned* __restrict__ counter) {
  extern __shared__ uint32_t stage[];        // [2][kTile]: value, index
  __shared__ PassTile t;

  const unsigned tile = mg::take_tile(counter);
  const long long base = (long long)tile * kTile;
  const int cnt = (int)min((long long)kTile, n - base);

  // the keys' values, the index's loads and then the gather's each all
  // in flight at once
  const uint32_t* xl = x + (long long)(L - 1 - digit / 4) * n;
  uint32_t kv[kItems];
  bool pad[kItems];
  if (iin) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int p = key_pos(i);
      kv[i] = p < cnt ? iin[base + p] : 0u;
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (key_pos(i) < cnt) kv[i] = xl[kv[i]];
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int p = key_pos(i);
      kv[i] = p < cnt ? xl[base + p] : 0u;
    }
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int p = key_pos(i);
    pad[i] = padmask && p < cnt && padmask[base + p] != 0;
  }
  unsigned long long keys_total;
  const unsigned long long doff = digit_offsets(t, hist, digit, &keys_total);
  int bin[kItems];
  key_bins(kv, pad, bin, cnt, base, 8 * (digit % 4), padmask != nullptr,
           keys_total);
  int pos[kItems];
  rank_tile(t, bin, pos, tile, status);

#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (bin[i] == kNoBin) continue;
    const long long g = base + key_pos(i);
    if (vout) stage[pos[i]] = kv[i];
    stage[kTile + pos[i]] = iin ? iin[g] : (uint32_t)g;
  }
  tile_offsets(t, tile, status, doff, keys_total);

  for (int p = threadIdx.x; p < cnt; p += kThreads) {
    const long long g = t.gbase[t.sbin[p]] + p;
    if (vout) __stcg(&vout[g], stage[p]);
    __stcg(&iout[g], stage[kTile + p]);
  }
}

// The sorted keys: out[j][i] = x[j][idx[i]] for the L lanes, read from
// the histogram's row copy (one key's lanes in one row: one or two
// 32-byte sectors a key where the lanes themselves cost one a lane), and
// the 0-2 payloads; one key a thread, the writes coalesced.
__global__ void __launch_bounds__(kThreads)
gather_kernel(const uint32_t* __restrict__ rows, long long n, int L,
              const uint32_t* __restrict__ idx,
              const uint32_t* __restrict__ e0,
              const uint32_t* __restrict__ e1, int n_extra,
              uint32_t* __restrict__ out, uint32_t* __restrict__ eo0,
              uint32_t* __restrict__ eo1) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long s = idx[i];
  uint32_t p0 = 0, p1 = 0;
  if (n_extra > 0) p0 = e0[s];
  if (n_extra > 1) p1 = e1[s];
  const uint4* r = reinterpret_cast<const uint4*>(rows + s * row_words(L));
  for (int c = 0; c < L; c += kChunk) {
    const uint4 a = r[c / 4];
    const uint4 b = c + 4 < L ? r[c / 4 + 1] : make_uint4(0, 0, 0, 0);
    const uint32_t v[kChunk] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj) {
      if (c + jj < L) out[(c + jj) * n + i] = v[jj];
    }
  }
  if (n_extra > 0) eo0[i] = p0;
  if (n_extra > 1) eo1[i] = p1;
}

// Zero the status words and, after them, the tile counter.
cudaError_t clear_status(void* status, long long tiles, cudaStream_t s) {
  return cudaMemsetAsync(status, 0,
                         (size_t)(tiles * kBins + 1) * sizeof(mg::Word), s);
}

// Each pass kernel's dynamic stage with its static tile state exceeds
// 48 KB: opt in, at the most stage it takes.
template <int L>
cudaError_t set_lanes_smem() {
  return cudaFuncSetAttribute(
      lanes_pass_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)((L + 2) * kTile * sizeof(uint32_t)));
}
cudaError_t set_index_smem() {
  return cudaFuncSetAttribute(
      index_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(2 * kTile * sizeof(uint32_t)));
}

template <int L>
cudaError_t launch_lanes_pass(const void* src, long long n, const void* se0,
                              const void* se1, int n_extra, void* dst,
                              void* de0, void* de1, const void* hist,
                              int digit, int first_pass, void* status,
                              cudaStream_t s) {
  const long long tiles = (n + kTile - 1) / kTile;
  const size_t smem = (size_t)(L + n_extra) * kTile * sizeof(uint32_t);
  cudaError_t err = set_lanes_smem<L>();
  if (err != cudaSuccess) return err;
  err = clear_status(status, tiles, s);
  if (err != cudaSuccess) return err;
  mg::Word* st = (mg::Word*)status;
  lanes_pass_kernel<L><<<(unsigned)tiles, kThreads, smem, s>>>(
      (const uint32_t*)src, n, (const uint32_t*)se0, (const uint32_t*)se1,
      n_extra, (uint32_t*)dst, (uint32_t*)de0, (uint32_t*)de1,
      (const unsigned long long*)hist, digit, first_pass, st,
      (unsigned*)(st + tiles * kBins));
  return cudaGetLastError();
}

}  // namespace

// Keys per pass tile (either route): the wrapper sizes the status words
// as ceil(n / tile) * 257 + 1 int64.
extern "C" int mg_sort_tile() { return kTile; }

// The widest keys (lanes) the lanes route takes.
extern "C" int mg_sort_lanes_route_max() { return kLanesRouteMax; }

// Words a key's row takes in the histogram's row copy of L lanes.
extern "C" int mg_sort_row_words(int L) { return row_words(L); }

// Resident blocks per SM of the pass kernel: the lanes route's at L
// lanes and E payloads, or (L = 0) the index route's; -1 on an error.
extern "C" int mg_sort_blocks_per_sm(int L, int n_extra) {
  int blocks = 0;
  cudaError_t err;
  switch (L) {
    case 0:
      err = set_index_smem();
      if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, index_pass_kernel, kThreads,
            2 * kTile * sizeof(uint32_t));
      }
      break;
#define MG_OCC(LL)                                                        \
  case LL:                                                                \
    err = set_lanes_smem<LL>();                                           \
    if (err == cudaSuccess) {                                             \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                \
          &blocks, lanes_pass_kernel<LL>, kThreads,                       \
          (LL + n_extra) * kTile * sizeof(uint32_t));                     \
    }                                                                     \
    break;
    MG_OCC(1) MG_OCC(2) MG_OCC(3)
#undef MG_OCC
    default:
      return -1;
  }
  return err == cudaSuccess ? blocks : -1;
}

// hist (4 L * 256 + 1) uint64: per digit (digit 0 = the low byte of lane
// L - 1) the counts of the non-PAD keys in each bin, then the PAD count.
// With padmask null, the lanes route's histogram (L <= its widest);
// else the index route's (any L): padmask gets one byte a key, 1 for
// PAD, and rows, where not null, n rows of mg_sort_row_words(L) words,
// each key's lanes. Returns the first error (cudaError_t), 0 on success.
extern "C" int mg_sort_hist(const void* x, long long n, int L, void* hist,
                            void* padmask, void* rows, void* stream) {
  if (L < 1 || n < 0 || (!padmask && (rows || L > kLanesRouteMax))) {
    return (int)cudaErrorInvalidValue;
  }
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
  if (!padmask) {
    lanes_hist_kernel<<<(unsigned)blocks, kHistThreads,
                        words * sizeof(uint32_t), s>>>(
        (const uint32_t*)x, n, L, (unsigned long long*)hist);
    return (int)cudaGetLastError();
  }
  const int chunks = (L + kChunk - 1) / kChunk;
  const size_t smem = ((size_t)4 * min(L, kChunk) * 256 + 1) *
                      sizeof(uint32_t);
  index_hist_kernel<<<dim3((unsigned)blocks, (unsigned)chunks),
                      kHistThreads, smem, s>>>(
      (const uint32_t*)x, n, L, (unsigned long long*)hist,
      (uint8_t*)padmask, (uint32_t*)rows);
  return (int)cudaGetLastError();
}

// One stable pass of the lanes route on `digit`: src (L, n) lanes and 0-2
// payloads (n,) -> dst, with hist from mg_sort_hist and status of
// ceil(n / tile) * 257 + 1 int64 of scratch. `first_pass` makes it test
// every lane for PAD; it may be 0 when src holds no PAD or the output of
// an earlier pass (its PADs last, known by position). Returns the first
// error (cudaError_t), 0 on success.
extern "C" int mg_sort_pass(const void* src, long long n, int L,
                            const void* se0, const void* se1, int n_extra,
                            void* dst, void* de0, void* de1,
                            const void* hist, int digit, int first_pass,
                            void* status, void* stream) {
  if (L < 1 || L > kLanesRouteMax || n_extra < 0 || n_extra > 2 || n < 1 ||
      digit < 0 || digit >= 4 * L) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (L) {
#define MG_PASS(LL)                                                       \
  case LL:                                                                \
    err = launch_lanes_pass<LL>(src, n, se0, se1, n_extra, dst, de0, de1, \
                                hist, digit, first_pass, status, s);      \
    break;
    MG_PASS(1) MG_PASS(2) MG_PASS(3)
#undef MG_PASS
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

// The index route's first pass of a lane on `digit` (see
// index_pass_kernel): x (L, n) keys, iin (n,) the previous passes' index
// (null on the sort's first pass), vout / iout (n,) this pass's values
// and indices (vout null where the lane has no other pass), padmask (n,)
// the histogram's PAD mask on the sort's first pass (else null), hist
// and status as for mg_sort_pass. n < 2^32. Returns the first error
// (cudaError_t), 0 on success.
extern "C" int mg_sort_index_pass(const void* x, long long n, int L,
                                  const void* iin, void* vout, void* iout,
                                  const void* hist, int digit,
                                  const void* padmask, void* status,
                                  void* stream) {
  if (L < 1 || n < 1 || n > 0xFFFFFFFFLL || digit < 0 || digit >= 4 * L ||
      !iout || (padmask && iin)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = (n + kTile - 1) / kTile;
  cudaError_t err = set_index_smem();
  if (err != cudaSuccess) return (int)err;
  err = clear_status(status, tiles, s);
  if (err != cudaSuccess) return (int)err;
  mg::Word* st = (mg::Word*)status;
  index_pass_kernel<<<(unsigned)tiles, kThreads,
                      2 * kTile * sizeof(uint32_t), s>>>(
      (const uint32_t*)x, n, L, (const uint32_t*)iin, (uint32_t*)vout,
      (uint32_t*)iout, (const unsigned long long*)hist, digit,
      (const uint8_t*)padmask, st, (unsigned*)(st + tiles * kBins));
  return (int)cudaGetLastError();
}

// The sorted keys of the index route: out[j][i] = x[j][idx[i]] for the L
// lanes, read from rows (mg_sort_hist's row copy of x), and the 0-2
// payloads (e0, e1 -> eo0, eo1). n < 2^32. Returns the first error
// (cudaError_t), 0 on success.
extern "C" int mg_sort_gather(const void* rows, long long n, int L,
                              const void* idx, const void* e0,
                              const void* e1, int n_extra, void* out,
                              void* eo0, void* eo1, void* stream) {
  if (L < 1 || n < 0 || n > 0xFFFFFFFFLL || n_extra < 0 || n_extra > 2) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  gather_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                  (cudaStream_t)stream>>>(
      (const uint32_t*)rows, n, L, (const uint32_t*)idx,
      (const uint32_t*)e0, (const uint32_t*)e1, n_extra, (uint32_t*)out,
      (uint32_t*)eo0, (uint32_t*)eo1);
  return (int)cudaGetLastError();
}
