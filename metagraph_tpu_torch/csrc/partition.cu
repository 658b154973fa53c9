// Stable partition (compaction) of packed uint32 lanes by a keep mask.
//
// Replaces the Pallas kernel metagraph_tpu/common/merge.py
// _partition_call / _make_partition_kernel (reached from
// partition_compact). Semantics: every kept entry moves to the front in
// its original order; lanes past the count are PAD (0xFFFFFFFF) and
// payloads past it are `extra_fill`; entries at or past `capacity` are
// dropped, while the count written back is the TRUE count.
//
// What bounds it on the card: memory bandwidth. It reads
// (L+E)*4*N + N bytes (the keep mask twice: N more) and writes
// (L+E)*4*capacity bytes, with no arithmetic to speak of. The design
// therefore streams every array once, coalesced, in three launches:
//   1. count: per block of TILE entries, warp __ballot_sync + __popc;
//   2. scan: one block turns the block counts into exclusive offsets
//      and writes the true count (a device int32, so the host syncs
//      only where it needs the number);
//   3. scatter: each block re-ranks its tile round by round (ballot
//      rank inside the warp + warp totals in shared memory), which keeps
//      the order stable, and writes kept entries to offset + rank.
// A fourth launch fills [min(count, capacity), capacity) with PAD and
// extra_fill, reading the count from device memory.
// The TPU kernel's bit-shift compaction rounds, MXU prefix matmul and
// SMEM carry existed because a TPU grid runs in order; CUDA blocks do
// not, so the cross-block order comes from the scan instead.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                    // rounds per block
constexpr int kTile = kThreads * kItems;     // entries per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLanes = 8;
constexpr int kScanThreads = 1024;

__global__ void count_kernel(const uint8_t* __restrict__ keep, long long n,
                             int* __restrict__ block_counts) {
  __shared__ int warp_tot[kWarps];
  const long long base = (long long)blockIdx.x * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int acc = 0;
  for (int it = 0; it < kItems; ++it) {
    const long long i = base + (long long)it * kThreads + threadIdx.x;
    const bool k = i < n && keep[i] != 0;
    const unsigned bal = __ballot_sync(0xffffffffu, k);
    acc += __popc(bal);
  }
  if (lane == 0) warp_tot[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += warp_tot[w];
    block_counts[blockIdx.x] = s;
  }
}

// One block: exclusive scan of `g` block counts in place; total -> *count.
__global__ void scan_kernel(int* __restrict__ counts, int g,
                            int* __restrict__ count_out) {
  __shared__ int part[kScanThreads];
  const int per = (g + kScanThreads - 1) / kScanThreads;
  const int lo = threadIdx.x * per;
  const int hi = min(lo + per, g);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += counts[i];
  part[threadIdx.x] = s;
  __syncthreads();
  // Hillis-Steele inclusive scan over the per-thread sums
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const int v = threadIdx.x >= off ? part[threadIdx.x - off] : 0;
    __syncthreads();
    part[threadIdx.x] += v;
    __syncthreads();
  }
  int run = threadIdx.x ? part[threadIdx.x - 1] : 0;
  for (int i = lo; i < hi; ++i) {
    const int c = counts[i];
    counts[i] = run;
    run += c;
  }
  if (threadIdx.x == kScanThreads - 1) *count_out = part[kScanThreads - 1];
}

__global__ void scatter_kernel(const uint32_t* __restrict__ lanes, int L,
                               long long n, const uint8_t* __restrict__ keep,
                               const uint32_t* __restrict__ ex0,
                               const uint32_t* __restrict__ ex1, int n_extra,
                               uint32_t* __restrict__ out,
                               uint32_t* __restrict__ oex0,
                               uint32_t* __restrict__ oex1,
                               long long capacity,
                               const int* __restrict__ offsets) {
  __shared__ int warp_tot[kWarps];
  __shared__ int warp_off[kWarps + 1];
  const long long base = (long long)blockIdx.x * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long run = offsets[blockIdx.x];
  for (int it = 0; it < kItems; ++it) {
    const long long i = base + (long long)it * kThreads + threadIdx.x;
    const bool k = i < n && keep[i] != 0;
    const unsigned bal = __ballot_sync(0xffffffffu, k);
    if (lane == 0) warp_tot[warp] = __popc(bal);
    __syncthreads();
    if (threadIdx.x == 0) {
      int s = 0;
      for (int w = 0; w < kWarps; ++w) {
        warp_off[w] = s;
        s += warp_tot[w];
      }
      warp_off[kWarps] = s;
    }
    __syncthreads();
    if (k) {
      const long long pos =
          run + warp_off[warp] + __popc(bal & ((1u << lane) - 1u));
      if (pos < capacity) {
        for (int j = 0; j < L; ++j) out[j * capacity + pos] = lanes[j * n + i];
        if (n_extra > 0) oex0[pos] = ex0[i];
        if (n_extra > 1) oex1[pos] = ex1[i];
      }
    }
    run += warp_off[kWarps];
    __syncthreads();
  }
}

__global__ void fill_kernel(int L, uint32_t* __restrict__ out,
                            uint32_t* __restrict__ oex0,
                            uint32_t* __restrict__ oex1, int n_extra,
                            long long capacity, uint32_t extra_fill,
                            const int* __restrict__ count) {
  const long long start = *count;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < capacity; p += stride) {
    if (p < start) continue;
    for (int j = 0; j < L; ++j) out[j * capacity + p] = 0xFFFFFFFFu;
    if (n_extra > 0) oex0[p] = extra_fill;
    if (n_extra > 1) oex1[p] = extra_fill;
  }
}

}  // namespace

// Entries per block: the wrapper sizes block_counts as ceil(n / tile).
extern "C" int mg_partition_tile() { return kTile; }

// lanes (L, n) and payloads (n,) in; out (L, capacity) and payloads
// (capacity,) out; block_counts holds ceil(n / tile) ints of scratch;
// *count_out receives the true kept count. Returns cudaGetLastError().
extern "C" int mg_partition(const void* lanes, int L, long long n,
                            const void* keep, const void* ex0,
                            const void* ex1, int n_extra, void* out,
                            void* oex0, void* oex1, long long capacity,
                            unsigned int extra_fill, void* block_counts,
                            void* count_out, void* stream) {
  if (L < 1 || L > kMaxLanes || n_extra < 0 || n_extra > 2) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const long long g = (n + kTile - 1) / kTile;
  int* bc = (int*)block_counts;
  int* cnt = (int*)count_out;
  if (g > 0) {
    count_kernel<<<(unsigned)g, kThreads, 0, s>>>((const uint8_t*)keep, n, bc);
    scan_kernel<<<1, kScanThreads, 0, s>>>(bc, (int)g, cnt);
    scatter_kernel<<<(unsigned)g, kThreads, 0, s>>>(
        (const uint32_t*)lanes, L, n, (const uint8_t*)keep,
        (const uint32_t*)ex0, (const uint32_t*)ex1, n_extra, (uint32_t*)out,
        (uint32_t*)oex0, (uint32_t*)oex1, capacity, bc);
  } else {
    cudaMemsetAsync(cnt, 0, sizeof(int), s);
  }
  if (capacity > 0) {
    long long blocks = (capacity + kThreads - 1) / kThreads;
    if (blocks > 65535LL * 16) blocks = 65535LL * 16;
    fill_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        L, (uint32_t*)out, (uint32_t*)oex0, (uint32_t*)oex1, n_extra,
        capacity, extra_fill, cnt);
  }
  return (int)cudaGetLastError();
}
