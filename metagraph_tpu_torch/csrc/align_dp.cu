// Batched semi-global affine-gap alignment scoring, one warp per pair.
//
// Replaces the Pallas kernel metagraph_tpu/align/pallas_dp.py
// _score_kernel (reached from batch_align_scores and batch_align_ends).
// For every (query, ref) pair it sweeps the ref one column at a time
// and returns the best cell of the H matrix; with `with_ends` also the
// cell's (r_end, q_end) by np.argmax's row-major first-max rule:
//
//   H0[j] = 0 at j = 0, else -open - (j-1)*ext  (j <= qlen);  D0 = NEG
//   column t < rlen, ref char c:
//     Dn[j] = max(H[j] - open, D[j] - ext)
//     Hn[0] = Dn[0];  Hn[j] = max(H[j-1] + sub(q[j-1], c), Dn[j])
//     I[j]  = max_{j'<j} Hn[j'] + j'*ext  - j*ext - (open - ext)
//     H[j]  = max(Hn[j], I[j])
//   a column replaces the best only if its max is strictly greater;
//   within a column the smallest j among the maxima wins; bt = t + 1.
// I is taken over Hn before insertions, as the TPU kernel's prefix max
// does (not Gotoh over the final H, which differs when open < ext).
// Cells past qlen are never computed into the best: no valid cell reads
// them.
//
// What bounds it on the card: integer operations. A pair needs
// rlen * (qlen + 1) cells; the operations per cell that the function
// needs are counted once, at OPS_PER_CELL in align/pallas_dp.py. The
// bytes, R * (LQ + LR + 3) * 4, are negligible.
//
// Two routes, chosen by the wrapper from LQ:
//
// * wave_kernel (LQ + 1 <= 256): a wavefront over query-row bands held
//   in registers. Lane i owns rows [i*P, (i+1)*P), P the smallest of 1,
//   2, 4, 8 with 32*P >= qlen + 1 (a switch over a templated function,
//   per pair), and computes column t = s - i at step s. From lane i - 1
//   it takes, by __shfl_up_sync, the ref char (lane 0 reads it from 32
//   chars the warp loads ahead), the bottom row's H at column t (its
//   diagonal at t + 1) and the insertion carry at column t. The
//   insertions run down the band as the sequential recurrence over Hn,
//   I[j] = max(Hn[j-1] - open, I[j-1] - ext) with I[0] = NEG - (open -
//   ext), which unrolls to the prefix max above for any open and ext
//   (while H stays above NEG, as the plain version's masking assumes).
//   A lane visits its cells in (t, j) order and keeps its first strictly
//   greater H; one butterfly at the end, by (value desc, t asc, j asc),
//   gives the first max of the matrix. No shared memory holds a column,
//   and no step waits on a warp-wide scan or reduce: besides its cells a
//   step costs four shuffles (the ref char's broadcast and shift, the H
//   and the carry). The max-adds are Hopper's DPX __viaddmax_s32.
// * long_kernel (any LQ): the first design. Each lane owns a contiguous
//   chunk of the column; the cell left of a chunk crosses the lane
//   border by a read of the neighbour's old H before a __syncwarp. Pass
//   A computes Dn and Hn and the chunk's max of Hn + j*ext; a 5-step
//   __shfl_up_sync scan turns the lane carries into exclusive prefix
//   maxima; pass B applies I and finds the chunk's first max, and a
//   butterfly (max desc, j asc) gives the column's argmax to every lane.
//   H, D and the query (bytes) sit in shared memory while four pairs fit
//   in 48 KB, else H and D live in a scratch buffer the wrapper
//   allocates, so no query length is refused.
//
// The substitution scores come from a sigma x sigma table in shared
// memory (the DNA table is built from the penalties by the wrapper), so
// DNA, unit and BLOSUM62 scoring share the kernels. The TPU kernel's
// ref-tile rotation (pltpu.roll) and its 8-row tiles are gone: a warp
// reads its ref chars directly.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kNeg = -100000000;          // the TPU kernel's NEG
constexpr int kMaxSigma = 32;
// dynamic shared memory a block may take without an opt-in, beside the
// static table
constexpr int kSmemLimit = 48 * 1024 - kMaxSigma * kMaxSigma * 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWaveRows = 8;              // the widest band: 32 x 8 rows

struct Args {
  const int* q;          // (R, LQ) codes
  const int* r;          // (R, LR) codes
  const int* qlen;       // (R,)
  const int* rlen;       // (R,)
  const int* table;      // (sigma, sigma): table[a * sigma + b] = sub(a, b)
  int sigma;
  long long R;
  int LQ, LR;
  int open_p, ext_p;
  int with_ends;
  int* out;              // (R,) or (R, 3)
  int* scratch;          // (R, 2, LQ + 1) when the columns are not in smem
};

__host__ __device__ inline long long warp_bytes(int LQ) {
  return 2LL * (LQ + 1) * 4 + ((LQ + 3) & ~3);
}

__device__ inline void warp_argmax(int& v, int& j) {
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_xor_sync(kFull, v, off);
    const int oj = __shfl_xor_sync(kFull, j, off);
    if (ov > v || (ov == v && oj < j)) {
      v = ov;
      j = oj;
    }
  }
}

__device__ inline int clamp_code(int c, int sigma) {
  return min(max(c, 0), sigma - 1);
}

// max(a + b, c) as one DPX instruction: 1-2 % faster than max(a + b, c)
// in the wave route on the H100 (scripts/time_align_dp.py, no-dpx)
__device__ inline int add_max(int a, int b, int c) {
  return __viaddmax_s32(a, b, c);
}

// The pair's wavefront with P rows per lane (see the file's head).
template <int P>
__device__ void wave_pair(const Args& a, const int* tab, long long pair,
                          int lane, int qlen, int rlen) {
  const int sigma = a.sigma;
  const int open = a.open_p;
  const int ext = a.ext_p;
  const int* qg = a.q + pair * a.LQ;
  const int* rg = a.r + pair * a.LR;
  const int j0 = lane * P;
  const int n_valid = min(max(qlen + 1 - j0, 0), P);   // rows <= qlen
  // qrow: the byte offset of the row's query code in the table, so that
  // a cell's score is one add and one shared load
  int H[P], D[P], qrow[P];
  int bv = INT_MIN, bpos = 0;            // bpos = bt * kWaveRows + row
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int j = j0 + p;
    H[p] = j == 0 ? 0 : -open - (j - 1) * ext;
    D[p] = kNeg;
    qrow[p] = (j >= 1 && j <= qlen)
                  ? clamp_code(qg[j - 1], sigma) * sigma * (int)sizeof(int)
                  : 0;
    if (p < n_valid && H[p] > bv) {
      bv = H[p];
      bpos = p;
    }
  }
  // the diagonal of the band's top row: H of row j0 - 1, column 0
  int up = j0 <= 1 ? 0 : -open - (j0 - 2) * ext;
  const int lanes = (qlen + P) / P;      // lanes that hold a valid row
  const int steps = rlen > 0 ? rlen + lanes - 1 : 0;
  const int i_seed = kNeg - (open - ext);
  int ref_now = lane < rlen ? clamp_code(rg[lane], sigma) : 0;
  int ref_next = 32 + lane < rlen ? clamp_code(rg[32 + lane], sigma) : 0;
  int c = 0, h_out = 0, i_out = 0;
  for (int s = 0; s < steps; ++s) {
    if ((s & 31) == 0 && s > 0) {
      ref_now = ref_next;
      ref_next = s + 32 + lane < rlen ? clamp_code(rg[s + 32 + lane], sigma)
                                      : 0;
    }
    const int c0 = __shfl_sync(kFull, ref_now, s & 31);
    c = __shfl_up_sync(kFull, c, 1);
    const int h_in = __shfl_up_sync(kFull, h_out, 1);
    int I = __shfl_up_sync(kFull, i_out, 1);
    if (lane == 0) {
      c = c0;
      I = i_seed;
    }
    const int t = s - lane;
    if (t >= 0 && t < rlen && lane < lanes) {
      const char* sub = (const char*)(tab + c);
      const int base = (t + 1) * kWaveRows;
      int diag = up;
      int hn_prev = 0;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int h_old = H[p];
        const int dn = add_max(h_old, -open, D[p] - ext);
        int hn = add_max(diag, *(const int*)(sub + qrow[p]), dn);
        if (p == 0) {
          if (lane == 0) hn = dn;          // row 0 has no diagonal
        } else {
          I = add_max(hn_prev, -open, I - ext);
        }
        const int h = max(hn, I);
        diag = h_old;
        hn_prev = hn;
        H[p] = h;
        D[p] = dn;
        if (p < n_valid && h > bv) {
          bv = h;
          bpos = base + p;
        }
      }
      i_out = add_max(hn_prev, -open, I - ext);
      h_out = H[P - 1];
      up = h_in;
    }
  }
  // first max of the matrix: value desc, then t asc, then j asc
  int bt = bpos / kWaveRows;
  int bj = j0 + bpos % kWaveRows;
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_xor_sync(kFull, bv, off);
    const int ot = __shfl_xor_sync(kFull, bt, off);
    const int oj = __shfl_xor_sync(kFull, bj, off);
    if (ov > bv || (ov == bv && (ot < bt || (ot == bt && oj < bj)))) {
      bv = ov;
      bt = ot;
      bj = oj;
    }
  }
  if (lane == 0) {
    if (a.with_ends) {
      a.out[pair * 3 + 0] = bv;
      a.out[pair * 3 + 1] = bt;
      a.out[pair * 3 + 2] = bj;
    } else {
      a.out[pair] = bv;
    }
  }
}

__global__ void __launch_bounds__(kThreads) wave_kernel(Args a) {
  __shared__ int tab[kMaxSigma * kMaxSigma];
  const int sigma = a.sigma;
  for (int i = threadIdx.x; i < sigma * sigma; i += kThreads) {
    tab[i] = a.table[i];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long pair = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (pair >= a.R) return;                 // the whole warp leaves
  const int qlen = min(max(a.qlen[pair], 0), a.LQ);
  const int rlen = min(max(a.rlen[pair], 0), a.LR);
  if (qlen < 32) {
    wave_pair<1>(a, tab, pair, lane, qlen, rlen);
  } else if (qlen < 64) {
    wave_pair<2>(a, tab, pair, lane, qlen, rlen);
  } else if (qlen < 128) {
    wave_pair<4>(a, tab, pair, lane, qlen, rlen);
  } else {
    wave_pair<kWaveRows>(a, tab, pair, lane, qlen, rlen);
  }
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads) long_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int tab[kMaxSigma * kMaxSigma];
  const int sigma = a.sigma;
  for (int i = threadIdx.x; i < sigma * sigma; i += kThreads) {
    tab[i] = a.table[i];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long pair = (long long)blockIdx.x * kWarps + warp;
  if (pair >= a.R) return;                 // the whole warp leaves

  const int LQ1 = a.LQ + 1;
  const int* qg = a.q + pair * a.LQ;
  const int* rg = a.r + pair * a.LR;
  int* H;
  int* D;
  unsigned char* qs = nullptr;
  if (kSmem) {
    unsigned char* base = smem + warp * warp_bytes(a.LQ);
    H = (int*)base;
    D = H + LQ1;
    qs = (unsigned char*)(D + LQ1);
  } else {
    H = a.scratch + pair * 2 * LQ1;
    D = H + LQ1;
  }
  const int qlen = min(max(a.qlen[pair], 0), a.LQ);
  const int rlen = min(max(a.rlen[pair], 0), a.LR);
  const int open = a.open_p;
  const int ext = a.ext_p;
  const int n = qlen + 1;
  const int chunk = (n + 31) >> 5;
  const int lo = min(lane * chunk, n);
  const int hi = min(lo + chunk, n);

  for (int j = lo; j < hi; ++j) {
    H[j] = j == 0 ? 0 : -open - (j - 1) * ext;
    D[j] = kNeg;
  }
  if (kSmem) {
    for (int j = lane; j < qlen; j += 32) {
      qs[j] = (unsigned char)clamp_code(qg[j], sigma);
    }
  }
  __syncwarp();

  int bv = INT_MIN, bj = INT_MAX;
  for (int j = lo; j < hi; ++j) {
    if (H[j] > bv) {
      bv = H[j];
      bj = j;
    }
  }
  warp_argmax(bv, bj);
  int best = bv, best_t = 0, best_j = bj;

  for (int t = 0; t < rlen; ++t) {
    const int c = clamp_code(rg[t], sigma);
    int prev_old = (lo > 0 && lo < hi) ? H[lo - 1] : 0;
    __syncwarp();                          // every border read is done
    // pass A: Dn, Hn (before insertions), and the chunk's carry
    int carry = kNeg;
    for (int j = lo; j < hi; ++j) {
      const int h_old = H[j];
      const int dn = max(h_old - open, D[j] - ext);
      int hn = dn;
      if (j > 0) {
        const int qc = kSmem ? (int)qs[j - 1] : clamp_code(qg[j - 1], sigma);
        hn = max(prev_old + tab[qc * sigma + c], dn);
      }
      D[j] = dn;
      H[j] = hn;
      prev_old = h_old;
      carry = max(carry, hn + j * ext);
    }
    // exclusive prefix max of the lane carries
    int incl = carry;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl = max(incl, v);
    }
    int run = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) run = kNeg;
    // pass B: insertions, and the chunk's first max
    bv = INT_MIN;
    bj = INT_MAX;
    for (int j = lo; j < hi; ++j) {
      const int hn = H[j];
      const int h = max(hn, run - j * ext - (open - ext));
      H[j] = h;
      run = max(run, hn + j * ext);
      if (h > bv) {
        bv = h;
        bj = j;
      }
    }
    warp_argmax(bv, bj);
    if (bv > best) {
      best = bv;
      best_t = t + 1;
      best_j = bj;
    }
    __syncwarp();                          // pass B done before next reads
  }
  if (lane == 0) {
    if (a.with_ends) {
      a.out[pair * 3 + 0] = best;
      a.out[pair * 3 + 1] = best_t;
      a.out[pair * 3 + 2] = best_j;
    } else {
      a.out[pair] = best;
    }
  }
}

}  // namespace

// Ints of scratch the long route must be passed for these shapes (0: the
// columns fit in shared memory and the scratch pointer is not read).
extern "C" long long mg_align_dp_scratch_ints(long long R, int LQ) {
  if (kWarps * warp_bytes(LQ) <= kSmemLimit) return 0;
  return R * 2LL * (LQ + 1);
}

// q (R, LQ), r (R, LR), qlen/rlen (R,) and table (sigma, sigma), all
// int32; out (R,) or, with with_ends, (R, 3) int32. wave != 0 takes the
// wave route (LQ + 1 <= 32 * kWaveRows = WAVE_MAX_ROWS in
// align/pallas_dp.py), else the long route.
// Returns cudaGetLastError() after the launch.
extern "C" int mg_align_dp(const void* q, const void* r, const void* qlen,
                           const void* rlen, long long R, int LQ, int LR,
                           const void* table, int sigma, int open_p,
                           int ext_p, int with_ends, int wave, void* out,
                           void* scratch, void* stream) {
  if (R < 0 || LQ < 0 || LR < 0 || sigma < 1 || sigma > kMaxSigma ||
      (wave && LQ + 1 > 32 * kWaveRows)) {
    return (int)cudaErrorInvalidValue;
  }
  if (R == 0) return (int)cudaSuccess;
  Args a{(const int*)q, (const int*)r, (const int*)qlen, (const int*)rlen,
         (const int*)table, sigma, R, LQ, LR, open_p, ext_p, with_ends,
         (int*)out, (int*)scratch};
  cudaStream_t s = (cudaStream_t)stream;
  const long long blocks = (R + kWarps - 1) / kWarps;
  const long long smem = kWarps * warp_bytes(LQ);
  if (wave) {
    wave_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(a);
  } else if (smem <= kSmemLimit) {
    long_kernel<true><<<(unsigned)blocks, kThreads, (size_t)smem, s>>>(a);
  } else {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    long_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}
