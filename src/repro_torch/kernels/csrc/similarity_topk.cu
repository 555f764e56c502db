// K3: batched cosine-similarity top-k for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/similarity_topk/kernel.py
// (similarity_topk_kernel, line 69): queries q [Q,D] against a corpus
// c [N,D], both unit-normalized fp32 rows (the wrapper normalizes), giving
// the k best corpus rows per query as vals [Q,k] fp32, descending, and
// idx [Q,k] int32.  Ties go to the lower corpus index, as in the plain
// version's stable sort; with k > N the tail is (-inf, -1).
//
// Ordering.  Each score becomes one 64-bit key: the order-preserving
// uint32 image of the fp32 score in the high word, 0xFFFFFFFF - index in
// the low word.  Keys are unique, and the larger key is the higher score
// or, on equal scores, the lower index, which is exactly the reference's
// order.  Key 0 is below every real key: it marks an empty slot and
// decodes to (-inf, -1).  -0.0 is keyed as +0.0 (the two compare equal).
//
// Scores.  A block stages a [BQ, 32] query tile and a [128, 32] corpus
// tile in shared memory and forms the [BQ, 128] scores with fp32 FMAs, no
// TF32: each score is one accumulator walked over d = 0..D-1 in order, so
// two identical corpus rows always get bitwise-identical scores, wherever
// they fall.  Warp w owns queries w*TQ .. w*TQ+TQ-1 of the tile, lane l
// owns corpus rows l, l+32, l+64, l+96.
//
// Selection, k <= 128 (the fused path, two launches).  Blocks run over
// (query tile, corpus split).  Each warp keeps, in registers, the running
// best-k keys of each of its queries as a descending list spread over the
// lanes (element e at lane e%32, register e/32).  A tile's key enters
// only if it beats the list's k-th key: the lanes ballot, and each
// passing key is inserted by a warp-wide rank (popcount of ballots) and a
// one-step shift (shuffles).  After the first tiles few keys pass, so the
// selection costs little beside the FMAs.  A second launch merges the
// splits' lists per query, in split order.  No atomics: the same inputs
// give the same bits.
//
// Selection, k > 128 (the large path, two launches).  The first launch
// writes every key to a [Q, N] scratch; the second runs one block per
// query: an 8-pass radix select (8 bits a pass, most significant first)
// finds the min(k, N)-th largest key, the keys at or above it are gathered
// (exactly min(k, N) of them, keys being unique) and sorted by a bitonic
// sort in a [Q, P2] scratch.  Gather positions come from a shared-memory
// counter, but the sort makes the result independent of them.
//
// Bound on the H100: 2*Q*N*D fp32 FMA operations against reading q and c
// once.  At D = 64 (join blocking) the FMAs bound it; at D = 1024 and
// Q = 16 (ORDER BY ... LIMIT over a wide embedder) the corpus bytes do.
// This first version reaches neither: each FMA needs about half a shared
// load, so shared-memory bandwidth caps it near half the FMA peak.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BN = 128;         // corpus rows per tile
constexpr int DK = 32;          // depth of a staged chunk
constexpr int LD = DK + 1;      // padded row: column reads hit 32 banks
constexpr int KCAP = 128;       // largest k of the fused path
constexpr int SELECT_THREADS = 1024;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ uint64_t make_key(float s, int idx) {
  uint32_t b = __float_as_uint(s);
  if (b == 0x80000000u) b = 0u;
  const uint32_t o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<uint64_t>(o) << 32) |
         static_cast<uint64_t>(0xFFFFFFFFu - static_cast<uint32_t>(idx));
}

__device__ __forceinline__ void write_key(uint64_t key, float* v, int* i) {
  if (key == 0) {
    *v = -INFINITY;
    *i = -1;
    return;
  }
  const uint32_t o = static_cast<uint32_t>(key >> 32);
  const uint32_t b = (o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o;
  *v = __uint_as_float(b);
  *i = static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(key));
}

// Scores of queries q0 + warp*TQ + i against corpus rows n0 + lane + 32*j.
// Rows past Q or N read as zeros.  Every thread of the block calls it.
template <int BQ>
__device__ __forceinline__ void score_tile(
    const float* __restrict__ q, const float* __restrict__ c, int Q, int N,
    int D, int q0, int n0, float* qs, float* cs,
    float (&acc)[BQ / WARPS][4]) {
  constexpr int TQ = BQ / WARPS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int d0 = 0; d0 < D; d0 += DK) {
    // a warp reads 32 consecutive floats of one row: coalesced
    for (int e = tid; e < BQ * DK; e += THREADS) {
      const int r = e / DK, col = e % DK, qi = q0 + r, d = d0 + col;
      qs[r * LD + col] =
          (qi < Q && d < D) ? q[static_cast<size_t>(qi) * D + d] : 0.f;
    }
    for (int e = tid; e < BN * DK; e += THREADS) {
      const int r = e / DK, col = e % DK, ni = n0 + r, d = d0 + col;
      cs[r * LD + col] =
          (ni < N && d < D) ? c[static_cast<size_t>(ni) * D + d] : 0.f;
    }
    __syncthreads();
    // zero padding past D adds +0 to each sum: the value is unchanged
#pragma unroll
    for (int dd = 0; dd < DK; ++dd) {
      float a[TQ], b[4];
#pragma unroll
      for (int i = 0; i < TQ; ++i) a[i] = qs[(warp * TQ + i) * LD + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = cs[(lane + 32 * j) * LD + dd];
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// The k-th key of a warp's descending list (element e at lane e % 32,
// register e / 32).
template <int J>
__device__ __forceinline__ uint64_t kth_key(const uint64_t (&r)[J], int k) {
  const int tj = (k - 1) >> 5;
  uint64_t x = 0;
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (j == tj) x = r[j];
  return __shfl_sync(FULL, x, (k - 1) & 31);
}

// Insert ``key`` (warp-uniform, above the k-th key ``t``) into the list;
// the k-th key drops out.  All 32 lanes call it.
template <int J>
__device__ __forceinline__ void insert_key(uint64_t (&r)[J], uint64_t& t,
                                           uint64_t key, int k, int lane) {
  int p = 0;  // rank: the number of listed keys above ``key``
#pragma unroll
  for (int j = 0; j < J; ++j)
    p += __popc(__ballot_sync(FULL, lane + 32 * j < k && r[j] > key));
  uint64_t prev[J];  // element e - 1, for every e this lane holds
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const uint64_t up = __shfl_up_sync(FULL, r[j], 1);
    const uint64_t wrap = __shfl_sync(FULL, j > 0 ? r[j > 0 ? j - 1 : 0]
                                                  : 0ull, 31);
    prev[j] = lane > 0 ? up : wrap;
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int e = lane + 32 * j;
    if (e == p)
      r[j] = key;
    else if (e > p)
      r[j] = prev[j];
  }
  t = kth_key(r, k);
}

// Offer each lane's ``key`` to the list: keys that beat the k-th key go
// in, lowest lane first.  Warp-uniform control flow throughout.
template <int J>
__device__ __forceinline__ void offer(uint64_t (&r)[J], uint64_t& t,
                                      uint64_t key, int k, int lane) {
  unsigned pass = __ballot_sync(FULL, key > t);
  while (pass) {
    const int src = __ffs(pass) - 1;
    pass &= pass - 1;
    const uint64_t kk = __shfl_sync(FULL, key, src);
    if (kk > t) insert_key(r, t, kk, k, lane);
  }
}

// Fused path, launch 1: grid (query tiles, corpus splits).  Writes each
// query's best k keys of its split to part[q][split][0..k), descending.
template <int BQ, int J>
__global__ void __launch_bounds__(THREADS)
    topk_split_kernel(const float* __restrict__ q,
                      const float* __restrict__ c, int Q, int N, int D,
                      int k, int tiles_per_split,
                      uint64_t* __restrict__ part) {
  constexpr int TQ = BQ / WARPS;
  __shared__ float qs[BQ * LD];
  __shared__ float cs[BN * LD];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * BQ, split = blockIdx.y, S = gridDim.y;
  const long long span = static_cast<long long>(tiles_per_split) * BN;
  const long long begin = split * span, end = begin + span;
  const int n_begin = static_cast<int>(begin < N ? begin : N);
  const int n_end = static_cast<int>(end < N ? end : N);
  uint64_t r[TQ][J], t[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    t[i] = 0;
#pragma unroll
    for (int j = 0; j < J; ++j) r[i][j] = 0;
  }
  for (int n0 = n_begin; n0 < n_end; n0 += BN) {
    float acc[TQ][4];
    score_tile<BQ>(q, c, Q, N, D, q0, n0, qs, cs, acc);
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      if (q0 + warp * TQ + i >= Q) continue;  // warp-uniform
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + lane + 32 * j;
        offer(r[i], t[i], n < n_end ? make_key(acc[i][j], n) : 0ull, k,
              lane);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int qi = q0 + warp * TQ + i;
    if (qi >= Q) continue;
    uint64_t* out = part + (static_cast<size_t>(qi) * S + split) * k;
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (lane + 32 * j < k) out[lane + 32 * j] = r[i][j];
  }
}

// Fused path, launch 2: one warp per query merges its S split lists, in
// split order, and writes the answer.
template <int J>
__global__ void __launch_bounds__(THREADS)
    topk_merge_kernel(const uint64_t* __restrict__ part, int Q, int S, int k,
                      float* __restrict__ vals, int* __restrict__ idx) {
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (qi >= Q) return;  // whole warps leave
  uint64_t r[J], t = 0;
#pragma unroll
  for (int j = 0; j < J; ++j) r[j] = 0;
  const uint64_t* p = part + static_cast<size_t>(qi) * S * k;
  for (int s = 0; s < S; ++s) {
    for (int c0 = 0; c0 < k; c0 += 32) {
      const uint64_t key = c0 + lane < k ? p[s * k + c0 + lane] : 0ull;
      if (!__any_sync(FULL, key > t)) break;  // the list is descending
      offer(r, t, key, k, lane);
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int e = lane + 32 * j;
    if (e < k)
      write_key(r[j], vals + static_cast<size_t>(qi) * k + e,
                idx + static_cast<size_t>(qi) * k + e);
  }
}

// Large path, launch 1: every key to keys[q][n].
template <int BQ>
__global__ void __launch_bounds__(THREADS)
    keys_kernel(const float* __restrict__ q, const float* __restrict__ c,
                int Q, int N, int D, uint64_t* __restrict__ keys) {
  constexpr int TQ = BQ / WARPS;
  __shared__ float qs[BQ * LD];
  __shared__ float cs[BN * LD];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * BQ;
  for (long long n0 = static_cast<long long>(blockIdx.y) * BN; n0 < N;
       n0 += static_cast<long long>(gridDim.y) * BN) {
    float acc[TQ][4];
    score_tile<BQ>(q, c, Q, N, D, q0, static_cast<int>(n0), qs, cs, acc);
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int qi = q0 + warp * TQ + i;
      if (qi >= Q) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = static_cast<int>(n0) + lane + 32 * j;
        if (n < N)
          keys[static_cast<size_t>(qi) * N + n] = make_key(acc[i][j], n);
      }
    }
  }
}

// Large path, launch 2: one block per query selects, gathers and sorts
// its best min(k, N) keys (buf holds P2 >= min(k, N) slots per query).
__global__ void __launch_bounds__(SELECT_THREADS)
    select_sort_kernel(const uint64_t* __restrict__ keys, int N, int k,
                       int P2, uint64_t* __restrict__ buf,
                       float* __restrict__ vals, int* __restrict__ idx) {
  __shared__ unsigned hist[256];
  __shared__ uint64_t s_prefix;
  __shared__ unsigned s_rem, s_count;
  const int tid = threadIdx.x, qi = blockIdx.x;
  const uint64_t* row = keys + static_cast<size_t>(qi) * N;
  uint64_t* b = buf + static_cast<size_t>(qi) * P2;
  const int kk = k < N ? k : N;
  uint64_t prefix = 0, mask = 0;
  unsigned rem = kk;
  if (kk > 0) {
    for (int shift = 56; shift >= 0; shift -= 8) {
      for (int e = tid; e < 256; e += blockDim.x) hist[e] = 0;
      __syncthreads();
      for (int e = tid; e < N; e += blockDim.x) {
        const uint64_t key = row[e];
        if ((key & mask) == prefix)
          atomicAdd(&hist[(key >> shift) & 255], 1u);
      }
      __syncthreads();
      if (tid == 0) {
        unsigned above = 0;
        int d = 255;
        for (; d > 0; --d) {
          if (above + hist[d] >= rem) break;
          above += hist[d];
        }
        s_prefix = prefix | (static_cast<uint64_t>(d) << shift);
        s_rem = rem - above;
      }
      __syncthreads();
      prefix = s_prefix;
      rem = s_rem;
      mask |= static_cast<uint64_t>(255) << shift;
      __syncthreads();
    }
  }
  // ``prefix`` is now the kk-th largest key: gather the kk keys at or
  // above it, and pad the rest with empty slots
  if (tid == 0) s_count = 0;
  for (int e = kk + tid; e < P2; e += blockDim.x) b[e] = 0;
  __syncthreads();
  if (kk > 0)
    for (int e = tid; e < N; e += blockDim.x) {
      const uint64_t key = row[e];
      if (key >= prefix) b[atomicAdd(&s_count, 1u)] = key;
    }
  __syncthreads();
  // bitonic sort, descending; __syncthreads orders the block's global
  // reads and writes between stages
  for (int size = 2; size <= P2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < P2; i += blockDim.x) {
        const int j = i ^ stride;
        if (j > i) {
          const uint64_t x = b[i], y = b[j];
          const bool desc = (i & size) == 0;
          if (desc ? x < y : x > y) {
            b[i] = y;
            b[j] = x;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int e = tid; e < k; e += blockDim.x)
    write_key(e < kk ? b[e] : 0ull, vals + static_cast<size_t>(qi) * k + e,
              idx + static_cast<size_t>(qi) * k + e);
}

template <int BQ, int J>
cudaError_t launch_fused(const float* q, const float* c, int Q, int N,
                         int D, int k, int tiles_per_split, int splits,
                         uint64_t* part, float* vals, int* idx,
                         cudaStream_t stream) {
  const dim3 grid((Q + BQ - 1) / BQ, splits);
  topk_split_kernel<BQ, J><<<grid, THREADS, 0, stream>>>(
      q, c, Q, N, D, k, tiles_per_split, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  topk_merge_kernel<J><<<(Q + WARPS - 1) / WARPS, THREADS, 0, stream>>>(
      part, Q, splits, k, vals, idx);
  return cudaGetLastError();
}

template <int BQ>
cudaError_t launch_large(const float* q, const float* c, int Q, int N,
                         int D, int k, uint64_t* keys, uint64_t* buf, int P2,
                         float* vals, int* idx, cudaStream_t stream) {
  const int n_tiles = (N + BN - 1) / BN;
  if (n_tiles > 0) {
    const dim3 grid((Q + BQ - 1) / BQ, min(n_tiles, 65535));
    keys_kernel<BQ><<<grid, THREADS, 0, stream>>>(q, c, Q, N, D, keys);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  select_sort_kernel<<<Q, SELECT_THREADS, 0, stream>>>(keys, N, k, P2, buf,
                                                       vals, idx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Fused path (1 <= k <= 128).  q [Q,D], c [N,D]: contiguous unit fp32.
// part: int64 scratch [Q, splits, k]; the corpus is cut into ``splits``
// runs of ``tiles_per_split`` 128-row tiles.  block_q: 16 or 32.
int repro_similarity_topk(const float* q, const float* c, int Q, int N,
                          int D, int k, int block_q, int tiles_per_split,
                          int splits, void* part, float* vals, int* idx,
                          void* stream) {
  if (Q < 1 || N < 0 || D < 1 || k < 1 || k > KCAP || splits < 1 ||
      tiles_per_split < 1)
    return cudaErrorInvalidValue;
  auto* p = static_cast<uint64_t*>(part);
  auto s = static_cast<cudaStream_t>(stream);
  if (block_q == 16)
    return k <= 32 ? launch_fused<16, 1>(q, c, Q, N, D, k, tiles_per_split,
                                         splits, p, vals, idx, s)
                   : launch_fused<16, 4>(q, c, Q, N, D, k, tiles_per_split,
                                         splits, p, vals, idx, s);
  if (block_q == 32)
    return k <= 32 ? launch_fused<32, 1>(q, c, Q, N, D, k, tiles_per_split,
                                         splits, p, vals, idx, s)
                   : launch_fused<32, 4>(q, c, Q, N, D, k, tiles_per_split,
                                         splits, p, vals, idx, s);
  return cudaErrorInvalidValue;
}

// Large path (any k >= 1).  keys: int64 scratch [Q, N]; buf: int64
// scratch [Q, P2] with P2 a power of two >= min(k, N).
int repro_similarity_topk_large(const float* q, const float* c, int Q,
                                int N, int D, int k, int block_q, void* keys,
                                void* buf, int P2, float* vals, int* idx,
                                void* stream) {
  if (Q < 1 || N < 0 || D < 1 || k < 1 || P2 < 1 || P2 < (k < N ? k : N))
    return cudaErrorInvalidValue;
  auto* kp = static_cast<uint64_t*>(keys);
  auto* bp = static_cast<uint64_t*>(buf);
  auto s = static_cast<cudaStream_t>(stream);
  if (block_q == 16)
    return launch_large<16>(q, c, Q, N, D, k, kp, bp, P2, vals, idx, s);
  if (block_q == 32)
    return launch_large<32>(q, c, Q, N, D, k, kp, bp, P2, vals, idx, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
