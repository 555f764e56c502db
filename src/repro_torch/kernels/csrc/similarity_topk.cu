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
// What bounds it on the H100.  Q*N*D multiply-adds against reading q and
// c once.  At D = 1024 and Q = 16 (ORDER BY ... LIMIT over a wide
// embedder) the 4.3 GB corpus stream bounds it; at D = 64 and Q = 1024
// (join blocking) the products do: 2*Q*N*D operations, which at the fp32
// FMA rate (67 TFLOP/s) take 2.05 ms over a 1M-row corpus.
//
// Scores: 3xTF32 on the tensor cores.  Each fp32 operand x splits into a
// TF32 high part hi = rna(x) (the rounding of cvt.rna.tf32.f32, done with
// two integer operations) and the remainder lo = x - hi, which the tensor
// core reads as TF32; a score is lo(q)*hi(c) + hi(q)*lo(c) + hi(q)*hi(c),
// three TF32 products for every 8-deep step, d = 0..D-1 in order.  The
// dropped lo*lo term is 2^-22 of a product.  (One TF32 product alone is
// off by ~1e-4 and reorders near-ties, so it is not used.)  Each output
// of a tensor-core product comes from the same datapath fed its own row
// and column, so a score depends only on its two rows: identical corpus
// rows keep bit-identical scores wherever they fall, and ties go to the
// lower index.  The tensor cores' own fp32 accumulation truncates: over D
// = 1024 (384 accumulations) that moved scores near 1 by 1.06e-5, past
// the 1e-5 gate (the duplicate-row case of tests/test_torch_cuda.py on an
// NVIDIA H100 80GB HBM3 at 700 W).  So at most 64 columns of depth are
// summed on the tensor cores before the sums go to fp32 adds that round
// to nearest.  The three products at 495 TFLOP/s take 0.83 ms at the
// join-blocking shape, under the fp32 FMA bound.
//
// Depth order.  Within each 16-column run of depth, an 8-deep step
// takes the columns {s, s + 4, s + 8, s + 12} and {s + 1, s + 5, s + 9,
// s + 13} (s = 0, 2 for the run's two steps), in that slot order, on both
// paths below and for both operands: the order in which a lane of
// mma.sync reads its fragments with one 16-byte shared load.  The two
// paths thus feed the tensor cores the same products in the same slots
// and steps, so a score's bits depend only on its two rows, never on the
// batch it came in or on where the corpus sits in memory
// (tests/test_torch_cuda.py holds the two paths to equal bits).
//
// Two product paths:
//   16 queries a block (small searches, k > 32, D > 64, unaligned rows):
//     mma.sync m16n8k8 from a ring of STAGES shared-memory stages filled
//     by 16-byte cp.async copies (4-byte copies when D is not a multiple
//     of 4), so the next STAGES - 1 chunks (tile, 32 columns) are in
//     flight while one is scored: with two blocks on an SM, 96 KB of loads
//     per SM, above the ~26 KB that 3.35 TB/s times ~1 us of latency asks
//     for.  Rows past N and columns past D are zero-filled and add exactly
//     +0.  A stage holds its rows as two 16-column planes, so lane t's
//     fragment operands of a run are one float4 (columns 4t .. 4t + 3).
//     The fp32 sums of a tile live in shared memory.
//   128 queries a block (join blocking: k <= 32, D <= 64, enough queries
//     to fill the card): wgmma m64n128k8 from shared memory, the queries
//     split once, the corpus through a TMA ring (topk_wide_kernel); the
//     split writes each 16-column run in the depth order above, and the
//     selection runs on warps of its own.
//
// Selection, k <= 128 (the fused path, two launches).  After a tile's
// last chunk the [BQ, 128] scores sit in shared memory, and the warp that
// owns a query reads its 128 scores, four a lane.  Each query has a
// running best-k list, descending, spread over the warp's lanes (element
// e at lane e%32, register e/32 while in use).  A tile's scores are first
// held to the list's k-th score as floats; only a query with a score at
// or above it makes keys and offers them: the lanes ballot, and each
// passing key is inserted by a warp-wide rank (popcount of ballots) and a
// one-step shift (shuffles).  A second launch merges the splits' lists,
// one block per query, each warp a stride of splits and then warp 0 the
// warps' lists.  No atomics: the same inputs give the same bits.
//
// Selection, k > 128 (the large path, two launches).  The first launch
// scores through the same tile and ring and writes every key to a [Q, N]
// scratch; the second runs one block per query: an 8-pass radix select
// (8 bits a pass, most significant first) finds the min(k, N)-th largest
// key, the keys at or above it are gathered (exactly min(k, N) of them,
// keys being unique) and sorted by a bitonic sort in a [Q, P2] scratch.
// Gather positions come from a shared-memory counter, but the sort makes
// the result independent of them.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace repro;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BN = 128;         // corpus rows per tile
constexpr int DK = 32;          // depth of a ring stage (two 16-col planes)
constexpr int SLD = BN + 8;     // score row stride: conflict-free float2s
constexpr int FOLD = 2;         // chunks summed on the tensor cores (64 deep)
constexpr int KCAP = 128;       // largest k of the fused path
constexpr int SELECT_THREADS = 1024;
constexpr unsigned FULL = 0xFFFFFFFFu;

// The mma.sync block: BQ queries, each warp scoring a [BQ, WN] piece of
// the [BQ, BN] tile as NT mma tiles of 16 x 8.
constexpr int BQ = 16;
constexpr int WN = BN / WARPS, NT = WN / 8;
constexpr int ROWS = BQ + BN;            // rows of a stage
constexpr int STAGES = 4;
constexpr int STAGE_FLOATS = ROWS * DK;
constexpr int MIN_BLOCKS = 2;            // per SM
constexpr int SMEM_BYTES =
    (STAGES * STAGE_FLOATS + BQ * SLD) * static_cast<int>(sizeof(float));

__device__ __forceinline__ uint64_t make_key(float s, int idx) {
  uint32_t b = __float_as_uint(s);
  if (b == 0x80000000u) b = 0u;
  const uint32_t o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<uint64_t>(o) << 32) |
         static_cast<uint64_t>(0xFFFFFFFFu - static_cast<uint32_t>(idx));
}

// The score of a key; -inf for the empty key 0.
__device__ __forceinline__ float key_score(uint64_t key) {
  if (key == 0) return -INFINITY;
  const uint32_t o = static_cast<uint32_t>(key >> 32);
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

__device__ __forceinline__ void write_key(uint64_t key, float* v, int* i) {
  if (key == 0) {
    *v = -INFINITY;
    *i = -1;
    return;
  }
  *v = key_score(key);
  *i = static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(key));
}

// ---------------------------------------------------------------------------
// the ring: cp.async copies, zero-filled past N and D
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage layout: plane p (columns 16p .. 16p+15 of the chunk) holds ROWS
// rows of 16 floats; rows 0..BQ-1 are the queries, BQ.. the corpus tile.
// VEC: 16-byte copies (D % 4 == 0, rows 16-byte aligned), else 4-byte.
template <bool VEC>
__device__ __forceinline__ void fill_stage(float* st, const float* q,
                                           const float* c, int Q, int N,
                                           int D, int q0, int n0, int d0) {
  const int tid = threadIdx.x;
  if constexpr (VEC) {
    for (int e = tid; e < ROWS * (DK / 4); e += THREADS) {
      const int r = e >> 3, ch = e & 7, d = d0 + 4 * ch;
      const float* src;
      bool ok;
      if (r < BQ) {
        ok = q0 + r < Q && d < D;
        src = q + static_cast<size_t>(q0 + r) * D + d;
      } else {
        ok = n0 + r - BQ < N && d < D;
        src = c + static_cast<size_t>(n0 + r - BQ) * D + d;
      }
      cp_async16(st + (ch >> 2) * ROWS * 16 + r * 16 + (ch & 3) * 4,
                 ok ? src : q, ok);
    }
  } else {
    for (int e = tid; e < ROWS * DK; e += THREADS) {
      const int r = e >> 5, col = e & 31, d = d0 + col;
      const float* src;
      bool ok;
      if (r < BQ) {
        ok = q0 + r < Q && d < D;
        src = q + static_cast<size_t>(q0 + r) * D + d;
      } else {
        ok = n0 + r - BQ < N && d < D;
        src = c + static_cast<size_t>(n0 + r - BQ) * D + d;
      }
      cp_async4(st + (col >> 4) * ROWS * 16 + r * 16 + (col & 15),
                ok ? src : q, ok);
    }
  }
}

// ---------------------------------------------------------------------------
// 3xTF32 products
// ---------------------------------------------------------------------------

// x = hi + lo.  hi: x rounded to TF32 as cvt.rna.tf32.f32 rounds (to
// nearest, ties away from zero): half a TF32 unit added to the magnitude
// bits, the 13 low bits cleared.  lo = x - hi is exact in fp32; the tensor
// core reads its top 19 bits (TF32 by truncation, within 2^-21 |x|).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Add one 32-deep stage to the warp's [BQ, WN] accumulators.  Lane
// (g = lane / 4, t = lane % 4) reads query rows g, g + 8 and corpus row g
// of each n tile, depths 4t .. 4t+3 of a plane, as float4s.
__device__ __forceinline__ void score_stage(const float* st, int wn, int g,
                                            int t, float (&acc)[NT][4]) {
#pragma unroll
  for (int p = 0; p < DK / 16; ++p) {
    const float* plane = st + p * ROWS * 16;
    const float4 a0 =
        *reinterpret_cast<const float4*>(plane + g * 16 + 4 * t);
    const float4 a1 =
        *reinterpret_cast<const float4*>(plane + (g + 8) * 16 + 4 * t);
    float4 b[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = BQ + wn * WN + nt * 8 + g;
      b[nt] = *reinterpret_cast<const float4*>(plane + r * 16 + 4 * t);
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
      // a0 (row g, slot t), a1 (row g+8, slot t), a2 (row g, slot t+4),
      // a3 (row g+8, slot t+4); slot t = depth 4t+2s, t+4 = 4t+2s+1
      split_tf32(s ? a0.z : a0.x, ah[0], al[0]);
      split_tf32(s ? a1.z : a1.x, ah[1], al[1]);
      split_tf32(s ? a0.w : a0.y, ah[2], al[2]);
      split_tf32(s ? a1.w : a1.y, ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        // b0 (slot t, column g), b1 (slot t+4, column g)
        split_tf32(s ? b[nt].z : b[nt].x, bh[nt][0], bl[nt][0]);
        split_tf32(s ? b[nt].w : b[nt].y, bh[nt][1], bl[nt][1]);
      }
      // the same order for every score: lo*hi, hi*lo, then hi*hi
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_tf32(acc[nt], al, bh[nt][0], bh[nt][1]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_tf32(acc[nt], ah, bl[nt][0], bl[nt][1]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_tf32(acc[nt], ah, bh[nt][0], bh[nt][1]);
    }
  }
}

// ---------------------------------------------------------------------------
// warp-resident best-k lists
// ---------------------------------------------------------------------------

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

// Offer a tile's scores to the warp's lists.  sc holds [query][SLD]
// scores of corpus rows n0 .. n0 + 127; the warp owns queries warp * TQ
// .. + TQ - 1 of the block, whose lists' bars (k-th scores) are ``bars``.
// Lane l takes corpus rows n0 + 4l .. n0 + 4l + 3.  Rows past n_end (the
// split's end) and queries past Q take no part.
template <int TQ, int J>
__device__ __forceinline__ void select_tile(const float* sc, int warp,
                                            int lane, int q0, int Q, int n0,
                                            int n_end, int k,
                                            float (&bars)[TQ],
                                            uint64_t (&lists)[TQ][J]) {
  const int nl = n0 + 4 * lane;
  // which of the warp's queries have a score at or above their bar
  unsigned need = 0;
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int row = warp * TQ + i;
    const float4 v =
        *reinterpret_cast<const float4*>(sc + row * SLD + 4 * lane);
    const bool may = !(v.x < bars[i]) || !(v.y < bars[i]) ||
                     !(v.z < bars[i]) || !(v.w < bars[i]);
    if (__any_sync(FULL, may) && q0 + row < Q) need |= 1u << i;
  }
  while (need) {    // rare after the first tiles of a split
    const int i = __ffs(need) - 1;
    need &= need - 1;
    const float4 v = *reinterpret_cast<const float4*>(
        sc + (warp * TQ + i) * SLD + 4 * lane);
    const float sv[4] = {v.x, v.y, v.z, v.w};
    uint64_t r[J];
#pragma unroll
    for (int j = 0; j < J; ++j) r[j] = lists[i][j];
    uint64_t t = kth_key(r, k);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      offer(r, t, nl + j < n_end ? make_key(sv[j], nl + j) : 0ull, k, lane);
#pragma unroll
    for (int j = 0; j < J; ++j) lists[i][j] = r[j];
    const float bar = key_score(t);
#pragma unroll
    for (int ii = 0; ii < TQ; ++ii)
      if (ii == i) bars[ii] = bar;
  }
}

// Each of the warp's queries' best k keys of this split, descending, to
// part[q][split][0..k).
template <int TQ, int J>
__device__ __forceinline__ void write_lists(uint64_t* part, int warp,
                                            int lane, int q0, int Q, int k,
                                            int split, int n_splits,
                                            const uint64_t (&lists)[TQ][J]) {
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int qi = q0 + warp * TQ + i;
    if (qi >= Q) continue;
    uint64_t* dst = part + (static_cast<size_t>(qi) * n_splits + split) * k;
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (lane + 32 * j < k) dst[lane + 32 * j] = lists[i][j];
  }
}

// ---------------------------------------------------------------------------
// launch 1 of both paths: the scoring ring over a split of the corpus
// ---------------------------------------------------------------------------

// Grid (query tiles, corpus splits); split s owns tiles
// [s * tiles_per_split, (s + 1) * tiles_per_split).  KEYS: write every key
// to keys[q][n] (J unused).  Otherwise keep each query's best k and write
// them to part[q][split][0..k), descending.
template <int J, bool VEC, bool KEYS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    topk_score_kernel(const float* __restrict__ q,
                      const float* __restrict__ c, int Q, int N, int D,
                      int k, int tiles_per_split,
                      uint64_t* __restrict__ out) {
  constexpr int TQ = BQ / WARPS;           // queries a warp selects for
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* sc = smem + STAGES * STAGE_FLOATS;   // scores [BQ][SLD]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3, wn = warp;
  const int q0 = blockIdx.x * BQ, split = blockIdx.y, n_splits = gridDim.y;
  const long long span = static_cast<long long>(tiles_per_split) * BN;
  const long long begin = split * span, end = begin + span;
  const int n_begin = static_cast<int>(begin < N ? begin : N);
  const int n_end = static_cast<int>(end < N ? end : N);
  const int chunks = (D + DK - 1) / DK;
  const int total = (n_end - n_begin + BN - 1) / BN * chunks;

  // Each query's list and the score of its k-th key (the bar a score
  // must reach to enter).  The bars stay in registers; the lists, indexed
  // by the query that has a score at its bar, live in local memory and
  // are touched only then.
  uint64_t lists[TQ][J];
  float bars[TQ];
  for (int i = 0; i < TQ; ++i) {
    bars[i] = -INFINITY;
    for (int j = 0; j < J; ++j) lists[i][j] = 0;
  }

  // the producer's position runs STAGES - 1 stages ahead of the consumer
  int p_tile = n_begin, p_chunk = 0, p_slot = 0;
  auto issue = [&](int s) {
    if (s < total) {
      fill_stage<VEC>(ring + p_slot * STAGE_FLOATS, q, c, Q, N, D, q0,
                      p_tile, p_chunk * DK);
      if (++p_chunk == chunks) {
        p_chunk = 0;
        p_tile += BN;
      }
      p_slot = p_slot + 1 == STAGES ? 0 : p_slot + 1;
    }
    cp_async_commit();   // an empty group past the end keeps the count
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  // the products of up to FOLD chunks, summed on the tensor cores
  float part[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[nt][e] = 0.f;
  int n0 = n_begin, chunk = 0, slot = 0;
  for (int s = 0; s < total; ++s) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of stage s
    __syncthreads();   // everyone's copies; stage s - 1 fully consumed
    issue(s + STAGES - 1);         // into the slot stage s - 1 held
    score_stage(ring + slot * STAGE_FLOATS, wn, g, t4, part);
    slot = slot + 1 == STAGES ? 0 : slot + 1;
    ++chunk;
    const bool last = chunk == chunks;
    if (!last && chunk % FOLD) continue;

    // fold into the tile's fp32 sums in sc with round-to-nearest adds
    // (each element of sc belongs to one lane: no barrier needed here)
    const bool first = chunk <= FOLD;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {   // query rows g and g + 8
        float2* p = reinterpret_cast<float2*>(
            sc + (g + 8 * h) * SLD + wn * WN + nt * 8 + 2 * t4);
        float2 v = make_float2(part[nt][2 * h], part[nt][2 * h + 1]);
        if (!first) {
          const float2 o = *p;
          v.x = __fadd_rn(o.x, v.x);
          v.y = __fadd_rn(o.y, v.y);
        }
        *p = v;
        part[nt][2 * h] = part[nt][2 * h + 1] = 0.f;
      }
    if (!last) continue;
    chunk = 0;

    // the tile's scores, read by the warp that owns each query: lane l
    // takes corpus rows n0 + 4l .. n0 + 4l + 3
    __syncthreads();
    const int nl = n0 + 4 * lane;
    if constexpr (KEYS) {
#pragma unroll 1
      for (int i = 0; i < TQ; ++i) {
        const int row = warp * TQ + i, qi = q0 + row;
        if (qi >= Q) break;  // warp-uniform; later rows are past Q too
        const float4 v = *reinterpret_cast<const float4*>(sc + row * SLD +
                                                          4 * lane);
        const float sv[4] = {v.x, v.y, v.z, v.w};
        uint64_t* dst = out + static_cast<size_t>(qi) * N;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (nl + j < n_end) dst[nl + j] = make_key(sv[j], nl + j);
      }
    } else {
      select_tile<TQ, J>(sc, warp, lane, q0, Q, n0, n_end, k, bars, lists);
    }
    n0 += BN;
  }
  cp_async_wait<0>();
  if constexpr (!KEYS)
    write_lists<TQ, J>(out, warp, lane, q0, Q, k, split, n_splits, lists);
}

// ---------------------------------------------------------------------------
// The wide path (k <= 32, D <= 64, enough queries to fill the card): 128
// queries a block, products on wgmma.  The queries are split into TF32
// hi / lo parts once, into shared memory.  The producer warp streams
// 128-row x 32-column corpus chunks with TMA (128-byte swizzle, rows and
// columns past N and D zero-filled) into a ring of W_STAGES stages; the
// two consumer warpgroups split each chunk in place (hi) and into a lo
// buffer while the previous chunk's products run, then issue the three
// products of every 8-deep step: wgmma m64n128k8, 64 queries each.  Both
// splits place each 16-column run in the mma.sync path's depth order
// (perm16), and the accumulators start each tile at +0 as the mma.sync
// path's do, so the two paths give a score the same bits.  At D <= 64 a
// score is at most 24 accumulations on the tensor cores.
//
// The tile's scores go to shared memory, where two more warpgroups, the
// selectors (16 queries a warp), run the same selection as above while
// the consumers compute the next tile: a consumer that selected between
// its wgmmas would hold up its warpgroup, and every chunk would wait for
// the slowest of eight warps' inserts.  (One selector warpgroup, 32
// queries a warp, could not keep up.)  Two mbarriers hand the one score
// buffer over: "scores full" (the consumers wrote a tile) and "scores
// empty" (the selectors read it).
// ---------------------------------------------------------------------------

// d[64] (+)= A * B, both TF32 in shared memory (K-major), m64n128k8
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63},"
      " %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

constexpr int WQ = 128;                  // queries of a wide block
constexpr int WD = 64;                   // its largest D: two 32-col chunks
constexpr int W_STAGES = 3;
constexpr int W_CONSUMERS = 256;         // two warpgroups
constexpr int W_SELECTORS = 256;         // two warpgroups
constexpr int W_PRODUCER = W_CONSUMERS + W_SELECTORS;   // its thread
constexpr int W_THREADS = W_PRODUCER + 32;
constexpr int W_CHUNK = BN * 128;        // bytes of a corpus chunk
constexpr int W_QCHUNK = WQ * 128;       // bytes of a query chunk
constexpr int W_SMEM = 1024 + 4 * W_QCHUNK + W_STAGES * W_CHUNK +
                       2 * W_CHUNK + WQ * SLD * 4 + 8 * (2 * W_STAGES + 2);

// Byte offset of (row, col) in a [rows][32] fp32 tile with 128-byte
// swizzle: the 16-byte unit col / 4 of row r sits at unit (col / 4) ^
// (r % 8), as TMA writes it and wgmma reads it.
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + ((((col >> 2) ^ row) & 7) << 4) + (col & 3) * 4;
}

// Where column d of a 16-column run goes so that wgmma's 8-deep steps
// read the mma.sync path's order: 16-byte unit d % 4, element d / 4.
__host__ __device__ constexpr int perm16(int d) {
  return 16 * (d / 16) + 4 * (d % 4) + (d % 16) / 4;
}

// Split row ``row``'s 16-column run ``half`` of a swizzled [rows][32]
// chunk: read its four 16-byte units (columns in order), write their TF32
// high parts back in place and the remainders to ``lo`` (same offsets),
// both transposed into perm16's order.
__device__ __forceinline__ void split_run(unsigned char* hi,
                                          unsigned char* lo, int row,
                                          int half) {
  float x[4][4];   // x[i][j]: column 4i + j of the run
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(x[i]) =
        *reinterpret_cast<const float4*>(hi + swz(row, 16 * half + 4 * i));
#pragma unroll
  for (int j = 0; j < 4; ++j) {   // unit j: columns j, j + 4, j + 8, j + 12
    uint32_t h[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(x[i][j], h[i], l[i]);
    const uint32_t at = swz(row, 16 * half + 4 * j);
    *reinterpret_cast<uint4*>(hi + at) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

__global__ void __launch_bounds__(W_THREADS, 1)
    topk_wide_kernel(const __grid_constant__ CUtensorMap c_map,
                     const float* __restrict__ q, int Q, int N, int D, int k,
                     int tiles_per_split, uint64_t* __restrict__ part) {
  constexpr int TQ = WQ / (W_SELECTORS / 32);   // queries a selector warp
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  unsigned char* qhi = base;                         // 2 query chunks
  unsigned char* qlo = qhi + 2 * W_QCHUNK;
  unsigned char* ring = qlo + 2 * W_QCHUNK;          // W_STAGES chunks
  unsigned char* lo = ring + W_STAGES * W_CHUNK;     // 2 chunks
  float* sc = reinterpret_cast<float*>(lo + 2 * W_CHUNK);   // [WQ][SLD]
  const uint32_t bars = smem_u32(sc + WQ * SLD);
  auto full_bar = [&](int s) { return bars + 8 * s; };
  auto empty_bar = [&](int s) { return bars + 8 * (W_STAGES + s); };
  const uint32_t sc_full = bars + 16 * W_STAGES, sc_empty = sc_full + 8;

  const int q0 = blockIdx.x * WQ, split = blockIdx.y, n_splits = gridDim.y;
  const long long span = static_cast<long long>(tiles_per_split) * BN;
  const long long begin = split * span, end = begin + span;
  const int n_begin = static_cast<int>(begin < N ? begin : N);
  const int n_end = static_cast<int>(end < N ? end : N);
  const int chunks = (D + DK - 1) / DK;              // 1 or 2
  const int total = (n_end - n_begin + BN - 1) / BN * chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), W_CONSUMERS);
    }
    mbar_init(sc_full, W_CONSUMERS);
    mbar_init(sc_empty, W_SELECTORS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= W_PRODUCER) {
    // ---- producer: one thread streams the corpus chunks ----
    if (threadIdx.x != W_PRODUCER) return;
    prefetch_map(&c_map);
    for (int s = 0; s < total; ++s) {
      const int slot = s % W_STAGES, round = s / W_STAGES;
      if (round > 0) mbar_wait(empty_bar(slot), (round - 1) & 1);
      mbar_expect_tx(full_bar(slot), W_CHUNK);
      tma_load_2d(smem_u32(ring + slot * W_CHUNK), &c_map, full_bar(slot),
                  (s % chunks) * DK, n_begin + (s / chunks) * BN);
    }
    return;
  }

  if (threadIdx.x >= W_CONSUMERS) {
    // ---- selectors: tile t's scores while the consumers compute t + 1 ----
    const int warp = (threadIdx.x - W_CONSUMERS) >> 5, lane = threadIdx.x & 31;
    uint64_t lists[TQ][1];
    float bars_q[TQ];
    for (int i = 0; i < TQ; ++i) {
      bars_q[i] = -INFINITY;
      lists[i][0] = 0;
    }
    const int tiles = (n_end - n_begin + BN - 1) / BN;
    for (int t = 0; t < tiles; ++t) {
      mbar_wait(sc_full, t & 1);
      select_tile<TQ, 1>(sc, warp, lane, q0, Q, n_begin + t * BN, n_end, k,
                         bars_q, lists);
      mbar_arrive(sc_empty);
    }
    write_lists<TQ, 1>(part, warp, lane, q0, Q, k, split, n_splits, lists);
    return;
  }

  // ---- consumers ----
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, g = lane >> 2, t4 = lane & 3;
  // the queries, split once: rows past Q and columns past D are zeros
  for (int e = tid; e < WQ * WD; e += W_CONSUMERS) {
    const int row = e / WD, col = e % WD;
    const float x = q0 + row < Q && col < D
                        ? q[static_cast<size_t>(q0 + row) * D + col]
                        : 0.f;
    uint32_t h, l;
    split_tf32(x, h, l);
    const uint32_t at = (col / DK) * W_QCHUNK + swz(row, perm16(col % DK));
    *reinterpret_cast<uint32_t*>(qhi + at) = h;
    *reinterpret_cast<uint32_t*>(qlo + at) = l;
  }
  auto split_stage = [&](int s) {   // chunk s: hi in place, lo beside it
    mbar_wait(full_bar(s % W_STAGES), (s / W_STAGES) & 1);
    static_assert(W_CONSUMERS == 2 * BN, "a thread splits one run");
    split_run(ring + (s % W_STAGES) * W_CHUNK, lo + (s % 2) * W_CHUNK,
              tid >> 1, tid & 1);
    fence_proxy_async();            // visible to the tensor cores
  };
  if (total > 0) split_stage(0);
  fence_proxy_async();
  named_barrier(1, W_CONSUMERS);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // warp w's accumulators hold queries 16w .. 16w + 15
  int tile = 0;
  for (int s = 0; s < total; ++s) {
    const int ch = s % chunks;
    const uint32_t b_hi = smem_u32(ring + (s % W_STAGES) * W_CHUNK);
    const uint32_t b_lo = smem_u32(lo + (s % 2) * W_CHUNK);
    const uint32_t a_hi = smem_u32(qhi + ch * W_QCHUNK) + wg * 64 * 128;
    const uint32_t a_lo = smem_u32(qlo + ch * W_QCHUNK) + wg * 64 * 128;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DK / 8; ++ks) {
      // the same order for every score: lo*hi, hi*lo, then hi*hi
      wgmma_tf32_n128(acc, sw128_desc(a_lo + 32 * ks, 16, 1024),
                      sw128_desc(b_hi + 32 * ks, 16, 1024), 1);
      wgmma_tf32_n128(acc, sw128_desc(a_hi + 32 * ks, 16, 1024),
                      sw128_desc(b_lo + 32 * ks, 16, 1024), 1);
      wgmma_tf32_n128(acc, sw128_desc(a_hi + 32 * ks, 16, 1024),
                      sw128_desc(b_hi + 32 * ks, 16, 1024), 1);
    }
    wgmma_commit();
    if (s + 1 < total) split_stage(s + 1);   // while the products run
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(empty_bar(s % W_STAGES));
    if (ch == chunks - 1) {   // the tile's scores, to this warp's rows
      if (tile > 0) mbar_wait(sc_empty, (tile - 1) & 1);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(sc + (warp * 16 + g + 8 * h) * SLD +
                                     8 * j + 2 * t4) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      mbar_arrive(sc_full);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      ++tile;
    }
    // chunk s + 1 is split, and everyone is done with chunk s's lo
    named_barrier(1, W_CONSUMERS);
  }
}

// Fused path, launch 2: one block per query.  Warp w merges the split
// lists w, w + 8, ... (in that order) into its own list; warp 0 then
// merges the 8 warps' lists, in warp order, and writes the answer.
template <int J>
__global__ void __launch_bounds__(THREADS)
    topk_merge_kernel(const uint64_t* __restrict__ part, int S, int k,
                      float* __restrict__ vals, int* __restrict__ idx) {
  __shared__ uint64_t lists[WARPS][KCAP];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qi = blockIdx.x;
  const uint64_t* p = part + static_cast<size_t>(qi) * S * k;
  uint64_t r[J], t = 0;
#pragma unroll
  for (int j = 0; j < J; ++j) r[j] = 0;
  auto merge = [&](const uint64_t* list) {
    for (int c0 = 0; c0 < k; c0 += 32) {
      const uint64_t key = c0 + lane < k ? list[c0 + lane] : 0ull;
      if (!__any_sync(FULL, key > t)) break;  // the list is descending
      offer(r, t, key, k, lane);
    }
  };
  for (int s = warp; s < S; s += WARPS) merge(p + static_cast<size_t>(s) * k);
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (lane + 32 * j < k) lists[warp][lane + 32 * j] = r[j];
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < WARPS; ++w) merge(lists[w]);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int e = lane + 32 * j;
    if (e < k)
      write_key(r[j], vals + static_cast<size_t>(qi) * k + e,
                idx + static_cast<size_t>(qi) * k + e);
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

template <int J, bool KEYS>
cudaError_t launch_score(const float* q, const float* c, int Q, int N,
                         int D, int k, int tiles_per_split, int splits,
                         uint64_t* out, cudaStream_t stream) {
  constexpr int bytes = SMEM_BYTES;
  const dim3 grid((Q + BQ - 1) / BQ, splits);
  // 16-byte copies need 16-byte aligned rows
  const uintptr_t base = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(c);
  const bool vec = D % 4 == 0 && base % 16 == 0;
  auto kern = vec ? topk_score_kernel<J, true, KEYS>
                  : topk_score_kernel<J, false, KEYS>;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kern), bytes);
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS, bytes, stream>>>(q, c, Q, N, D, k, tiles_per_split,
                                         out);
  return cudaGetLastError();
}

template <int J>
cudaError_t launch_fused(const float* q, const float* c, int Q, int N,
                         int D, int k, int tiles_per_split, int splits,
                         uint64_t* part, float* vals, int* idx,
                         cudaStream_t stream) {
  cudaError_t err = launch_score<J, false>(q, c, Q, N, D, k, tiles_per_split,
                                           splits, part, stream);
  if (err != cudaSuccess) return err;
  topk_merge_kernel<J><<<Q, THREADS, 0, stream>>>(part, splits, k, vals,
                                                   idx);
  return cudaGetLastError();
}

cudaError_t launch_wide(const float* q, const float* c, int Q, int N,
                        int D, int k, int tiles_per_split, int splits,
                        uint64_t* part, float* vals, int* idx,
                        cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (N < 1 || D > WD || D % 4 != 0 || k > 32 ||
      reinterpret_cast<uintptr_t>(c) % 16 != 0 || encode == nullptr)
    return cudaErrorInvalidValue;
  // the corpus as a [N][D] fp32 tensor read in (32 columns, 128 rows)
  // boxes, 128-byte swizzled; past N and D it reads as zeros
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 4};
  const cuuint32_t box[2] = {DK, BN};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(c),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(topk_wide_kernel), W_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + WQ - 1) / WQ, splits);
  topk_wide_kernel<<<grid, W_THREADS, W_SMEM, stream>>>(
      map, q, Q, N, D, k, tiles_per_split, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  topk_merge_kernel<1><<<Q, THREADS, 0, stream>>>(part, splits, k, vals,
                                                   idx);
  return cudaGetLastError();
}

cudaError_t launch_large(const float* q, const float* c, int Q, int N,
                         int D, int k, int tiles_per_split, int splits,
                         uint64_t* keys, uint64_t* buf, int P2, float* vals,
                         int* idx, cudaStream_t stream) {
  if (N > 0) {
    cudaError_t err = launch_score<1, true>(q, c, Q, N, D, k, tiles_per_split,
                                            splits, keys, stream);
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
// runs of ``tiles_per_split`` 128-row tiles.  block_q: 16 (the mma.sync
// path), or 128 (the wgmma path) with k <= 32, D <= 64, D % 4 == 0 and a
// 16-byte aligned corpus.
int repro_similarity_topk(const float* q, const float* c, int Q, int N,
                          int D, int k, int block_q, int tiles_per_split,
                          int splits, void* part, float* vals, int* idx,
                          void* stream) {
  if (Q < 1 || N < 0 || D < 1 || k < 1 || k > KCAP || splits < 1 ||
      tiles_per_split < 1)
    return cudaErrorInvalidValue;
  auto* p = static_cast<uint64_t*>(part);
  auto s = static_cast<cudaStream_t>(stream);
  if (block_q == BQ)
    return k <= 32 ? launch_fused<1>(q, c, Q, N, D, k, tiles_per_split,
                                     splits, p, vals, idx, s)
                   : launch_fused<4>(q, c, Q, N, D, k, tiles_per_split,
                                     splits, p, vals, idx, s);
  if (block_q == WQ)
    return launch_wide(q, c, Q, N, D, k, tiles_per_split, splits, p, vals,
                       idx, s);
  return cudaErrorInvalidValue;
}

// Large path (any k >= 1).  keys: int64 scratch [Q, N]; buf: int64
// scratch [Q, P2] with P2 a power of two >= min(k, N).  block_q: 16; the
// corpus splits as on the fused path.
int repro_similarity_topk_large(const float* q, const float* c, int Q,
                                int N, int D, int k, int block_q,
                                int tiles_per_split, int splits, void* keys,
                                void* buf, int P2, float* vals, int* idx,
                                void* stream) {
  if (Q < 1 || N < 0 || D < 1 || k < 1 || P2 < 1 || P2 < (k < N ? k : N) ||
      splits < 1 || tiles_per_split < 1)
    return cudaErrorInvalidValue;
  auto* kp = static_cast<uint64_t*>(keys);
  auto* bp = static_cast<uint64_t*>(buf);
  auto s = static_cast<cudaStream_t>(stream);
  if (block_q != BQ) return cudaErrorInvalidValue;
  return launch_large(q, c, Q, N, D, k, tiles_per_split, splits, kp, bp, P2,
                      vals, idx, s);
}

}  // extern "C"
