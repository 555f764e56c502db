// RWKV-6 wkv recurrence for Hopper: per (batch row, head) an [hd, hd] fp32
// state S carried over time,
//   o_t = r_t^T (S + (u * k_t) v_t^T),   S <- diag(w_t) S + k_t v_t^T.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/rwkv6_scan/kernel.py::rwkv6_scan_kernel (body
// _rwkv_kernel): same inputs (r, k, v, w [B,S,H,hd], u [H,hd], s0
// [B,H,hd,hd]), same outputs (o [B,S,H,hd] fp32, sT [B,H,hd,hd] fp32).
// Padding is the caller's: a pad step with w = 1 and k = 0 leaves S as it
// was, which is how the model freezes the state at a row's last token.
//
// What bounds it: operations, narrowly.  The recurrence does 5 hd^2 fp32
// flops a step per (row, head) against 5 hd elements read or written: at
// hd = 64 about 23 flops per byte, just above the 20 flop/byte at which
// the card's 67 fp32 TFLOP/s outrun its 3.35 TB/s.  Stepping through time
// leaves that work in chains of dependent operations (the step path
// below ran 12.5x its bound at the full shape); the chunked path turns
// most of it into dense products on the tensor cores.
//
// Two paths, both summing in one fixed order (no atomics: two launches
// give the same bits):
//
// * Chunked (S >= C): one block of 256 threads per (head, row) walks the
//   sequence in chunks of C = 32 steps.  Within a chunk the recurrence is
//   dense work.  With S0 the state at the chunk's start and, for s < t,
//   F(s, t) = prod_{s < tau < t} w_tau (per channel i):
//     o_t = (r_t * P_{t-1})^T S0 + sum_{s<t} A[t][s] v_s + A[t][t] v_t,
//     A[t][s] = sum_i r_t[i] k_s[i] F(s, t)[i],  A[t][t] = sum_i r_t u k_t,
//     S_C = diag(P_C) S0 + sum_s diag(F(s, C)) k_s v_s^T,
//   where P_t is the product of the decays from the chunk's start.  The
//   chunk splits into sub-chunks of CS = 8 steps, and every factor is a
//   product of decays over one range inside one sub-chunk (a prefix from
//   its start, a suffix to its end, a whole sub-chunk, or the span between
//   two steps of one sub-chunk), i.e. the exponential of the sum of log w
//   over that range, formed as a running product of w: each factor is at
//   most 1, none is a quotient of running products, and a decay that
//   underflowed to 0 gives exactly 0 (no log of 0, no inf - inf).  For s
//   in an earlier sub-chunk than t, F(s, t) = suffix_s * (whole sub-chunks
//   between) * prefix_t, so A[t][s] = (r_t * prefix_t) . kz_s with kz_s
//   the key decayed to the start of t's sub-chunk; inside a sub-chunk each
//   of the 28 pairs keeps its own factor.  Phases per chunk: (2) one
//   thread per (sub-chunk, channel) loads its 8 steps and forms the
//   factors and decayed keys; (3) A, in fp32 FMA (2 x 2 tiles across
//   sub-chunks, one entry a thread inside them, all in one round); (4) the
//   outputs rq [C, hd] x S0 [hd, hd] + A [C, C] x V [C, hd] and (5) the
//   state diag(P_C) S0 + kq^T [hd, C] x V [C, hd], in place, both on
//   mma.sync m16n8k8 in 3xTF32 (each fp32 operand split into a TF32 high
//   part and the remainder, lo*hi + hi*lo + hi*hi: K3's split), one 16 x
//   16 strip a warp (faster on the card than fp32 FMA in these two
//   phases, which a first build used).  The next chunk's inputs are
//   loaded into registers while (3)-(5) run; the only sequential
//   dimension left is the chunk boundaries.
// * Step (S < C, the decode steps): one block of hd threads per (head,
//   row); thread j keeps column j of S in registers and steps through
//   time, as the TPU kernel's inner loop does.
//
// Types: r, k, v are bf16 or fp32 (one type); w, u and the state are fp32
// (the wrapper casts w and u if they are not).  Head sizes 64 (the zoo's
// RWKV-6) and 16 (its smoke model).
#include "common.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// step path
// ---------------------------------------------------------------------------

constexpr int TT = 16;   // time steps staged in shared memory per pass

template <typename T, int HD>
__global__ void __launch_bounds__(HD) rwkv6_step_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u,
    const float* __restrict__ s0, float* __restrict__ o,
    float* __restrict__ sT, int S, int H) {
  static_assert(HD % 4 == 0, "the readout reads 4 channels at a time");
  __shared__ __align__(16) float s_r[TT][HD];
  __shared__ __align__(16) float s_k[TT][HD];
  __shared__ __align__(16) float s_w[TT][HD];
  __shared__ __align__(16) float s_u[HD];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int j = threadIdx.x;
  const long long step = (long long)H * HD;          // elements per step
  const long long base = (long long)b * S * step + (long long)h * HD + j;
  const long long sbase = ((long long)b * H + h) * HD * HD + j;

  s_u[j] = u[h * HD + j];
  float st[HD];                       // st[i] = S[i][j]
#pragma unroll
  for (int i = 0; i < HD; ++i) st[i] = s0[sbase + (long long)i * HD];

  for (int t0 = 0; t0 < S; t0 += TT) {
    const int n = min(TT, S - t0);
    float vt[TT];
    __syncthreads();                  // the previous pass is consumed
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      vt[t] = 0.f;
      if (t < n) {
        const long long off = base + (long long)(t0 + t) * step;
        s_r[t][j] = repro::to_f32(r[off]);
        s_k[t][j] = repro::to_f32(k[off]);
        s_w[t][j] = w[off];
        vt[t] = repro::to_f32(v[off]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      if (t >= n) break;
      const float vj = vt[t];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < HD; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&s_r[t][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&s_k[t][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&s_w[t][i]);
        const float4 u4 = *reinterpret_cast<const float4*>(&s_u[i]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
        const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float kv = kk[c] * vj;
          acc[c] = fmaf(rr[c], fmaf(uu[c], kv, st[i + c]), acc[c]);
          st[i + c] = fmaf(ww[c], st[i + c], kv);
        }
      }
      o[base + (long long)(t0 + t) * step] = (acc[0] + acc[1]) +
                                             (acc[2] + acc[3]);
    }
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) sT[sbase + (long long)i * HD] = st[i];
}

// ---------------------------------------------------------------------------
// chunked path
// ---------------------------------------------------------------------------

constexpr int C = 32;                    // steps a chunk
constexpr int CS = 8;                    // steps a sub-chunk
constexpr int NSUB = C / CS;
constexpr int NPAIR = CS * (CS - 1) / 2; // pairs s < t inside a sub-chunk
constexpr int NT = 256;                  // threads a block

// Off-diagonal blocks of A (key sub-chunk before the query's) in 2 x 2
// tiles, and the entries of the diagonal blocks (s <= t in one
// sub-chunk): one work item a thread, all in one round.
constexpr int OFF_TILES = (CS / 2) * (CS / 2) * NSUB * (NSUB - 1) / 2;
constexpr int DIAG = NSUB * CS * (CS + 1) / 2;
static_assert(OFF_TILES + DIAG <= NT, "phase 3 runs in one round");
// rows of kz: the keys of every sub-chunk before sub-chunk a, decayed to
// a's start, for a = 1 .. NSUB - 1
constexpr int KZ_ROWS = CS * NSUB * (NSUB - 1) / 2;

// Shared memory, in floats.  Phases 2-3 (region U): r, k, r*prefix ([C][LD]
// each, LD = hd + 1 so that a column read has no bank conflict), kz
// ([KZ_ROWS][LD]) and the pair factors inside each sub-chunk ([NSUB *
// NPAIR][LD]); phases 4-5 reuse the pair factors' room for rq = r*P
// ([C][hd + 4]) and kq = k*F(., C) ([C][hd + 8]).  Then v, S ([.][hd + 8]),
// A ([C][C + 4], zero above the diagonal), the sub-chunks' decays, the
// chunk's decay and u.  The row pads put the 32 lanes' reads of an
// mma.sync fragment on 32 banks.
template <int HD>
struct ChunkSmem {
  static constexpr int LD = HD + 1;
  static constexpr int RS = HD + 4, KS = HD + 8, VS = HD + 8, SS = HD + 8;
  static constexpr int AS = C + 4;
  static constexpr int KZ = 3 * C * LD;
  static constexpr int D = KZ + KZ_ROWS * LD;
  static constexpr int U = D + NSUB * NPAIR * LD;
  static constexpr int RQ = D;                      // over the pair factors
  static constexpr int KQ = RQ + C * RS;
  static_assert(KQ + C * KS <= U, "rq and kq fit in the pair factors' room");
  static constexpr int V = U;
  static constexpr int ST = V + C * VS;
  static constexpr int A = ST + HD * SS;
  static constexpr int W = A + C * AS;
  static constexpr int QE = W + NSUB * HD;
  static constexpr int UU = QE + HD;
  static constexpr int FLOATS = UU + HD;
  static constexpr int BYTES = FLOATS * 4;
};

// index of the pair (s, t), s < t < CS, inside a sub-chunk
__host__ __device__ constexpr int pair_index(int s, int t) {
  return s * (2 * CS - s - 1) / 2 + (t - s - 1);
}

// x = hi + lo.  hi: x rounded to TF32 as cvt.rna.tf32.f32 rounds; lo =
// x - hi is exact in fp32, and the tensor core reads its top 19 bits
// (the split of K3, csrc/similarity_topk.cu).
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

// acc[n] (16 x 8 tiles n = 0, 1 of one 16-row strip) += A B over depth
// [0, K) in 3xTF32: lo*hi, hi*lo, then hi*hi for each 8-deep step, steps
// in order.  a(r, k) and b(k, n) give the operands' fp32 values; lane
// (g, t) reads rows g, g + 8 of A and column g of each B tile.
template <int K, typename FA, typename FB>
__device__ __forceinline__ void mma3_strip(float (&acc)[2][4], FA a, FB b,
                                           int g, int t) {
#pragma unroll
  for (int kk = 0; kk < K; kk += 8) {
    uint32_t ah[4], al[4];
    split_tf32(a(g, kk + t), ah[0], al[0]);
    split_tf32(a(g + 8, kk + t), ah[1], al[1]);
    split_tf32(a(g, kk + t + 4), ah[2], al[2]);
    split_tf32(a(g + 8, kk + t + 4), ah[3], al[3]);
    uint32_t bh[2][2], bl[2][2];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      split_tf32(b(kk + t, 8 * n + g), bh[n][0], bl[n][0]);
      split_tf32(b(kk + t + 4, 8 * n + g), bh[n][1], bl[n][1]);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) mma_tf32(acc[n], al, bh[n][0], bh[n][1]);
#pragma unroll
    for (int n = 0; n < 2; ++n) mma_tf32(acc[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
    for (int n = 0; n < 2; ++n) mma_tf32(acc[n], ah, bh[n][0], bh[n][1]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) rwkv6_chunk_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u,
    const float* __restrict__ s0, float* __restrict__ o,
    float* __restrict__ sT, int S, int H) {
  using Sm = ChunkSmem<HD>;
  constexpr int LD = Sm::LD, RS = Sm::RS, KS = Sm::KS, VS = Sm::VS;
  constexpr int SS = Sm::SS, AS = Sm::AS;
  constexpr int Q4 = HD / 4;
  static_assert(NSUB * HD <= NT, "one thread per (sub-chunk, channel)");
  static_assert(HD % 16 == 0, "16 x 16 output strips");
  extern __shared__ __align__(16) float sm[];
  float* r_s = sm;
  float* k_s = sm + C * LD;
  float* rp_s = sm + 2 * C * LD;
  float* kz_s = sm + Sm::KZ;
  float* d_s = sm + Sm::D;
  float* rq_s = sm + Sm::RQ;
  float* kq_s = sm + Sm::KQ;
  float* v_s = sm + Sm::V;
  float* S_s = sm + Sm::ST;
  float* A_s = sm + Sm::A;
  float* W_s = sm + Sm::W;
  float* qe_s = sm + Sm::QE;
  float* u_s = sm + Sm::UU;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tg = lane & 3;     // mma.sync fragment lane
  const long long step = (long long)H * HD;
  const long long base = (long long)b * S * step + (long long)h * HD;
  const long long sbase = ((long long)b * H + h) * HD * HD;

  for (int e = tid; e < HD * Q4; e += NT)
    *reinterpret_cast<float4*>(&S_s[(e / Q4) * SS + (e % Q4) * 4]) =
        reinterpret_cast<const float4*>(s0 + sbase)[e];
  for (int e = tid; e < HD; e += NT) u_s[e] = u[h * HD + e];
  for (int e = tid; e < C * AS; e += NT) A_s[e] = 0.f;

  // phase 2's thread: sub-chunk a, channel i
  const bool p2 = tid < NSUB * HD;
  const int a = tid / HD, i = tid % HD;
  float rr[CS], kk[CS], vv[CS], ww[CS];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int q = 0; q < CS; ++q) {
      const int t = t0 + a * CS + q;
      if (p2 && t < S) {
        const long long off = base + (long long)t * step + i;
        rr[q] = repro::to_f32(r[off]);
        kk[q] = repro::to_f32(k[off]);
        vv[q] = repro::to_f32(v[off]);
        ww[q] = w[off];
      } else {                         // past the end: an identity step
        rr[q] = kk[q] = vv[q] = 0.f;
        ww[q] = 1.f;
      }
    }
  };
  fetch(0);

  const int nchunks = (S + C - 1) / C;
  for (int ci = 0; ci < nchunks; ++ci) {
    const int t0 = ci * C;
    // -- phase 2: factors, one thread per (sub-chunk, channel) -----------
    float ks[CS];
    if (p2) {
      float pre = 1.f;                   // prod of w from the sub-chunk's start
#pragma unroll
      for (int q = 0; q < CS; ++q) {
        const int row = a * CS + q;
        r_s[row * LD + i] = rr[q];
        k_s[row * LD + i] = kk[q];
        rp_s[row * LD + i] = rr[q] * pre;
        v_s[row * VS + i] = vv[q];
        pre *= ww[q];
      }
      W_s[a * HD + i] = pre;             // the whole sub-chunk's decay
      float suf = 1.f;                   // prod of w to the sub-chunk's end
#pragma unroll
      for (int q = CS - 1; q >= 0; --q) {
        ks[q] = kk[q] * suf;
        suf *= ww[q];
      }
#pragma unroll
      for (int s = 0; s < CS - 1; ++s) {
        float f = 1.f;
#pragma unroll
        for (int t = s + 1; t < CS; ++t) {
          d_s[(a * NPAIR + pair_index(s, t)) * LD + i] = f;
          f *= ww[t];
        }
      }
      if (ci + 1 < nchunks) fetch(t0 + C);   // in flight during 3-5
    }
    __syncthreads();

    // this sub-chunk's keys decayed to the start of each later one (by the
    // whole sub-chunks between); the decays from the chunk's start to this
    // sub-chunk, from its end to the chunk's end, and over the chunk
    float qa = 1.f, ra = 1.f;
    if (p2) {
      for (int m = 0; m < a; ++m) qa *= W_s[m * HD + i];
      float f = 1.f;
      for (int m = a + 1; m < NSUB; ++m) {
        float* kz = kz_s + (CS * m * (m - 1) / 2 + a * CS) * LD + i;
#pragma unroll
        for (int q = 0; q < CS; ++q) kz[q * LD] = ks[q] * f;
        f *= W_s[m * HD + i];
        ra *= W_s[m * HD + i];
      }
      if (a == 0) qe_s[i] = f * W_s[i];
    }
    __syncthreads();

    // -- phase 3: A[t][s] for s <= t ----------------------------------------
    if (tid < OFF_TILES) {
      // rows tq, tq + 1 of sub-chunk at against keys sq, sq + 1 before it
      int rem = tid, at = 1;
      while (rem >= (CS / 2) * (at * CS / 2)) {
        rem -= (CS / 2) * (at * CS / 2);
        ++at;
      }
      const int tq = at * CS + 2 * (rem / (at * CS / 2));
      const int sq = 2 * (rem % (at * CS / 2));
      const float* L0 = rp_s + tq * LD;
      const float* L1 = L0 + LD;
      const float* R0 = kz_s + (CS * at * (at - 1) / 2 + sq) * LD;
      const float* R1 = R0 + LD;
      float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
#pragma unroll 16
      for (int c = 0; c < HD; ++c) {
        const float l0 = L0[c], l1 = L1[c], r0 = R0[c], r1 = R1[c];
        a00 = fmaf(l0, r0, a00);
        a01 = fmaf(l0, r1, a01);
        a10 = fmaf(l1, r0, a10);
        a11 = fmaf(l1, r1, a11);
      }
      A_s[tq * AS + sq] = a00;
      A_s[tq * AS + sq + 1] = a01;
      A_s[(tq + 1) * AS + sq] = a10;
      A_s[(tq + 1) * AS + sq + 1] = a11;
    } else if (tid < OFF_TILES + DIAG) {
      // s <= t inside sub-chunk sa: sum_i r_t k_s F(s, t) (u where s = t)
      const int e = tid - OFF_TILES;
      const int sa = e / (CS * (CS + 1) / 2);
      const int f = e % (CS * (CS + 1) / 2);
      int tl = 0;
      while ((tl + 1) * (tl + 2) / 2 <= f) ++tl;
      const int sl = f - tl * (tl + 1) / 2;
      const int t = sa * CS + tl, s = sa * CS + sl;
      const float* L = r_s + t * LD;
      const float* R = k_s + s * LD;
      const float* F =
          (s == t) ? u_s : d_s + (sa * NPAIR + pair_index(sl, tl)) * LD;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < HD; c += 4)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          acc[cc] = fmaf(L[c + cc] * R[c + cc], F[c + cc], acc[cc]);
      A_s[t * AS + s] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
    __syncthreads();                     // the pair factors are read no more
    if (p2) {
#pragma unroll
      for (int q = 0; q < CS; ++q) {
        const int row = a * CS + q;
        rq_s[row * RS + i] = rp_s[row * LD + i] * qa;
        kq_s[row * KS + i] = ks[q] * ra;
      }
    }
    __syncthreads();

    // -- phase 4: O = rq S0 + A V, [C, hd] in 16 x 16 strips (3xTF32) --------
    for (int unit = warp; unit < (C / 16) * (HD / 16); unit += NT / 32) {
      const int m0 = (unit / (HD / 16)) * 16, n0 = (unit % (HD / 16)) * 16;
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      mma3_strip<HD>(
          acc, [&](int row, int c) { return rq_s[(m0 + row) * RS + c]; },
          [&](int c, int col) { return S_s[c * SS + n0 + col]; }, g, tg);
      mma3_strip<C>(
          acc, [&](int row, int s) { return A_s[(m0 + row) * AS + s]; },
          [&](int s, int col) { return v_s[s * VS + n0 + col]; }, g, tg);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = n0 + 8 * n + 2 * tg;
        if (t0 + m0 + g < S)
          *reinterpret_cast<float2*>(
              o + base + (long long)(t0 + m0 + g) * step + col) =
              make_float2(acc[n][0], acc[n][1]);
        if (t0 + m0 + g + 8 < S)
          *reinterpret_cast<float2*>(
              o + base + (long long)(t0 + m0 + g + 8) * step + col) =
              make_float2(acc[n][2], acc[n][3]);
      }
    }
    __syncthreads();                     // S0 is read no more

    // -- phase 5: S <- diag(P_C) S0 + kq^T V, in 16 x 16 strips (3xTF32) -----
    for (int unit = warp; unit < (HD / 16) * (HD / 16); unit += NT / 32) {
      const int m0 = (unit / (HD / 16)) * 16, n0 = (unit % (HD / 16)) * 16;
      float acc[2][4];
      const float q0 = qe_s[m0 + g], q1 = qe_s[m0 + g + 8];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = n0 + 8 * n + 2 * tg;
        acc[n][0] = q0 * S_s[(m0 + g) * SS + col];
        acc[n][1] = q0 * S_s[(m0 + g) * SS + col + 1];
        acc[n][2] = q1 * S_s[(m0 + g + 8) * SS + col];
        acc[n][3] = q1 * S_s[(m0 + g + 8) * SS + col + 1];
      }
      mma3_strip<C>(
          acc, [&](int row, int s) { return kq_s[s * KS + m0 + row]; },
          [&](int s, int col) { return v_s[s * VS + n0 + col]; }, g, tg);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = n0 + 8 * n + 2 * tg;
        S_s[(m0 + g) * SS + col] = acc[n][0];
        S_s[(m0 + g) * SS + col + 1] = acc[n][1];
        S_s[(m0 + g + 8) * SS + col] = acc[n][2];
        S_s[(m0 + g + 8) * SS + col + 1] = acc[n][3];
      }
    }
    __syncthreads();                     // before the next chunk's phase 2
  }
  for (int e = tid; e < HD * Q4; e += NT)
    reinterpret_cast<float4*>(sT + sbase)[e] =
        *reinterpret_cast<const float4*>(&S_s[(e / Q4) * SS + (e % Q4) * 4]);
}

template <typename T, int HD>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* w, const float* u, const float* s0, float* o,
                   float* sT, int B, int S, int H, cudaStream_t stream) {
  dim3 grid(H, B);
  if (S < C) {
    rwkv6_step_kernel<T, HD><<<grid, HD, 0, stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), w, u, s0, o, sT, S, H);
    return cudaGetLastError();
  }
  constexpr int bytes = ChunkSmem<HD>::BYTES;
  auto kern = rwkv6_chunk_kernel<T, HD>;
  cudaError_t err =
      repro::allow_smem(reinterpret_cast<const void*>(kern), bytes);
  if (err != cudaSuccess) return err;
  kern<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, o, sT, S, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* r, const void* k, const void* v,
                        const float* w, const float* u, const float* s0,
                        float* o, float* sT, int B, int S, int H,
                        cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(r, k, v, w, u, s0, o, sT, B, S, H, stream);
    case 64: return launch<T, 64>(r, k, v, w, u, s0, o, sT, B, S, H, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v [B,S,H,hd] contiguous of `dtype`; w [B,S,H,hd], u [H,hd], s0
// [B,H,hd,hd] contiguous fp32; o [B,S,H,hd] and sT [B,H,hd,hd] contiguous
// fp32.  Sequences of at least 32 steps take the chunked path, shorter
// ones the step path.  Returns the cudaError_t of the launch.
extern "C" int repro_rwkv6_scan(const void* r, const void* k, const void* v,
                                const float* w, const float* u,
                                const float* s0, float* o, float* sT,
                                int dtype, int B, int S, int H, int hd,
                                void* stream) {
  if (B <= 0 || H <= 0 || S < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == repro::DTYPE_BF16)
    err = dispatch_hd<__nv_bfloat16>(hd, r, k, v, w, u, s0, o, sT, B, S, H,
                                     s);
  else if (dtype == repro::DTYPE_F32)
    err = dispatch_hd<float>(hd, r, k, v, w, u, s0, o, sT, B, S, H, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
