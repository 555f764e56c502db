// Flash-decode for Hopper: one new query token per sequence against a KV
// cache, grouped-query attention, online softmax in fp32.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention/kernel.py::decode_attention_kernel
// (body _decode_kernel): same masking (keys at or past `length` never count,
// NEG_INF = -1e30), same finalisation (a row with l == 0 outputs 0, and the
// logsumexp is m + log(l)).
//
// What bounds it: bytes.  Each step reads the valid prefix of K and V once
// (2 * length * hd * sizeof(T) per (row, kv head)) and does 4 flops per
// loaded element per query head, far below the ~295 flop/byte the card
// needs before its tensor cores matter.  So the design is about reading
// each K/V byte once, with enough of them in flight to fill the card:
//
// * One block per (split, kv head, batch row) holds all G query heads of
//   the group (any G from 1 to 16), its q tile [16, hd] in shared memory,
//   so a byte of the cache feeds every head of its group and is read once.
// * The valid prefix is split across blocks (flash-decoding): the host picks
//   the split count from the cache length Smax and the SM count, so that
//   the long caches fill the card (the rows' own lengths live on the card,
//   and reading them on the host would stall the stream).  A split whose
//   keys all lie at or past its row's length reads nothing.  The splits of
//   one (row, kv head) form a thread-block cluster; each leaves its
//   partial (m, l, acc) in its shared memory and, after a cluster barrier,
//   every block combines a slice of the outputs by logsumexp over its
//   peers' partials, read through distributed shared memory in split order.
//   One launch, no atomics, no scratch in device memory.
// * bf16: K/V tiles of 64 keys stream through a 2-3 stage cp.async ring
//   (zero-filled past the split's end), so the next tiles' loads overlap
//   this tile's arithmetic.  Each of the 4 warps takes 16 keys of a tile
//   and keeps its own online softmax: scores on mma.sync m16n8k16 (the 16
//   rows are the group's heads, fp32 accumulation), P re-used from the
//   score registers as the A operand of P @ V, V read with ldmatrix.trans;
//   the warps' partials merge in a fixed order at the end.
// * fp32: the same split and combine, with the scores and P @ V in fp32 FMA
//   over K/V read straight from device memory.
// Reductions run in a fixed order and there are no atomics, so the result
// repeats bit for bit from run to run.
//
// Later work (not here): read K/V through the paged block table instead of
// a gather.
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::NEG_INF;
using repro::smem_u32;

constexpr int NT = 128;          // threads a block
constexpr int NW = NT / 32;      // warps a block
constexpr int TK = 64;           // keys a tile
constexpr int ROWS = 16;         // query heads a block holds at most
constexpr int MAX_SPLITS = 8;    // blocks a cluster (the portable limit)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// returned by the entry point for what the kernel cannot take
constexpr int ERR_UNSUPPORTED = -1;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* out;
  float* lse;
  int H, G, Smax, chunk;         // chunk: keys a split (a multiple of TK)
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh;
  float scale_log2;              // hd^-0.5 * log2(e): scores in log2 units
};

// A partial in shared memory: m[ROWS], l[ROWS], acc[ROWS][HD] (fp32).
template <int HD>
__host__ __device__ constexpr int part_floats() {
  return 2 * ROWS + ROWS * HD;
}

// Per-row weights of the partials being merged: [MAX_SPLITS][ROWS] and
// each row's L after them (fp32, shared memory).
constexpr int WTS_FLOATS = (MAX_SPLITS + 1) * ROWS;

__device__ __forceinline__ void store4(float* dst, const float (&x)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst,
                                       const float (&x)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

// The cluster's partials -> out (and lse).  One thread a row finds M, the
// largest of the splits' m, each split's weight 2^(m - M) and L = sum of
// l * weight, in split order; then each block writes a slice of the G x HD
// outputs, sum of acc * weight in split order, over L.  A row with L == 0
// gives 0 and lse NEG_INF.
template <typename T, int HD>
__device__ void combine(float* part, float* wts, const Params& p, int b,
                        int c) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                        // every split's partial is written
  const int ns = cluster.num_blocks();
  const int rank = cluster.block_rank();
  const int G = p.G;
  if (threadIdx.x < G) {
    const int row = threadIdx.x;
    float m[MAX_SPLITS];
    float M = NEG_INF;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s)
      if (s < ns) {
        m[s] = cluster.map_shared_rank(part, s)[row];
        M = fmaxf(M, m[s]);
      }
    float L = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s)
      if (s < ns) {
        const float wgt = exp2f(m[s] - M);
        wts[s * ROWS + row] = wgt;
        L = fmaf(cluster.map_shared_rank(part, s)[ROWS + row], wgt, L);
      }
    wts[MAX_SPLITS * ROWS + row] = L;
    if (p.lse != nullptr && rank == 0)
      p.lse[(long long)b * p.H + c * G + row] =
          L == 0.f ? NEG_INF : (M + log2f(L)) * LN2;
  }
  __syncthreads();
  for (int e = (rank * NT + threadIdx.x) * 4; e < G * HD; e += ns * NT * 4) {
    const int row = e / HD, d = e % HD;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < ns; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, s) + 2 * ROWS + e);
      const float wgt = wts[s * ROWS + row];
      a[0] = fmaf(x.x, wgt, a[0]);
      a[1] = fmaf(x.y, wgt, a[1]);
      a[2] = fmaf(x.z, wgt, a[2]);
      a[3] = fmaf(x.w, wgt, a[3]);
    }
    const float L = wts[MAX_SPLITS * ROWS + row];
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] = L == 0.f ? 0.f : a[j] / L;
    store4(static_cast<T*>(p.out) + b * p.o_sb + (c * G + row) * p.o_sh + d,
           a);
  }
  cluster.sync();                        // peers are done reading this block
}

// ---------------------------------------------------------------------------
// bf16: mma.sync over a cp.async ring
// ---------------------------------------------------------------------------

template <int HD>
struct Bf16Shape {
  static constexpr int STAGES = HD >= 256 ? 2 : 3;
  static constexpr int ROW_BYTES = HD * 2;
  static constexpr int TILE = TK * ROW_BYTES;        // one of K, V
  static constexpr int RING = STAGES * 2 * TILE;
  static constexpr int SCRATCH = NW * part_floats<HD>() * 4;  // over the ring
  static constexpr int LOW = RING > SCRATCH ? RING : SCRATCH;
  static constexpr int QB = ROWS * ROW_BYTES;
  static constexpr int SMEM = LOW + QB + (part_floats<HD>() + WTS_FLOATS) * 4;
};

// byte offset of 16-byte chunk `ch` of row `row` in a [rows][HD] bf16 tile,
// the chunks of each row permuted by row % 8 so that ldmatrix's eight row
// reads fall on distinct banks
template <int HD>
__device__ __forceinline__ int swz(int row, int ch) {
  return row * (HD * 2) + ((ch ^ (row & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(NT) decode_bf16_kernel(Params p) {
  using Sh = Bf16Shape<HD>;
  constexpr int CPR = HD / 8;            // 16-byte chunks a row
  constexpr int PF = part_floats<HD>();
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* qs = smem + Sh::LOW;
  float* part = reinterpret_cast<float*>(qs + Sh::QB);
  float* wts = part + PF;

  const int c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = p.G;
  const int length = max(0, min(p.lengths[b], p.Smax));
  const int k0 = blockIdx.x * p.chunk;
  const int k1 = min(k0 + p.chunk, length);
  const int ntiles = k1 > k0 ? (k1 - k0 + TK - 1) / TK : 0;

  if (ntiles == 0) {                     // nothing of this split is valid
    for (int e = tid; e < G; e += NT) {
      part[e] = NEG_INF;
      part[ROWS + e] = 0.f;
    }
    for (int e = tid; e < G * HD; e += NT) part[2 * ROWS + e] = 0.f;
    combine<__nv_bfloat16, HD>(part, wts, p, b, c);
    return;
  }

  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + c * p.k_sh;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + c * p.v_sh;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(p.q) +
                            b * p.q_sb + (long long)c * G * p.q_sh;
  for (int e = tid; e < ROWS * CPR; e += NT) {
    const int row = e / CPR, ch = e % CPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < G)
      val = *reinterpret_cast<const uint4*>(qb + row * p.q_sh + ch * 8);
    *reinterpret_cast<uint4*>(qs + swz<HD>(row, ch)) = val;
  }

  auto load_tile = [&](int tile) {
    const int pos0 = k0 + tile * TK;
    const uint32_t kd = smem_u32(smem + (tile % Sh::STAGES) * 2 * Sh::TILE);
    const uint32_t vd = kd + Sh::TILE;
#pragma unroll 4
    for (int e = tid; e < TK * CPR; e += NT) {
      const int row = e / CPR, ch = e % CPR;
      const bool ok = pos0 + row < k1;
      const long long pos = ok ? pos0 + row : 0;
      cp_async16(kd + swz<HD>(row, ch), kb + pos * p.k_ss + ch * 8, ok);
      cp_async16(vd + swz<HD>(row, ch), vb + pos * p.v_ss + ch * 8, ok);
    }
  };

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;   // rows r0, r0 + 8
  const int r0 = lane / 4;
  const int n0 = warp * 16;              // this warp's keys in a tile
  const int mi = lane >> 3, mr = lane & 7;   // ldmatrix: matrix, row
  const uint32_t qaddr = smem_u32(qs);

#pragma unroll
  for (int s = 0; s < Sh::STAGES - 1; ++s) {
    if (s < ntiles) load_tile(s);
    cp_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    cp_wait<Sh::STAGES - 2>();
    __syncthreads();                     // tile t landed; tile t-1 consumed
    if (t + Sh::STAGES - 1 < ntiles) load_tile(t + Sh::STAGES - 1);
    cp_commit();

    const uint32_t kaddr = smem_u32(smem + (t % Sh::STAGES) * 2 * Sh::TILE);
    const uint32_t vaddr = kaddr + Sh::TILE;
    // scores: [16 heads] x [16 keys] of this warp, two n8 tiles
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4], bk[4];
      ldsm_x4(qaddr + swz<HD>(mr + (mi & 1) * 8, kk * 2 + (mi >> 1)), a);
      ldsm_x4(kaddr + swz<HD>(n0 + mr + (mi >> 1) * 8, kk * 2 + (mi & 1)),
              bk);
      mma_bf16(sc[0], a, bk[0], bk[1]);
      mma_bf16(sc[1], a, bk[2], bk[3]);
    }
    // online softmax over the warp's 16 keys, in log2 units
    const int pos0 = k0 + t * TK + n0 + 2 * (lane & 3);
    bool ok[2][2];
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        ok[n][e] = pos0 + n * 8 + e < k1;
        sc[n][e] = ok[n][e] ? sc[n][e] * p.scale_log2 : NEG_INF;
        sc[n][2 + e] = ok[n][e] ? sc[n][2 + e] * p.scale_log2 : NEG_INF;
        mx0 = fmaxf(mx0, sc[n][e]);
        mx1 = fmaxf(mx1, sc[n][2 + e]);
      }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[n][e] = ok[n][e] ? exp2f(sc[n][e] - mn0) : 0.f;
        sc[n][2 + e] = ok[n][e] ? exp2f(sc[n][2 + e] - mn1) : 0.f;
        sum0 += sc[n][e];
        sum1 += sc[n][2 + e];
      }
    l0 = fmaf(l0, al0, sum0);
    l1 = fmaf(l1, al1, sum1);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }
    // P (the score registers, as bf16) @ V
    const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]),
                            pack_bf16(sc[0][2], sc[0][3]),
                            pack_bf16(sc[1][0], sc[1][1]),
                            pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
    for (int d = 0; d < HD / 16; ++d) {
      uint32_t bv[4];
      ldsm_x4_t(vaddr + swz<HD>(n0 + mr + (mi & 1) * 8, d * 2 + (mi >> 1)),
                bv);
      mma_bf16(acc[2 * d], pa, bv[0], bv[1]);
      mma_bf16(acc[2 * d + 1], pa, bv[2], bv[3]);
    }
  }
  cp_wait<0>();
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }
  __syncthreads();                       // the ring becomes the warps' scratch
  float* wp = reinterpret_cast<float*>(smem) + warp * PF;
  if ((lane & 3) == 0) {
    wp[r0] = m0;
    wp[r0 + 8] = m1;
    wp[ROWS + r0] = l0;
    wp[ROWS + r0 + 8] = l1;
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int col = n * 8 + 2 * (lane & 3);
    float* a0 = wp + 2 * ROWS + r0 * HD + col;
    float* a1 = a0 + 8 * HD;
    a0[0] = acc[n][0];
    a0[1] = acc[n][1];
    a1[0] = acc[n][2];
    a1[1] = acc[n][3];
  }
  __syncthreads();
  // the block's partial: the warps' merged in warp order, weights first
  const float* ws = reinterpret_cast<const float*>(smem);
  if (tid < G) {
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, ws[w * PF + tid]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float wgt = exp2f(ws[w * PF + tid] - M);
      wts[w * ROWS + tid] = wgt;
      L = fmaf(ws[w * PF + ROWS + tid], wgt, L);
    }
    part[tid] = M;
    part[ROWS + tid] = L;
  }
  __syncthreads();
  for (int e = tid * 4; e < G * HD; e += NT * 4) {
    const int row = e / HD;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float4 x =
          *reinterpret_cast<const float4*>(ws + w * PF + 2 * ROWS + e);
      const float wgt = wts[w * ROWS + row];
      a[0] = fmaf(x.x, wgt, a[0]);
      a[1] = fmaf(x.y, wgt, a[1]);
      a[2] = fmaf(x.z, wgt, a[2]);
      a[3] = fmaf(x.w, wgt, a[3]);
    }
    store4(part + 2 * ROWS + e, a);
  }
  combine<__nv_bfloat16, HD>(part, wts, p, b, c);
}

// ---------------------------------------------------------------------------
// fp32: FMA, the block's heads and keys shared out over its threads
// ---------------------------------------------------------------------------

template <int HD>
constexpr int f32_smem_bytes() {
  return (ROWS * HD + ROWS * TK + ROWS + part_floats<HD>() + WTS_FLOATS) * 4;
}

template <int HD>
__global__ void __launch_bounds__(NT) decode_f32_kernel(Params p) {
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                       // [ROWS][HD]
  float* sp = qs + ROWS * HD;            // scores, then P: [ROWS][TK]
  float* alpha = sp + ROWS * TK;         // [ROWS]
  float* part = alpha + ROWS;            // m, l, acc
  float* wts = part + part_floats<HD>();

  const int c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = p.G;
  const int length = max(0, min(p.lengths[b], p.Smax));
  const int k0 = blockIdx.x * p.chunk;
  const int k1 = min(k0 + p.chunk, length);
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + c * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + c * p.v_sh;
  const float* qb =
      static_cast<const float*>(p.q) + b * p.q_sb + (long long)c * G * p.q_sh;

  for (int e = tid; e < G * HD; e += NT)
    qs[e] = qb[(e / HD) * p.q_sh + e % HD];
  for (int e = tid; e < G; e += NT) {
    part[e] = NEG_INF;
    part[ROWS + e] = 0.f;
  }
  for (int e = tid; e < G * HD; e += NT) part[2 * ROWS + e] = 0.f;
  __syncthreads();

  for (int t0 = k0; t0 < k1; t0 += TK) {
    const int n = min(TK, k1 - t0);
    for (int e = tid; e < G * TK; e += NT) {
      const int g = e / TK, j = e % TK;
      float s = NEG_INF;
      if (j < n) {
        const float* kr = kb + (long long)(t0 + j) * p.k_ss;
        const float* qr = qs + g * HD;
        float d = 0.f;
#pragma unroll 4
        for (int i = 0; i < HD; i += 4) {
          const float4 k4 = *reinterpret_cast<const float4*>(kr + i);
          const float4 q4 = *reinterpret_cast<const float4*>(qr + i);
          d = fmaf(q4.x, k4.x, d);
          d = fmaf(q4.y, k4.y, d);
          d = fmaf(q4.z, k4.z, d);
          d = fmaf(q4.w, k4.w, d);
        }
        s = d * p.scale_log2;
      }
      sp[g * TK + j] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += NW) {
      const bool ok0 = lane < n, ok1 = lane + 32 < n;
      const float s0 = sp[g * TK + lane], s1 = sp[g * TK + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = part[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = ok0 ? exp2f(s0 - m_new) : 0.f;
      const float p1 = ok1 ? exp2f(s1 - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sp[g * TK + lane] = p0;
      sp[g * TK + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float al = exp2f(m_prev - m_new);
        alpha[g] = al;
        part[ROWS + g] = fmaf(part[ROWS + g], al, sum);
        part[g] = m_new;
      }
    }
    __syncthreads();
    for (int e = tid; e < G * HD; e += NT) {
      const int g = e / HD, d = e % HD;
      float a = part[2 * ROWS + e] * alpha[g];
      const float* vr = vb + (long long)t0 * p.v_ss + d;
      for (int j = 0; j < n; ++j) a = fmaf(sp[g * TK + j], vr[j * p.v_ss], a);
      part[2 * ROWS + e] = a;
    }
    __syncthreads();
  }
  combine<float, HD>(part, wts, p, b, c);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kern>
cudaError_t launch_cluster(Kern kern, int bytes, int splits, int KV, int B,
                           const Params& p, cudaStream_t stream) {
  cudaError_t err =
      repro::allow_smem(reinterpret_cast<const void*>(kern), bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, KV, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;     // one split: no cluster to form
  err = cudaLaunchKernelEx(&cfg, kern, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(bool bf16, int splits, int KV, int B, const Params& p,
                      cudaStream_t stream) {
  if (bf16)
    return launch_cluster(decode_bf16_kernel<HD>, Bf16Shape<HD>::SMEM, splits,
                          KV, B, p, stream);
  return launch_cluster(decode_f32_kernel<HD>, f32_smem_bytes<HD>(), splits,
                        KV, B, p, stream);
}

// Splits a (row, kv head): a power of two (the cluster's size), at most
// MAX_SPLITS and the cache's tiles, and enough that B * KV * splits blocks
// fill the card's SMs.
int split_count(int B, int KV, int Smax, int sms) {
  const int tiles = (Smax + TK - 1) / TK;
  const int want = (sms + B * KV - 1) / (B * KV);
  int splits = 1;
  while (splits < want && 2 * splits <= MAX_SPLITS && 2 * splits <= tiles)
    splits *= 2;
  return splits;
}

bool aligned16(const void* ptr, const long long* strides, int n, int elem) {
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  for (int i = 0; i < n; ++i)
    if ((strides[i] * elem) % 16) return false;
  return true;
}

}  // namespace

// q [B,H,hd] by strides (q_sb, q_sh); k, v [B,Smax,KV,hd] by strides
// (sb, ss, sh); out [B,H,hd] by strides (o_sb, o_sh); lse [B,H] fp32 or
// NULL.  The last dim of every tensor is contiguous.  strides[10] =
// {q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh}, in elements.
// Returns the cudaError_t of the launch, or ERR_UNSUPPORTED (-1) where the
// kernel cannot take the input: hd not 64, 128 or 256, more than 16 q heads
// a kv head, or rows of q, k, v or out not 16-byte aligned.
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const int* lengths,
                                      void* out, float* lse, int dtype, int B,
                                      int H, int KV, int Smax, int hd,
                                      const long long* strides, float scale,
                                      void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || Smax <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype != repro::DTYPE_BF16 && dtype != repro::DTYPE_F32)
    return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  const int elem = dtype == repro::DTYPE_BF16 ? 2 : 4;
  if (G < 1 || G > ROWS || (hd != 64 && hd != 128 && hd != 256) ||
      !aligned16(q, strides, 2, elem) || !aligned16(k, strides + 2, 3, elem) ||
      !aligned16(v, strides + 5, 3, elem) ||
      !aligned16(out, strides + 8, 2, elem))
    return ERR_UNSUPPORTED;
  int sms = 0;
  cudaError_t err = repro::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int splits = split_count(B, KV, Smax, sms);
  const int tiles = (Smax + TK - 1) / TK;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.lengths = lengths;
  p.out = out;
  p.lse = lse;
  p.H = H;
  p.G = G;
  p.Smax = Smax;
  p.chunk = (tiles + splits - 1) / splits * TK;
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.k_sb = strides[2];
  p.k_ss = strides[3];
  p.k_sh = strides[4];
  p.v_sb = strides[5];
  p.v_ss = strides[6];
  p.v_sh = strides[7];
  p.o_sb = strides[8];
  p.o_sh = strides[9];
  p.scale_log2 = scale * LOG2E;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = dtype == repro::DTYPE_BF16;
  switch (hd) {
    case 64: err = launch_hd<64>(bf16, splits, KV, B, p, s); break;
    case 128: err = launch_hd<128>(bf16, splits, KV, B, p, s); break;
    default: err = launch_hd<256>(bf16, splits, KV, B, p, s); break;
  }
  return (int)err;
}
