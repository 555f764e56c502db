// Flash attention forward for Hopper: causal or sliding-window grouped-query
// attention over full sequences, online softmax in fp32.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel
// (body _flash_kernel): q position i sits at kv position i + Skv - Sq; key j
// counts for query i when j < Skv, j <= i (causal) and j > i - window
// (window > 0); kv tiles wholly outside that band are never loaded; q head h
// reads kv head h / (H / KV).  A masked key contributes exactly 0, so a row
// with no valid key outputs 0.
//
// What bounds it: at the prefill shapes of the served model (32 q heads,
// 8 kv heads, hd = 128, a few hundred tokens) causal attention does about
// 150 flops per byte it must move (q, k, v read once, the output written
// once), below the ~295 flop/byte at which the card's bf16 tensor cores
// become the limit, so the bound is bytes; past ~750 tokens it turns into
// operations.  The design keeps the [Sq, Skv] scores out of device memory
// (one online softmax per q row), never loads a kv tile outside the causal /
// window band (about half the work of a dense pass), and reads q, k, v and
// writes the output in the model's [B, S, heads, hd] layout through strides
// (no transpose passes).  Each (q tile, q head) block re-reads its kv head's
// tiles, mostly from L2; one block per GQA group, wgmma and TMA loads are
// later work.  At hd = 256 (recurrentgemma's local attention: 16 q heads
// on one kv head, window 2048) the same holds: at S = 384 about 120
// flops per byte, bound by bytes.
//
// Two variants share that algorithm:
//   bf16 (the served model): products on the tensor cores with mma.sync
//     m16n8k16 and fp32 accumulation; see flash_attention_mma_kernel.
//   fp32 (tests and references): fp32 FMAs from shared-memory tiles, exact
//     to fp32 rounding.  One block of 128 threads per (32-row q tile, q
//     head, batch row); thread t owns q row t / 4, score columns
//     t % 4 + 4 i and output dims t % 4 + 4 i.
// In both, a row's softmax statistics live in the 4 lanes of one quad and
// combine by 2-step shuffles in a fixed order (no atomics: results repeat
// bit for bit).
#include <type_traits>

#include "common.cuh"

namespace {

using repro::NEG_INF;

constexpr int BQ = 32;     // q rows per block
constexpr int BK = 32;     // kv rows per tile
constexpr int NT = 128;    // threads: 4 per q row

template <int HD>
constexpr int smem_floats() {
  // sQ [BQ][HD+1], sK [BK][HD+1], sV [BK][HD], sS [BQ][BK+1]
  return BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int H, int KV, int Sq, int Skv, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, int causal, int window,
    float scale) {
  constexpr int QS = HD + 1;   // padded row strides: no bank conflicts
  constexpr int KS = HD + 1;
  constexpr int SS = BK + 1;
  constexpr int NC = BK / 4;   // score columns per thread
  constexpr int ND = HD / 4;   // output dims per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * QS;
  float* sV = sK + BK * KS;
  float* sS = sV + BK * HD;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c = h / (H / KV);
  const int tid = threadIdx.x;
  const int r = tid >> 2, quarter = tid & 3;
  const int q_off = Skv - Sq;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + c * k_sh;
  const T* vb = v + b * v_sb + c * v_sh;

  for (int i = tid; i < BQ * HD; i += NT) {
    const int row = i / HD, d = i % HD;
    const int qi = q0 + row;
    sQ[row * QS + d] = qi < Sq ? repro::to_f32(qb[qi * q_ss + d]) : 0.f;
  }

  // kv range that the band of this q tile can see
  const int qpos_lo = q0 + q_off;
  const int qpos_hi = min(q0 + BQ, Sq) - 1 + q_off;
  int k_end = Skv;
  if (causal) k_end = min(k_end, qpos_hi + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, qpos_lo - window + 1);
  k_begin = (k_begin / BK) * BK;

  const int qpos = q0 + r + q_off;   // this thread's q position
  float m = NEG_INF, l = 0.f;
  float acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.f;

  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();   // previous tile fully consumed (and sQ written)
    for (int i = tid; i < BK * HD; i += NT) {
      const int row = i / HD, d = i % HD;
      const int kj = kt + row;
      const bool ok = kj < Skv;
      sK[row * KS + d] = ok ? repro::to_f32(kb[kj * k_ss + d]) : 0.f;
      sV[row * HD + d] = ok ? repro::to_f32(vb[kj * v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) s[i] = 0.f;
    const float* qrow = sQ + r * QS;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int i = 0; i < NC; ++i)
        s[i] = fmaf(qd, sK[(quarter + 4 * i) * KS + d], s[i]);
    }

    bool valid[NC];
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int kp = kt + quarter + 4 * i;
      bool ok = kp < Skv;
      if (causal) ok = ok && kp <= qpos;
      if (window > 0) ok = ok && kp > qpos - window;
      valid[i] = ok;
      s[i] = ok ? s[i] * scale : NEG_INF;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float sum = 0.f;
    float* srow = sS + r * SS;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const float p = valid[i] ? expf(s[i] - m_new) : 0.f;
      srow[quarter + 4 * i] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * alpha + sum;
    m = m_new;
    __syncwarp();      // the row's 4 threads share one warp

#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] *= alpha;
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float p = srow[j];
      const float* vrow = sV + j * HD + quarter;
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[i] = fmaf(p, vrow[4 * i], acc[i]);
    }
  }

  const int qi = q0 + r;
  if (qi < Sq) {
    const float lsafe = (l == 0.f) ? 1.f : l;
    T* orow = out + b * o_sb + qi * o_ss + h * o_sh + quarter;
#pragma unroll
    for (int i = 0; i < ND; ++i)
      orow[4 * i] = repro::from_f32<T>(acc[i] / lsafe);
  }
}

// --------------------------------------------------------------------------
// bf16: the same algorithm on the tensor cores (mma.sync m16n8k16, fp32
// accumulate).  One block of 4 warps per (64-row q tile, q head, batch row);
// warp w owns q rows 16w .. 16w+15.  S = Q K^T for a 64-key tile stays in
// registers, the online softmax runs on those registers (a row's values sit
// in the 4 lanes of one quad), and P is repacked in registers as the A
// operand of P V, so scores never touch shared memory.
// --------------------------------------------------------------------------

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // .x (lo) in bits 0-15
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

constexpr int MQ = 64;      // q rows per block (16 per warp)
constexpr int MK = 64;      // kv rows per tile

template <int HD>
constexpr int mma_smem_bytes() {
  return 3 * MQ * (HD + 8) * 2;   // sQ, sK, sV, rows padded by 16 bytes
}

// Copy `rows` rows of HD bf16 (row stride `ld` elements in global memory)
// into shared memory rows of stride HD + 8, zero past `valid` rows.
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ld, int rows, int valid,
                                          int tid) {
  constexpr int CPR = HD / 8;    // 16-byte chunks per row
  for (int i = tid; i < rows * CPR; i += NT) {
    const int row = i / CPR, ch = i % CPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < valid)
      val = *reinterpret_cast<const uint4*>(src + row * ld + ch * 8);
    *reinterpret_cast<uint4*>(dst + row * (HD + 8) + ch * 8) = val;
  }
}

// The A fragment of Q for k-step ks (rows r0 and r0 + 8) from sQ.
template <int HD>
__device__ __forceinline__ void q_frag(const __nv_bfloat16* sQ, int r0,
                                       int ks, int t, uint32_t (&a)[4]) {
  constexpr int LD = HD + 8;
  const __nv_bfloat16* p = sQ + r0 * LD + ks * 16 + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
}

template <int HD>
__global__ void __launch_bounds__(NT) flash_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int H, int KV, int Sq, int Skv, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int window, float scale) {
  constexpr int LD = HD + 8;       // shared row stride: conflict-free frags
  constexpr int KS = HD / 16;      // k-steps of Q K^T
  constexpr int NS = MK / 8;       // 8-key column tiles of S
  constexpr int NO = HD / 8;       // 8-dim column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + MQ * LD;
  __nv_bfloat16* sV = sK + MK * LD;

  const int q0 = blockIdx.x * MQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q_off = Skv - Sq;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + c * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + c * v_sh;

  load_tile<HD>(sQ, qb + q0 * q_ss, q_ss, MQ, Sq - q0, tid);
  __syncthreads();
  const int r0 = warp * 16 + g;    // this thread's rows: r0 and r0 + 8
  // Q's A fragments: held in registers up to HD = 128; at HD = 256 they
  // would take 64 registers beside the 128 of O, so they are read from
  // sQ (which stays resident) at each use instead.
  constexpr bool QREG = HD <= 128;
  uint32_t qa[QREG ? KS : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) q_frag<HD>(sQ, r0, ks, t, qa[ks]);
  }

  const int qpos_lo = q0 + q_off;
  const int qpos_hi = min(q0 + MQ, Sq) - 1 + q_off;
  int k_end = Skv;
  if (causal) k_end = min(k_end, qpos_hi + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, qpos_lo - window + 1);
  k_begin = (k_begin / MK) * MK;

  const int qp[2] = {q0 + r0 + q_off, q0 + r0 + 8 + q_off};
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int kt = k_begin; kt < k_end; kt += MK) {
    __syncthreads();   // previous tile fully consumed
    load_tile<HD>(sK, kb + kt * k_ss, k_ss, MK, Skv - kt, tid);
    load_tile<HD>(sV, vb + kt * v_ss, v_ss, MK, Skv - kt, tid);
    __syncthreads();

    // S = Q K^T (fp32 accumulators, row r0: s[j][0..1], row r0+8: [2..3])
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const __nv_bfloat16* p = sK + (j * 8 + g) * LD + ks * 16 + 2 * t;
        uint32_t a[4];
        if constexpr (QREG) {
          a[0] = qa[ks][0]; a[1] = qa[ks][1];
          a[2] = qa[ks][2]; a[3] = qa[ks][3];
        } else {
          q_frag<HD>(sQ, r0, ks, t, a);
        }
        mma_16816(s[j], a, *reinterpret_cast<const uint32_t*>(p),
                  *reinterpret_cast<const uint32_t*>(p + 8));
      }
    }

    // mask, then the online softmax of each of the thread's two rows
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = kt + j * 8 + 2 * t + (e & 1);
        const int r = e >> 1;
        bool ok = kp < Skv;
        if (causal) ok = ok && kp <= qp[r];
        if (window > 0) ok = ok && kp > qp[r] - window;
        s[j][e] = ok ? s[j][e] * scale : NEG_INF;
        mx[r] = fmaxf(mx[r], s[j][e]);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        // masked scores hold NEG_INF exactly and contribute exactly 0
        const float p = s[j][e] > 0.5f * NEG_INF ? expf(s[j][e] - m[r]) : 0.f;
        s[j][e] = p;
        sum[r] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: the S accumulators of key tiles 2u, 2u+1 are the A operand
#pragma unroll
    for (int u = 0; u < MK / 16; ++u) {
      const uint32_t pa[4] = {pack_f32(s[2 * u][0], s[2 * u][1]),
                              pack_f32(s[2 * u][2], s[2 * u][3]),
                              pack_f32(s[2 * u + 1][0], s[2 * u + 1][1]),
                              pack_f32(s[2 * u + 1][2], s[2 * u + 1][3])};
      const __nv_bfloat16* vp = sV + (u * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* p = vp + n * 8;
        mma_16816(o[n], pa, pack_bf16(p[0], p[LD]),
                  pack_bf16(p[8 * LD], p[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + r0 + 8 * r;
    if (qi >= Sq) continue;
    const float lsafe = (l[r] == 0.f) ? 1.f : l[r];
    __nv_bfloat16* orow = out + b * o_sb + qi * o_ss + h * o_sh + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) = __floats2bfloat162_rn(
          o[n][2 * r] / lsafe, o[n][2 * r + 1] / lsafe);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int KV, int Sq, int Skv,
                   const long long* st, int causal, int window, float scale,
                   cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    constexpr int bytes = mma_smem_bytes<HD>();
    auto kern = flash_attention_mma_kernel<HD>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + MQ - 1) / MQ, H, B);
    kern<<<grid, NT, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), H, KV, Sq, Skv,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
        st[10], st[11], causal, window, scale);
  } else {
    constexpr int bytes = smem_floats<HD>() * (int)sizeof(float);
    auto kern = flash_attention_kernel<T, HD>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + BQ - 1) / BQ, H, B);
    kern<<<grid, NT, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), H, KV, Sq, Skv,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
        st[10], st[11], causal, window, scale);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* out, int B, int H, int KV, int Sq, int Skv,
                        const long long* st, int causal, int window,
                        float scale, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch<T, 64>(q, k, v, out, B, H, KV, Sq, Skv, st, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, H, KV, Sq, Skv, st, causal, window, scale, stream);
    case 256: return launch<T, 256>(q, k, v, out, B, H, KV, Sq, Skv, st, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,Sq,H,hd], k and v [B,Skv,KV,hd], out [B,Sq,H,hd], each by strides
// (sb, ss, sh) in elements with a contiguous last dim: strides[12] =
// {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh}.
// Returns the cudaError_t of the launch.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int dtype,
                                     int B, int H, int KV, int Sq, int Skv,
                                     int hd, const long long* strides,
                                     int causal, int window, float scale,
                                     void* stream) {
  if (KV <= 0 || H % KV != 0 || Sq <= 0 || Skv <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == repro::DTYPE_BF16)
    err = dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, B, H, KV, Sq, Skv,
                                     strides, causal, window, scale, s);
  else if (dtype == repro::DTYPE_F32)
    err = dispatch_hd<float>(hd, q, k, v, out, B, H, KV, Sq, Skv, strides,
                             causal, window, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
