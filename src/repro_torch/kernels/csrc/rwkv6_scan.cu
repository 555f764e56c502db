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
// What bounds it: operations, narrowly.  Each step does 5 hd^2 fp32 flops
// per (row, head) (the readout r^T S, 2 hd^2, and the decayed rank-1
// update, 3 hd^2) against 5 hd elements read or written: at hd = 64 about
// 23 flops per byte of r, k, v (bf16), w and o (fp32), just above the 20
// flop/byte at which the card's 67 fp32 TFLOP/s outrun its 3.35 TB/s.
// The recurrence is sequential in time, so the parallelism is B * H * hd
// lanes.
//
// Layout of the work: one block of hd threads per (head, batch row);
// thread j keeps column j of S (hd floats) in registers for the whole
// sequence, so the state never touches memory between steps.  Chunks of
// TT time steps of r, k, w are staged in shared memory (one coalesced
// row per step, read back as broadcasts); thread j holds its own v_t[j]
// in registers and writes o_t[j], so every global access is a coalesced
// row.  The readout sum over i runs in four interleaved partial sums
// combined in a fixed order, with no atomics: two launches give the same
// bits.
//
// Types: r, k, v are bf16 or fp32 (one type); w, u and the state are fp32
// (the wrapper casts w and u if they are not).  Head sizes 64 (the zoo's
// RWKV-6) and 16 (its smoke model): at 128 the column of S alone would
// take half the registers a thread may have, and a first build spilled.
//
// Later work (not here): the chunked form, where a block of C steps
// becomes dense [C, hd] x [hd, hd] products on the tensor cores with the
// decay folded into the operands, and only the chunk boundaries are
// sequential.
#include "common.cuh"

namespace {

constexpr int TT = 16;   // time steps staged in shared memory per chunk

template <typename T, int HD>
__global__ void __launch_bounds__(HD) rwkv6_scan_kernel(
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
    __syncthreads();                  // the previous chunk is consumed
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

template <typename T, int HD>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const float* w, const float* u, const float* s0, float* o,
                   float* sT, int B, int S, int H, cudaStream_t stream) {
  dim3 grid(H, B);
  rwkv6_scan_kernel<T, HD><<<grid, HD, 0, stream>>>(
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
// fp32.  Returns the cudaError_t of the launch.
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
