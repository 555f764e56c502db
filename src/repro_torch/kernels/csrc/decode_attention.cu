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
// loaded element, far below the ~295 flop/byte the card needs before its
// tensor cores matter.  The design therefore reads each K/V row exactly once
// per (batch row, kv head), not once per query head: one thread block holds
// all G query heads of a GQA group, so a byte of cache feeds G heads (at
// G = 16, four blocks of 4 heads each read it, see below).  It
// reads the model's cache layout [B, Smax, KV, hd] through strides, with no
// transpose pass before it, and only up to `length`.
//
// Layout of the work: one block of HD threads per (kv head, batch row,
// group of GB query heads).  GB is the whole GQA group G up to G = 8; at
// G = 16 (recurrentgemma's local attention: 16 q heads on 1 kv head)
// the group splits into four blocks of GB = 4 heads along the grid's z
// axis, each reading the same K/V rows (from L2 after the first), which
// keeps the query rows in registers: 16 rows x 16 dims a lane would not
// fit.
//   scores   LPK lanes per key (8, or 16 at HD = 256), each holding 16
//            dims of the key (8 at HD = 64) and of the GB query rows; a
//            log2(LPK)-step shuffle sums the partial dots.
//   softmax  one warp per query row, 2 scores a lane, over a 64-key tile.
//   P @ V    thread d owns output dim d for all GB rows.
// Reductions run in a fixed order and there are no atomics, so the result
// repeats bit for bit from run to run.
//
// Later work (not here): split long caches across blocks with a logsumexp
// combine, and read K/V through the paged block table instead of a gather.
#include "common.cuh"

namespace {

using repro::NEG_INF;

constexpr int TK = 64;   // keys per tile

template <typename T, int HD, int GB>
__global__ void __launch_bounds__(HD) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, T* __restrict__ out,
    float* __restrict__ lse, int H, int Smax, long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_sh,
    float scale, int G) {
  constexpr int LPK = HD >= 256 ? 16 : 8;   // lanes per key, score phase
  constexpr int NW = HD / 32;          // warps
  constexpr int CH = HD / LPK;         // dims per lane in the score phase
  constexpr int KPW = 32 / LPK;        // keys per warp per pass
  static_assert(TK % (NW * KPW) == 0, "tile must split evenly over warps");
  static_assert(TK == 64, "softmax phase holds 2 scores per lane");

  __shared__ float s_p[GB][TK];
  __shared__ float s_alpha[GB];
  __shared__ float s_m[GB];
  __shared__ float s_l[GB];

  const int c = blockIdx.x;            // kv head
  const int b = blockIdx.y;            // batch row
  const int h0 = c * G + blockIdx.z * GB;   // first q head of the block
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int sub = lane / LPK, part = lane % LPK;
  const int length = max(0, min(lengths[b], Smax));

  float qr[GB][CH];
#pragma unroll
  for (int g = 0; g < GB; ++g)
    repro::load_row<CH>(q + b * q_sb + (h0 + g) * q_sh + part * CH, qr[g]);

  float acc[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) acc[g] = 0.f;
  if (tid < GB) {
    s_m[tid] = NEG_INF;
    s_l[tid] = 0.f;
  }
  __syncthreads();

  const T* kb = k + b * k_sb + c * k_sh;
  const T* vb = v + b * v_sb + c * v_sh;

  for (int t0 = 0; t0 < length; t0 += TK) {
    // -- scores: s[g][j] = q_g . k_j * scale, NEG_INF past length --------
    for (int j = warp * KPW + sub; j < TK; j += NW * KPW) {
      const int pos = t0 + j;
      const bool ok = pos < length;
      float kr[CH];
      if (ok) {
        repro::load_row<CH>(kb + pos * k_ss + part * CH, kr);
      } else {
#pragma unroll
        for (int i = 0; i < CH; ++i) kr[i] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < CH; ++i) d = fmaf(qr[g][i], kr[i], d);
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        if (part == 0) s_p[g][j] = ok ? d * scale : NEG_INF;
      }
    }
    __syncthreads();

    // -- online softmax: one warp per query row -------------------------
    for (int g = warp; g < GB; g += NW) {
      const float s0 = s_p[g][lane], s1 = s_p[g][lane + 32];
      const bool ok0 = t0 + lane < length, ok1 = t0 + lane + 32 < length;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = s_m[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      s_p[g][lane] = p0;
      s_p[g][lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        s_alpha[g] = alpha;
        s_l[g] = s_l[g] * alpha + sum;
        s_m[g] = m_new;
      }
    }
    __syncthreads();

    // -- acc = acc * alpha + P @ V: thread tid owns dim tid -------------
    const int nk = min(TK, length - t0);
#pragma unroll
    for (int g = 0; g < GB; ++g) acc[g] *= s_alpha[g];
    const T* vt = vb + (long long)t0 * v_ss + tid;
#pragma unroll 8
    for (int j = 0; j < nk; ++j) {
      const float vv = repro::to_f32(vt[j * v_ss]);
#pragma unroll
      for (int g = 0; g < GB; ++g) acc[g] = fmaf(s_p[g][j], vv, acc[g]);
    }
    __syncthreads();   // s_p is rewritten by the next tile
  }

#pragma unroll
  for (int g = 0; g < GB; ++g) {
    const float l = s_l[g];
    const float lsafe = (l == 0.f) ? 1.f : l;
    out[b * o_sb + (h0 + g) * o_sh + tid] =
        repro::from_f32<T>(acc[g] / lsafe);
  }
  if (lse != nullptr && tid < GB) {
    const float l = s_l[tid];
    const float lsafe = (l == 0.f) ? 1.f : l;
    lse[(long long)b * H + h0 + tid] = s_m[tid] + logf(lsafe);
  }
}

template <typename T, int HD, int GB>
cudaError_t launch(int G, const void* q, const void* k, const void* v,
                   const int* lengths, void* out, float* lse, int B, int H,
                   int KV, int Smax, const long long* st, float scale,
                   cudaStream_t stream) {
  dim3 grid(KV, B, G / GB);
  decode_attention_kernel<T, HD, GB><<<grid, HD, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), lse, H, Smax,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      scale, G);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_g(int G, const void* q, const void* k, const void* v,
                       const int* lengths, void* out, float* lse, int B,
                       int H, int KV, int Smax, const long long* st,
                       float scale, cudaStream_t stream) {
  switch (G) {
    case 1: return launch<T, HD, 1>(G, q, k, v, lengths, out, lse, B, H, KV, Smax, st, scale, stream);
    case 2: return launch<T, HD, 2>(G, q, k, v, lengths, out, lse, B, H, KV, Smax, st, scale, stream);
    case 4: return launch<T, HD, 4>(G, q, k, v, lengths, out, lse, B, H, KV, Smax, st, scale, stream);
    case 8: return launch<T, HD, 8>(G, q, k, v, lengths, out, lse, B, H, KV, Smax, st, scale, stream);
    case 16: return launch<T, HD, 4>(G, q, k, v, lengths, out, lse, B, H, KV, Smax, st, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_hd(int hd, int G, const void* q, const void* k,
                        const void* v, const int* lengths, void* out,
                        float* lse, int B, int H, int KV, int Smax,
                        const long long* st, float scale,
                        cudaStream_t stream) {
  switch (hd) {
    case 64: return dispatch_g<T, 64>(G, q, k, v, lengths, out, lse, B, H, KV, Smax, st, scale, stream);
    case 128: return dispatch_g<T, 128>(G, q, k, v, lengths, out, lse, B, H, KV, Smax, st, scale, stream);
    case 256: return dispatch_g<T, 256>(G, q, k, v, lengths, out, lse, B, H, KV, Smax, st, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,hd] by strides (q_sb, q_sh); k, v [B,Smax,KV,hd] by strides
// (sb, ss, sh); out [B,H,hd] by strides (o_sb, o_sh); lse [B,H] fp32 or
// NULL.  The last dim of every tensor is contiguous.  strides[10] =
// {q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh}, in elements.
// Returns the cudaError_t of the launch.
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const int* lengths,
                                      void* out, float* lse, int dtype, int B,
                                      int H, int KV, int Smax, int hd,
                                      const long long* strides, float scale,
                                      void* stream) {
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == repro::DTYPE_BF16)
    err = dispatch_hd<__nv_bfloat16>(hd, G, q, k, v, lengths, out, lse, B, H,
                                     KV, Smax, strides, scale, s);
  else if (dtype == repro::DTYPE_F32)
    err = dispatch_hd<float>(hd, G, q, k, v, lengths, out, lse, B, H, KV,
                             Smax, strides, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
