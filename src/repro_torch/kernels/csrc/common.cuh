// Helpers shared by the attention kernels: fp32 views of bf16 / fp32 rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr float NEG_INF = -1e30f;

// dtype codes passed from Python (see the ops.py wrappers)
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even, as a cast in PyTorch
}

// Load N contiguous elements into fp32 registers with 16-byte loads.
// The pointer must be 16-byte aligned (the wrappers check base pointers
// and strides).
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&out)[N]) {
  static_assert(N % 4 == 0, "fp32 rows load in groups of 4");
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    float4 u = reinterpret_cast<const float4*>(p)[i];
    out[4 * i + 0] = u.x;
    out[4 * i + 1] = u.y;
    out[4 * i + 2] = u.z;
    out[4 * i + 3] = u.w;
  }
}

template <int N>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&out)[N]) {
  static_assert(N % 8 == 0, "bf16 rows load in groups of 8");
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    uint4 u = reinterpret_cast<const uint4*>(p)[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 f = __bfloat1622float2(h[j]);
      out[8 * i + 2 * j] = f.x;
      out[8 * i + 2 * j + 1] = f.y;
    }
  }
}

}  // namespace repro
