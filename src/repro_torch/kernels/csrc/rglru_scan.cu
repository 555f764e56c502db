// RG-LRU scan for Hopper: the diagonal linear recurrence
//   h_t = a_t * h_{t-1} + b_t
// over the time axis of a, b [B,S,W], from h0 [B,W], with an fp32 state.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/rglru_scan/kernel.py::rglru_scan_kernel (body
// _rglru_kernel): same outputs (hs [B,S,W] fp32, the state after every
// step, and hT [B,W] fp32, the state after the last).  Padding is the
// caller's: a pad step with a = 1 and b = 0 leaves the state as it was.
//
// What bounds it: bytes.  Each element of a and b is read once and each
// step's state written once, for 2 flops: far below the ~20 flop/byte at
// which even the fp32 units would be the limit.  The design therefore
// reads a and b once, in rows: one thread per (batch row, channel), the
// threads of a warp on neighbouring channels, so every load and store of
// a time step is one coalesced row.  The time loop is the only sequential
// part; each thread loads U steps of a and b ahead of using them so that
// the loads of a chunk are in flight together.  The update is a multiply
// and an add rounded separately (no fused multiply-add), as the plain
// version computes it, so the kernel gives its bits exactly, and the same
// bits on every launch.
//
// Types: a, b are bf16 or fp32 (one type); h0 and the outputs are fp32.
//
// Later work (not here): fuse the coefficient computation (_rglru_coeffs:
// gates, log-decay, sqrt multiplier) and the causal conv into this kernel,
// so a and b never reach device memory.
#include "common.cuh"

namespace {

constexpr int NT = 256;   // channels per block
constexpr int U = 8;      // time steps loaded ahead

template <typename T>
__global__ void __launch_bounds__(NT) rglru_scan_kernel(
    const T* __restrict__ a, const T* __restrict__ b,
    const float* __restrict__ h0, float* __restrict__ hs,
    float* __restrict__ hT, int S, int W) {
  const int c = blockIdx.x * NT + threadIdx.x;
  const int row = blockIdx.y;
  if (c >= W) return;
  const long long base = (long long)row * S * W + c;
  float h = h0[(long long)row * W + c];
  for (int t0 = 0; t0 < S; t0 += U) {
    float av[U], bv[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      av[i] = 1.f;
      bv[i] = 0.f;
      if (t0 + i < S) {
        const long long off = base + (long long)(t0 + i) * W;
        av[i] = repro::to_f32(a[off]);
        bv[i] = repro::to_f32(b[off]);
      }
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (t0 + i < S) {
        h = __fadd_rn(__fmul_rn(av[i], h), bv[i]);
        hs[base + (long long)(t0 + i) * W] = h;
      }
    }
  }
  hT[(long long)row * W + c] = h;
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const float* h0, float* hs,
                   float* hT, int B, int S, int W, cudaStream_t stream) {
  dim3 grid((W + NT - 1) / NT, B);
  rglru_scan_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0, hs, hT, S, W);
  return cudaGetLastError();
}

}  // namespace

// a, b [B,S,W] contiguous of `dtype`; h0 [B,W], hs [B,S,W] and hT [B,W]
// contiguous fp32.  Returns the cudaError_t of the launch.
extern "C" int repro_rglru_scan(const void* a, const void* b,
                                const float* h0, float* hs, float* hT,
                                int dtype, int B, int S, int W,
                                void* stream) {
  if (B <= 0 || W <= 0 || S < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DTYPE_BF16)
    return (int)launch<__nv_bfloat16>(a, b, h0, hs, hT, B, S, W, s);
  if (dtype == repro::DTYPE_F32)
    return (int)launch<float>(a, b, h0, hs, hT, B, S, W, s);
  return (int)cudaErrorInvalidValue;
}
