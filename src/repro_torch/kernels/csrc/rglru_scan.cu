// RG-LRU scan for Hopper: the diagonal linear recurrence
//   h_t = a_t * h_{t-1} + b_t
// over the time axis of a, b [B,S,W], from h0 [B,W], with an fp32 state,
// and its gradient, the same recurrence run backwards in time.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/rglru_scan/kernel.py::rglru_scan_kernel (body
// _rglru_kernel): same outputs (hs [B,S,W] fp32, the state after every
// step, and hT [B,W] fp32, the state after the last).  Padding is the
// caller's: a pad step with a = 1 and b = 0 leaves the state as it was.
// The JAX package differentiates lax.scan; the reverse entry point gives
// the bits of autograd of the plain version (kernels/rglru_scan/ref.py).
//
// What bounds it: bytes.  Each element of a and b is read once and each
// step's state written once, for 2 flops: far below the ~20 flop/byte at
// which even the fp32 units would be the limit.  At 3.35 TB/s the card
// needs ~3.4 MB in flight (~26 KB an SM over ~1 us of DRAM latency), and
// every SM has to take part.
//
// Design.  The update is a multiply and an add rounded apart (no fused
// multiply-add), in time order, as the plain version computes it; a
// chunked or parallel-prefix scan would round differently, so the time
// axis is never split and the parallelism comes from channels alone:
// * grid: one block of one warp per (32 channels, batch row), one lane a
//   channel, so B = 1, W = 4096 gives 128 blocks (one an SM), not the 16
//   of a 256-channel block;
// * a ring of NST time tiles in shared memory (TS steps x 32 channels of
//   each input), filled with 16-byte cp.async copies NST - 1 tiles ahead
//   of the tile being read: with TS = 64 (B = 1) that is 48 KB in flight
//   an SM in fp32.  The host picks TS from the blocks each SM holds
//   (bigger grids, smaller tiles), so the ring fits beside its neighbours;
// * the lane walks its column of the tile (conflict-free: a step's row is
//   32 consecutive words) and writes each step's state as one coalesced
//   128-byte row.  The dependent chain is a multiply and an add a step,
//   ~8 cycles, so 2,560 steps take ~12 us, under the byte bound.
// Rows that 16-byte copies cannot read (W * size not a multiple of 16, or
// an unaligned base) are copied element by element by their own lane.
//
// Backward (repro_rglru_scan_bwd): with g_t the gradient of h_t,
//   g_{S-1} = d_hT + d_hs_{S-1},  g_t = a_{t+1} * g_{t+1} + d_hs_t,
//   db_t = g_t,  da_t = g_t * h_{t-1} (h_{-1} = h0),  dh0 = a_0 * g_0,
// each a product and a sum of two terms rounded apart, as autograd of the
// plain version computes them, so the bits are autograd's.  The ring
// carries a, hs and d_hs tiles in reverse time order; da_{t+1} is written
// at step t (from g_{t+1} and hs_t), so no tile is read shifted.  da, db
// and dh0 are each skipped where their pointer is null (hs is then not
// read either); da and db are rounded to a's type as a cast in PyTorch.
//
// Types: a, b are bf16 or fp32 (one type); h0, hs, d_hs, d_hT and dh0 are
// fp32.
//
// Later work (not here): fuse the coefficient computation (_rglru_coeffs:
// gates, log-decay, sqrt multiplier) and the causal conv into this kernel,
// so a and b never reach device memory.
#include <algorithm>
#include <initializer_list>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int CH = 32;   // channels per block: one warp, one lane each
constexpr int NST = 4;   // tiles in the ring
// shared memory the host lets the ring of each SM's blocks take
constexpr int RING_BUDGET = 160 * 1024;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   repro::smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, n) of channels [0, nc) of an array with row stride W, from
// `src` (its row t0, channel c0), into a [TS][CH] tile.  `wide`: 16-byte
// copies, zero-filled past n and nc (W * sizeof(T) and the base are
// 16-byte multiples, so a copy is wholly inside or outside); else each
// lane copies its own channel with plain loads.
template <int TS, typename T>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, int n, int nc,
                                          int W, bool wide) {
  const int lane = threadIdx.x;
  if (wide) {
    constexpr int EPC = 16 / sizeof(T);    // elements a copy
    constexpr int CPR = CH / EPC;          // copies a row
    static_assert(TS * CPR % CH == 0, "a tile's copies split over the warp");
#pragma unroll
    for (int j = 0; j < TS * CPR / CH; ++j) {
      const int k = j * CH + lane;
      const int r = k / CPR, e = (k % CPR) * EPC;
      const bool ok = r < n && e < nc;
      cp_async16(dst + r * CH + e, ok ? src + (long long)r * W + e : src, ok);
    }
  } else if (lane < nc) {
    for (int r = 0; r < n; ++r)
      dst[r * CH + lane] = src[(long long)r * W + lane];
  }
}

template <typename T, int TS>
__global__ void __launch_bounds__(CH) rglru_fwd_kernel(
    const T* __restrict__ a, const T* __restrict__ b,
    const float* __restrict__ h0, float* __restrict__ hs,
    float* __restrict__ hT, int S, int W, bool wide) {
  constexpr int TILE = TS * CH;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);   // tile k: a, then b, in slot k % NST
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * CH;
  const int nc = min(CH, W - c0);
  const bool on = lane < nc;
  const long long base = (long long)blockIdx.y * S * W + c0;
  const int tiles = (S + TS - 1) / TS;

  auto issue = [&](int k) {
    if (k < tiles) {
      T* st = ring + (k % NST) * 2 * TILE;
      const long long off = base + (long long)k * TS * W;
      const int n = min(TS, S - k * TS);
      copy_tile<TS>(st, a + off, n, nc, W, wide);
      copy_tile<TS>(st + TILE, b + off, n, nc, W, wide);
    }
    cp_commit();   // an empty group past the end keeps the count
  };
#pragma unroll
  for (int k = 0; k < NST - 1; ++k) issue(k);

  const long long hrow = (long long)blockIdx.y * W + c0 + lane;
  float h = on ? h0[hrow] : 0.f;
  for (int k = 0; k < tiles; ++k) {
    __syncwarp();            // every lane is done with tile k - 1's slot
    issue(k + NST - 1);
    cp_wait<NST - 1>();      // tile k has landed (this lane's copies) ...
    __syncwarp();            // ... and every lane's
    if (!on) continue;
    const T* ta = ring + (k % NST) * 2 * TILE + lane;
    const T* tb = ta + TILE;
    float* out = hs + base + (long long)k * TS * W + lane;
    const int n = min(TS, S - k * TS);
    if (n == TS) {
#pragma unroll
      for (int i = 0; i < TS; ++i) {
        h = __fadd_rn(__fmul_rn(repro::to_f32(ta[i * CH]), h),
                      repro::to_f32(tb[i * CH]));
        out[(long long)i * W] = h;
      }
    } else {
      for (int i = 0; i < n; ++i) {
        h = __fadd_rn(__fmul_rn(repro::to_f32(ta[i * CH]), h),
                      repro::to_f32(tb[i * CH]));
        out[(long long)i * W] = h;
      }
    }
  }
  if (on) hT[hrow] = h;
}

// One step of the reverse recurrence at time t = t0 + i (see the note at
// the top): da_{t+1} from g_{t+1} and h_t (not at t = S - 1), then g_t,
// db_t.  `g` holds g_{t+1} on entry and g_t on exit; `an` a_{t+1}, then a_t.
template <typename T>
__device__ __forceinline__ void reverse_step(float& g, float& an, float at,
                                             float ht, float dht, T* da_next,
                                             T* db_t, bool write_da) {
  if (write_da) *da_next = repro::from_f32<T>(__fmul_rn(g, ht));
  g = __fadd_rn(__fmul_rn(an, g), dht);
  if (db_t) *db_t = repro::from_f32<T>(g);
  an = at;
}

template <typename T, int TS>
__global__ void __launch_bounds__(CH) rglru_bwd_kernel(
    const T* __restrict__ a, const float* __restrict__ hs,
    const float* __restrict__ h0, const float* __restrict__ d_hs,
    const float* __restrict__ d_hT, T* __restrict__ da, T* __restrict__ db,
    float* __restrict__ dh0, int S, int W, bool wide) {
  constexpr int TILE = TS * CH;
  constexpr int STAGE = TILE * (sizeof(T) + 2 * sizeof(float));
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * CH;
  const int nc = min(CH, W - c0);
  const bool on = lane < nc;
  const bool want_da = da != nullptr;
  const long long base = (long long)blockIdx.y * S * W + c0;
  const int tiles = (S + TS - 1) / TS;
  // slot s: a [TILE] of T, hs [TILE] fp32, d_hs [TILE] fp32
  auto slot_a = [&](int s) { return reinterpret_cast<T*>(smem + s * STAGE); };
  auto slot_h = [&](int s) {
    return reinterpret_cast<float*>(smem + s * STAGE + TILE * sizeof(T));
  };

  // the k-th tile issued and read is tile tiles - 1 - k: time runs back
  auto issue = [&](int k) {
    if (k < tiles) {
      const int j = tiles - 1 - k, s = k % NST;
      const long long off = base + (long long)j * TS * W;
      const int n = min(TS, S - j * TS);
      copy_tile<TS>(slot_a(s), a + off, n, nc, W, wide);
      if (want_da) copy_tile<TS>(slot_h(s), hs + off, n, nc, W, wide);
      copy_tile<TS>(slot_h(s) + TILE, d_hs + off, n, nc, W, wide);
    }
    cp_commit();
  };
#pragma unroll
  for (int k = 0; k < NST - 1; ++k) issue(k);

  const long long hrow = (long long)blockIdx.y * W + c0 + lane;
  float g = on ? d_hT[hrow] : 0.f;   // g_S: d_hT, with a_S = 1
  float an = 1.f;
  for (int k = 0; k < tiles; ++k) {
    __syncwarp();
    issue(k + NST - 1);
    cp_wait<NST - 1>();
    __syncwarp();
    if (!on) continue;
    const int s = k % NST, j = tiles - 1 - k, t0 = j * TS;
    const int n = min(TS, S - t0);
    const T* ta = slot_a(s) + lane;
    const float* th = slot_h(s) + lane;
    const float* td = th + TILE;
    const long long off = base + (long long)t0 * W + lane;
    T* da_t = want_da ? da + off : nullptr;   // da at t0 + i + 1: da_t[(i+1)W]
    T* db_t = db ? db + off : nullptr;
    // no da_{t+1} at t = S - 1: only the first tile read holds that step
    const int top = k == 0 ? n - 1 : n;
    if (n == TS && k > 0) {
#pragma unroll
      for (int i = TS - 1; i >= 0; --i)
        reverse_step(g, an, repro::to_f32(ta[i * CH]), th[i * CH], td[i * CH],
                     want_da ? da_t + (long long)(i + 1) * W : nullptr,
                     db_t ? db_t + (long long)i * W : nullptr, want_da);
    } else {
      for (int i = n - 1; i >= 0; --i)
        reverse_step(g, an, repro::to_f32(ta[i * CH]),
                     want_da ? th[i * CH] : 0.f, td[i * CH],
                     want_da ? da_t + (long long)(i + 1) * W : nullptr,
                     db_t ? db_t + (long long)i * W : nullptr,
                     want_da && i < top);
    }
  }
  if (on) {
    // g = g_0 and an = a_0 here (S > 0); S == 0 leaves g = d_hT
    if (want_da && S > 0)
      da[base + lane] = repro::from_f32<T>(__fmul_rn(g, h0[hrow]));
    if (dh0) dh0[hrow] = S > 0 ? __fmul_rn(an, g) : g;
  }
}

// Time steps a tile: the largest of 64, 32 and 16 whose ring fits the
// SM's RING_BUDGET beside the other blocks each SM holds when the grid
// is spread evenly; `step_bytes` is one step of every tile in a slot.
int pick_steps(int blocks, int step_bytes, int sms) {
  const int per_sm = std::min(16, (blocks + sms - 1) / sms);
  for (int ts : {64, 32})
    if (per_sm * NST * ts * step_bytes <= RING_BUDGET) return ts;
  return 16;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int TS>
cudaError_t fwd(const void* a, const void* b, const float* h0, float* hs,
                float* hT, int B, int S, int W, bool wide, cudaStream_t s) {
  auto kern = rglru_fwd_kernel<T, TS>;
  const int smem = NST * 2 * TS * CH * sizeof(T);
  cudaError_t err = repro::allow_smem((const void*)kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((W + CH - 1) / CH, B), CH, smem, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0, hs, hT, S, W,
      wide);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_any(const void* a, const void* b, const float* h0, float* hs,
                    float* hT, int B, int S, int W, cudaStream_t s) {
  int sms = 0;
  cudaError_t err = repro::sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int blocks = B * ((W + CH - 1) / CH);
  const bool wide = (long long)W * sizeof(T) % 16 == 0 && aligned16(a) &&
                    aligned16(b);
  switch (pick_steps(blocks, 2 * CH * sizeof(T), sms)) {
    case 64: return fwd<T, 64>(a, b, h0, hs, hT, B, S, W, wide, s);
    case 32: return fwd<T, 32>(a, b, h0, hs, hT, B, S, W, wide, s);
    default: return fwd<T, 16>(a, b, h0, hs, hT, B, S, W, wide, s);
  }
}

template <typename T, int TS>
cudaError_t bwd(const void* a, const float* hs, const float* h0,
                const float* d_hs, const float* d_hT, void* da, void* db,
                float* dh0, int B, int S, int W, bool wide, cudaStream_t s) {
  auto kern = rglru_bwd_kernel<T, TS>;
  const int smem = NST * TS * CH * (sizeof(T) + 2 * sizeof(float));
  cudaError_t err = repro::allow_smem((const void*)kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((W + CH - 1) / CH, B), CH, smem, s>>>(
      static_cast<const T*>(a), hs, h0, d_hs, d_hT, static_cast<T*>(da),
      static_cast<T*>(db), dh0, S, W, wide);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_any(const void* a, const float* hs, const float* h0,
                    const float* d_hs, const float* d_hT, void* da, void* db,
                    float* dh0, int B, int S, int W, cudaStream_t s) {
  int sms = 0;
  cudaError_t err = repro::sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int blocks = B * ((W + CH - 1) / CH);
  const bool wide = W % (16 / sizeof(T)) == 0 && W % 4 == 0 &&
                    aligned16(a) && aligned16(d_hs) &&
                    (da == nullptr || aligned16(hs));
  switch (pick_steps(blocks, CH * (sizeof(T) + 2 * sizeof(float)), sms)) {
    case 64:
      return bwd<T, 64>(a, hs, h0, d_hs, d_hT, da, db, dh0, B, S, W, wide, s);
    case 32:
      return bwd<T, 32>(a, hs, h0, d_hs, d_hT, da, db, dh0, B, S, W, wide, s);
    default:
      return bwd<T, 16>(a, hs, h0, d_hs, d_hT, da, db, dh0, B, S, W, wide, s);
  }
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
    return (int)fwd_any<__nv_bfloat16>(a, b, h0, hs, hT, B, S, W, s);
  if (dtype == repro::DTYPE_F32)
    return (int)fwd_any<float>(a, b, h0, hs, hT, B, S, W, s);
  return (int)cudaErrorInvalidValue;
}

// The reverse scan: a [B,S,W] contiguous of `dtype`; hs, d_hs [B,S,W] and
// h0, d_hT [B,W] contiguous fp32.  Writes da, db [B,S,W] of `dtype` and
// dh0 [B,W] fp32, each skipped where its pointer is null (hs may then be
// null too when da is).  Returns the cudaError_t of the launch.
extern "C" int repro_rglru_scan_bwd(const void* a, const float* hs,
                                    const float* h0, const float* d_hs,
                                    const float* d_hT, void* da, void* db,
                                    float* dh0, int dtype, int B, int S,
                                    int W, void* stream) {
  if (B <= 0 || W <= 0 || S < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DTYPE_BF16)
    return (int)bwd_any<__nv_bfloat16>(a, hs, h0, d_hs, d_hT, da, db, dh0, B,
                                       S, W, s);
  if (dtype == repro::DTYPE_F32)
    return (int)bwd_any<float>(a, hs, h0, d_hs, d_hT, da, db, dh0, B, S, W,
                               s);
  return (int)cudaErrorInvalidValue;
}
