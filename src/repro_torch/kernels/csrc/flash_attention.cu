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
// operations.  At hd = 256 (recurrentgemma's local attention: 16 q heads
// on one kv head, window 2048) the same holds: at S = 384 about 120 flops
// per byte.  Both designs keep the [Sq, Skv] scores out of device memory
// (one online softmax per q row), never load a kv tile outside the causal
// / window band, and read q, k, v and write the output in the model's
// [B, S, heads, hd] layout through strides (no transpose passes).  At
// these short sequences a unit of work is a few kv tiles, so what costs
// is latency: a block's start, its first loads, and the chain S -> softmax
// -> P V of each tile.  The bf16 design answers with persistent blocks
// whose producer loads the next unit while the consumers finish this
// one, and with one K/V load per GQA group instead of one per q head (G
// = 4 for proxy-8b, 16 for recurrentgemma).  Head dims 64, 128, 160 and
// 256; 160 (stablelm-12b) is computed at 192 in shared memory (see
// FlashShape).
//
// Two variants:
//   bf16 (the served model): warp-specialized, TMA-fed, wgmma; see
//     flash_attention_wgmma_kernel.  TMA needs 16-byte strides and a
//     16-byte aligned base, and a unit holds at most BM q heads a kv head;
//     the entry point returns ERR_UNSUPPORTED otherwise.
//   fp32 (tests and references): fp32 FMAs from shared-memory tiles, exact
//     to fp32 rounding.  One block of 128 threads per (32-row q tile, q
//     head, batch row); thread t owns q row t / 4, score columns
//     t % 4 + 4 i and output dims t % 4 + 4 i.
// In both, a row's softmax statistics live in the 4 lanes of one quad and
// combine by 2-step shuffles in a fixed order (no atomics: results repeat
// bit for bit).
//
// The chunked-prefill entry (repro_flash_attention_chunked) replaces no TPU
// kernel: the JAX package runs a decode step with T > 1 new tokens a row
// as dense masked einsums (models/attention.py::decode_attention after
// _qkv's norm and RoPE and write_kv's scatter).  It runs that step of the
// continuous batcher in two launches.  chunk_prologue_kernel applies the
// per-head RMSNorm (qk-norm) and the half-split RoPE to the new q and k,
// rounding to the tensor's type after each as the plain path does, writes
// q to a [B, T, H, hd] scratch, and writes the new k and v into the dense
// cache view at their positions lengths[b] - T + t, dropping positions
// outside [0, Smax) (no boolean index, no host sync).  The attention
// kernels above then take per-row query offsets: query t of row b sits at
// lengths[b] - T + t and sees keys 0 .. that position; a unit whose rows
// see no key loads nothing and writes zeros.  What bounds it: the keys
// and values read once per q tile (2 q tiles a (row, kv head) at G = 8, T
// = 32), the bytes of the valid cache prefix; the prologue moves q, k, v
// twice, a few MB a layer.
#include <string.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"


namespace {

using namespace repro;

// the chunked entry's 15 strides, passed to its prologue by value
struct StridesChunk {
  long long v[15];
};

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
    float scale, const int* __restrict__ lengths) {
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
  // q row i sits at kv position i + q_off: per row where lengths is given
  const int q_off = lengths != nullptr ? lengths[b] - Sq : Skv - Sq;

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
// bf16: work units of (q tile, kv head, batch row).  A unit's rows are
// (q position, q head of the group) pairs, head fastest: row r is
// position q0 + r / G of head kv * G + r % G, so one K/V tile feeds all G
// heads.  A unit holds floor(BM / G) positions, G * floor(BM / G) rows;
// where G does not divide BM, the last rows of the Q tile are left as
// they are and their outputs are not written (a row of a wgmma product
// depends on its own row of A only).  The kernel is persistent: one
// block per SM walks units gridDim.x apart, the widest causal bands
// first.  Its last warp is the producer: one thread loads each unit's Q
// tile and keeps a ring of STAGES K/V tiles full with TMA, running ahead
// across units; each stage has a "full" mbarrier (the copies' bytes
// landed) and an "empty" one (the consumers are done with it), and the Q
// tile has the same pair.
// Warpgroups 0 and 1 each own 64 rows of a unit: S = Q K^T by wgmma
// m64n64k16 with Q and K from shared memory, the online softmax on the S
// registers, then O += P V by wgmma m64nHDk16 with P from registers and V
// from shared memory.  Every tile lands with 128-byte swizzle, in
// 64-column chunks of 128-byte rows, the layout wgmma's descriptors read.
// --------------------------------------------------------------------------

constexpr int WG = 128;          // threads of a warpgroup
// returned (not a cudaError_t) for inputs the bf16 kernel cannot take
constexpr int ERR_UNSUPPORTED = -1;
constexpr int BKV = 64;          // keys of a K/V tile
constexpr int CHUNK = 64;        // columns of a swizzled 128-byte row

// A head dim that is not a multiple of CHUNK (160: 2.5 chunks) is laid
// out in shared memory as HDP = the next multiple (192): the tensor maps
// keep the true HD, so TMA fills the columns past it with zeros.  S = Q K^T
// runs its k-steps over the true HD only; O += P V runs over HDP (the
// zero columns of V give zero columns of O, never stored), since wgmma
// reads the 128-byte-swizzled V tile in whole 64-column chunks.  That costs
// 20 % more P V work at HD = 160 and keeps every operand in the layout the
// other head dims use.
//
// NC consumer warpgroups of 64 rows each and one producer warp: two at
// HD <= 128; one at HD = 160 and 256, whose O accumulators alone take 96
// and 128 registers a thread.  A block of one warpgroup and a warp (160
// threads) may use 255 registers a thread; with two (288 threads, which
// the card allocates as 384) only 168, and those consumers would spill.
template <int HD>
struct FlashShape {
  static constexpr int HDP = (HD + CHUNK - 1) / CHUNK * CHUNK;
  static constexpr int NC = HD > 128 ? 1 : 2;
  static constexpr int BM = 64 * NC;                 // rows of a unit
  static constexpr int THREADS = NC * WG + 32;
  static constexpr int CHUNKS = HDP / CHUNK;
  static constexpr int STAGES = HD == 256 ? 2 : (HD == 64 ? 4 : 3);
  static constexpr int Q_BYTES = BM * HDP * 2;
  static constexpr int KV_BYTES = BKV * HDP * 2;      // K or V of a tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_BYTES = 8 * (2 * STAGES + 2);
  // + 1024: the dynamic base is aligned up to the swizzle atom
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES +
                              BAR_BYTES;
};

// d[32] (+)= A (shared, K-major) * B (shared, K-major), m64n64k16
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[32] += A (registers) * B (shared, MN-major), m64n64k16
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64] += A (registers) * B (shared, MN-major), m64n128k16
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[128] += A (registers) * B (shared, MN-major), m64n256k16
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127},"
      " {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x HDP] += P V for one 16-key slab of V whose chunk 0 starts at
// ``v``: 64-column chunks BKV * 128 bytes apart, 8-key groups 1024 apart
template <int HDP>
__device__ __forceinline__ void wgmma_pv(float (&o)[HDP / 2],
                                         const uint32_t (&a)[4],
                                         uint32_t v) {
  const uint64_t db = sw128_desc(v, BKV * 128, 1024);
  if constexpr (HDP == 64) wgmma_rs_n64(o, a, db);
  if constexpr (HDP == 128) wgmma_rs_n128(o, a, db);
  if constexpr (HDP == 192) {     // chunks 0-1, then chunk 2
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&o[0]), a, db);
    wgmma_rs_n64(*reinterpret_cast<float(*)[32]>(&o[64]), a,
                 sw128_desc(v + 2 * BKV * 128, BKV * 128, 1024));
  }
  if constexpr (HDP == 256) wgmma_rs_n256(o, a, db);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // .x (lo) in bits 0-15
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int HD>
__global__ void __launch_bounds__(FlashShape<HD>::THREADS, 1)
    flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map,
    const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map,
    __nv_bfloat16* __restrict__ out, int B, int KV, int G, int Sq, int Skv,
    long long o_sb, long long o_ss, long long o_sh, int causal, int window,
    float scale, const int* __restrict__ lengths) {
  using F = FlashShape<HD>;
  constexpr int HDP = F::HDP;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base;                              // Q: CHUNKS x 16 KB
  const uint32_t skv = base + F::Q_BYTES;                // stage s: K then V
  const uint32_t bars = skv + F::STAGES * F::STAGE_BYTES;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto full_bar = [&](int s) { return bars + 8 * (2 + s); };
  auto empty_bar = [&](int s) { return bars + 8 * (2 + F::STAGES + s); };

  constexpr int BM = F::BM;
  const int tp = BM / G;                 // q positions of a unit
  const int rows = tp * G;               // its rows: G <= BM
  const int n_qt = (Sq + tp - 1) / tp;
  const int units = n_qt * KV * B;
  // unit u: q tile n_qt - 1 - u / (KV B) (the widest causal bands first),
  // kv head u % KV, batch row (u / KV) % B; q position i of its row sits
  // at kv position i + q_off (per row where lengths is given); the kv
  // tiles its band sees, none where no row of it sees a key
  struct Unit {
    int q0, kvh, b, q_off, k_begin, n_tiles;
  };
  auto unit = [&](int u) {
    Unit w;
    w.q0 = (n_qt - 1 - u / (KV * B)) * tp;
    w.kvh = u % KV;
    w.b = (u / KV) % B;
    w.q_off = lengths != nullptr ? lengths[w.b] - Sq : Skv - Sq;
    const int qpos_lo = w.q0 + w.q_off;
    const int qpos_hi = min(w.q0 + tp, Sq) - 1 + w.q_off;
    int k_end = Skv;
    if (causal) k_end = min(k_end, qpos_hi + 1);
    int k_begin = 0;
    if (window > 0) k_begin = max(0, qpos_lo - window + 1);
    w.k_begin = (k_begin / BKV) * BKV;
    w.n_tiles = k_end > w.k_begin ? (k_end - w.k_begin + BKV - 1) / BKV : 0;
    return w;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, F::NC * WG);
    for (int s = 0; s < F::STAGES; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), F::NC * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= F::NC * WG) {
    // ---- producer: one thread issues every copy ----
    if (threadIdx.x != F::NC * WG) return;
    prefetch_map(&q_map);
    prefetch_map(&k_map);
    prefetch_map(&v_map);
    int it = 0, q_round = 0;   // q_round: units loaded so far
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit w = unit(u);
      if (w.n_tiles == 0) continue;            // sees no key: loads nothing
      // the consumers' last S of the previous unit has read Q
      if (q_round > 0) mbar_wait(q_empty, (q_round - 1) & 1);
      ++q_round;
      mbar_expect_tx(q_full, rows * HDP * 2);   // TMA counts the fill too
      for (int c = 0; c < F::CHUNKS; ++c)
        tma_load_4d(sq + c * BM * 128, &q_map, q_full, c * CHUNK,
                    w.kvh * G, w.q0, w.b);
      for (int i = 0; i < w.n_tiles; ++i, ++it) {
        const int s = it % F::STAGES, round = it / F::STAGES;
        if (round > 0) mbar_wait(empty_bar(s), (round - 1) & 1);
        const uint32_t k_dst = skv + s * F::STAGE_BYTES;
        const uint32_t v_dst = k_dst + F::KV_BYTES;
        const int kt = w.k_begin + i * BKV;
        mbar_expect_tx(full_bar(s), F::STAGE_BYTES);
        for (int c = 0; c < F::CHUNKS; ++c) {
          tma_load_4d(k_dst + c * BKV * 128, &k_map, full_bar(s), c * CHUNK,
                      w.kvh, kt, w.b);
          tma_load_4d(v_dst + c * BKV * 128, &v_map, full_bar(s), c * CHUNK,
                      w.kvh, kt, w.b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 ----
  const int wg = threadIdx.x / WG;
  const int tw = threadIdx.x % WG, warp = tw / 32, lane = tw % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = wg * 64 + warp * 16 + g;      // rows r0 and r0 + 8
  int it = 0, q_round = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit w = unit(u);
    const int pos[2] = {w.q0 + r0 / G, w.q0 + (r0 + 8) / G};
    const int qp[2] = {pos[0] + w.q_off, pos[1] + w.q_off};
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float o[HDP / 2];
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
    // a unit with no key was not loaded: its rows write zeros
    if (w.n_tiles > 0) mbar_wait(q_full, q_round++ & 1);
    for (int i = 0; i < w.n_tiles; ++i, ++it) {
      const int s = it % F::STAGES;
      mbar_wait(full_bar(s), (it / F::STAGES) & 1);
      const uint32_t k_src = skv + s * F::STAGE_BYTES;
      const uint32_t v_src = k_src + F::KV_BYTES;
      const int kt = w.k_begin + i * BKV;

      // S = Q K^T: 16 columns (32 bytes) a step within each 64-column
      // chunk; 8-row groups 1024 bytes apart; the true HD columns only
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const uint32_t col = (ks % 4) * 32;
        const uint64_t da = sw128_desc(
            sq + (ks / 4) * BM * 128 + wg * 64 * 128 + col, 16, 1024);
        const uint64_t db =
            sw128_desc(k_src + (ks / 4) * BKV * 128 + col, 16, 1024);
        wgmma_ss_n64(sc, da, db, ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      if (i == w.n_tiles - 1) mbar_arrive(q_empty);   // done with Q

      // mask, then the online softmax of the thread's two rows (a row's
      // 64 scores lie in the 4 lanes of a quad)
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = kt + j * 8 + 2 * t + (e & 1);
          const int r = e >> 1;
          bool ok = kp < Skv;
          if (causal) ok = ok && kp <= qp[r];
          if (window > 0) ok = ok && kp > qp[r] - window;
          float& x = sc[4 * j + e];
          x = ok ? x * scale : NEG_INF;
          mx[r] = fmaxf(mx[r], x);
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
      for (int j = 0; j < 32; ++j) {
        const int r = (j >> 1) & 1;
        // masked scores hold NEG_INF exactly and contribute exactly 0
        const float p = sc[j] > 0.5f * NEG_INF ? expf(sc[j] - m[r]) : 0.f;
        sc[j] = p;
        sum[r] += p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * alpha[r] + sum[r];
      }
#pragma unroll
      for (int j = 0; j < HDP / 2; ++j) o[j] *= alpha[(j >> 1) & 1];

      // O += P V: P's accumulators of key blocks 2u, 2u+1 are the A
      // operand of step u; V (keys x HDP, HDP contiguous) is MN-major
      uint32_t pa[4][4];
#pragma unroll
      for (int u4 = 0; u4 < 4; ++u4) {
        pa[u4][0] = pack_f32(sc[8 * u4 + 0], sc[8 * u4 + 1]);
        pa[u4][1] = pack_f32(sc[8 * u4 + 2], sc[8 * u4 + 3]);
        pa[u4][2] = pack_f32(sc[8 * u4 + 4], sc[8 * u4 + 5]);
        pa[u4][3] = pack_f32(sc[8 * u4 + 6], sc[8 * u4 + 7]);
      }
      wgmma_fence();
#pragma unroll
      for (int u4 = 0; u4 < 4; ++u4)
        wgmma_pv<HDP>(o, pa[u4], v_src + u4 * 16 * 128);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      mbar_arrive(empty_bar(s));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= rows || pos[r] >= Sq) continue;
      const float lsafe = (l[r] == 0.f) ? 1.f : l[r];
      __nv_bfloat16* orow = out + w.b * o_sb + pos[r] * o_ss +
                            (w.kvh * G + row % G) * o_sh + 2 * t;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
            __floats2bfloat162_rn(o[4 * n + 2 * r] / lsafe,
                                  o[4 * n + 2 * r + 1] / lsafe);
    }
  }
}

// A bf16 [B, S, heads, HD] tensor read through its element strides (sb,
// ss, sh; the last dim contiguous) as boxes of (64 columns, box_h heads,
// box_s positions, 1 row), 128-byte swizzled; positions past S read as 0.
// Encoding a map costs the host about a microsecond, and the served
// shapes' launches are bound by the host, so the maps of the last
// MAP_CACHE tensors each thread launched on are kept and reused while
// pointer, shape, strides and box are unchanged.
constexpr int MAP_CACHE = 48;

struct MapKey {
  const void* ptr;
  long long v[9];
};

bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
              int hd, long long sb, long long ss, long long sh, int box_h,
              int box_s) {
  const MapKey key = {ptr, {B, S, heads, hd, sb, ss, sh, box_h, box_s}};
  static thread_local MapKey keys[MAP_CACHE];
  static thread_local CUtensorMap maps[MAP_CACHE];
  static thread_local int used = 0, next = 0;
  for (int i = 0; i < used; ++i)
    if (memcmp(&keys[i], &key, sizeof key) == 0) {
      *map = maps[i];
      return true;
    }
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {CHUNK, static_cast<cuuint32_t>(box_h),
                             static_cast<cuuint32_t>(box_s), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(ptr), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % MAP_CACHE;
  if (used < MAP_CACHE) ++used;
  return true;
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, int B, int H, int KV, int Sq, int Skv,
                        const long long* st, int causal, int window,
                        float scale, const int* lengths,
                        cudaStream_t stream) {
  const int G = H / KV;
  constexpr int BM = FlashShape<HD>::BM;
  if (G > BM) return static_cast<cudaError_t>(ERR_UNSUPPORTED);
  CUtensorMap q_map, k_map, v_map;
  if (!make_map(&q_map, q, B, Sq, H, HD, st[0], st[1], st[2], G, BM / G) ||
      !make_map(&k_map, k, B, Skv, KV, HD, st[3], st[4], st[5], 1, BKV) ||
      !make_map(&v_map, v, B, Skv, KV, HD, st[6], st[7], st[8], 1, BKV))
    return static_cast<cudaError_t>(ERR_UNSUPPORTED);
  constexpr int bytes = FlashShape<HD>::SMEM;
  auto kern = flash_attention_wgmma_kernel<HD>;
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kern), bytes);
  int sms = 0;
  if (err == cudaSuccess) err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int units = (Sq + BM / G - 1) / (BM / G) * KV * B;
  kern<<<min(units, sms), FlashShape<HD>::THREADS, bytes, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), B, KV, G, Sq,
      Skv, st[9], st[10], st[11], causal, window, scale, lengths);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int KV, int Sq, int Skv,
                   const long long* st, int causal, int window, float scale,
                   const int* lengths, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_bf16<HD>(q, k, v, out, B, H, KV, Sq, Skv, st, causal,
                           window, scale, lengths, stream);
  } else {
    constexpr int bytes = smem_floats<HD>() * (int)sizeof(float);
    auto kern = flash_attention_kernel<T, HD>;
    cudaError_t err = allow_smem(reinterpret_cast<const void*>(kern), bytes);
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + BQ - 1) / BQ, H, B);
    kern<<<grid, NT, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), H, KV, Sq, Skv,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
        st[10], st[11], causal, window, scale, lengths);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* out, int B, int H, int KV, int Sq, int Skv,
                        const long long* st, int causal, int window,
                        float scale, const int* lengths,
                        cudaStream_t stream) {
  switch (hd) {
    case 64: return launch<T, 64>(q, k, v, out, B, H, KV, Sq, Skv, st, causal, window, scale, lengths, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, H, KV, Sq, Skv, st, causal, window, scale, lengths, stream);
    case 160: return launch<T, 160>(q, k, v, out, B, H, KV, Sq, Skv, st, causal, window, scale, lengths, stream);
    case 256: return launch<T, 256>(q, k, v, out, B, H, KV, Sq, Skv, st, causal, window, scale, lengths, stream);
    default: return cudaErrorInvalidValue;
  }
}

// --------------------------------------------------------------------------
// The chunked-prefill prologue: one block of PRO_WARPS warps a (token t,
// row b); warp w takes heads w, w + PRO_WARPS, ... of the H q heads and
// the KV kv heads.  A lane holds the RoPE pairs (i, i + hd / 2) for i =
// lane, lane + 32, ...: the RMSNorm's sum of squares is a warp reduction,
// the rotation needs no exchange.  Every product and sum is rounded on its
// own (__fmul_rn, __fadd_rn: no fused multiply-add), in the plain path's
// order: x * rsqrt(mean(x^2) + eps) * scale, rounded to T; then x1 cos -
// x2 sin and x2 cos + x1 sin, rounded to T.  cos and sin [B, T, hd / 2]
// come from the host's fp32 tables (the plain path's own ops), so the
// rotation is the plain path's to the bit.
// --------------------------------------------------------------------------

constexpr int PRO_WARPS = 8;
constexpr int PRO_PAIRS = 4;      // RoPE pairs a lane: hd / 2 / 32, up to 4

template <typename T>
__device__ __forceinline__ void prologue_row(
    const T* __restrict__ src, T* __restrict__ dst, const T* __restrict__ nw,
    float eps, const float* __restrict__ cs, const float* __restrict__ sn,
    int hd, int lane) {
  const int half = hd / 2;
  float a[PRO_PAIRS], b[PRO_PAIRS];
#pragma unroll
  for (int j = 0; j < PRO_PAIRS; ++j) {
    const int i = lane + 32 * j;
    a[j] = i < half ? repro::to_f32(src[i]) : 0.f;
    b[j] = i < half ? repro::to_f32(src[i + half]) : 0.f;
  }
  if (nw != nullptr) {
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < PRO_PAIRS; ++j)
      ss = __fadd_rn(ss, __fadd_rn(__fmul_rn(a[j], a[j]),
                                   __fmul_rn(b[j], b[j])));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, o));
    const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, 1.f / hd), eps));
#pragma unroll
    for (int j = 0; j < PRO_PAIRS; ++j) {
      const int i = lane + 32 * j;
      if (i >= half) continue;
      a[j] = repro::to_f32(repro::from_f32<T>(
          __fmul_rn(__fmul_rn(a[j], r), repro::to_f32(nw[i]))));
      b[j] = repro::to_f32(repro::from_f32<T>(
          __fmul_rn(__fmul_rn(b[j], r), repro::to_f32(nw[i + half]))));
    }
  }
#pragma unroll
  for (int j = 0; j < PRO_PAIRS; ++j) {
    const int i = lane + 32 * j;
    if (i >= half) continue;
    float x = a[j], y = b[j];
    if (cs != nullptr) {
      const float c = cs[i], s = sn[i];
      x = __fsub_rn(__fmul_rn(a[j], c), __fmul_rn(b[j], s));
      y = __fadd_rn(__fmul_rn(b[j], c), __fmul_rn(a[j], s));
    }
    dst[i] = repro::from_f32<T>(x);
    dst[i + half] = repro::from_f32<T>(y);
  }
}

// st: q, k, v, cache_k, cache_v strides (sb, ss, sh) in elements, 15 in
// all; q_out is [B, T, H, hd] contiguous; cos / sin [B, T, hd / 2] fp32
// contiguous or null (no RoPE); q_w / k_w the norms' scales [hd] or null
template <typename T>
__global__ void __launch_bounds__(PRO_WARPS * 32) chunk_prologue_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ q_w,
    const T* __restrict__ k_w, float eps, const float* __restrict__ cos_t,
    const float* __restrict__ sin_t, const int* __restrict__ lengths,
    T* __restrict__ q_out, T* __restrict__ ck, T* __restrict__ cv, int T_,
    int H, int KV, int Smax, int hd, const StridesChunk st) {
  const int t = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(b) * T_ + t;
  const float* cs = cos_t != nullptr ? cos_t + row * (hd / 2) : nullptr;
  const float* sn = sin_t != nullptr ? sin_t + row * (hd / 2) : nullptr;
  const int pos = lengths[b] - T_ + t;       // where the new k, v go
  const bool keep = pos >= 0 && pos < Smax;
  for (int h = warp; h < H + KV; h += PRO_WARPS) {
    if (h < H) {
      prologue_row(q + b * st.v[0] + t * st.v[1] + h * st.v[2],
                   q_out + (row * H + h) * hd, q_w, eps, cs, sn, hd, lane);
      continue;
    }
    if (!keep) continue;
    const int c = h - H;
    prologue_row(k + b * st.v[3] + t * st.v[4] + c * st.v[5],
                 ck + b * st.v[9] + pos * st.v[10] + c * st.v[11], k_w, eps,
                 cs, sn, hd, lane);
    const T* vs = v + b * st.v[6] + t * st.v[7] + c * st.v[8];
    T* vd = cv + b * st.v[12] + pos * st.v[13] + c * st.v[14];
    for (int i = lane; i < hd; i += 32) vd[i] = vs[i];
  }
}

template <typename T>
cudaError_t launch_chunked(const void* q, const void* k, const void* v,
                           const void* q_w, const void* k_w, float eps,
                           const float* cos_t, const float* sin_t,
                           const int* lengths, void* q_out, void* ck,
                           void* cv, void* out, int B, int T_, int H, int KV,
                           int Smax, int hd, const StridesChunk& st,
                           float scale, cudaStream_t stream) {
  chunk_prologue_kernel<T><<<dim3(T_, B), PRO_WARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(q_w),
      static_cast<const T*>(k_w), eps, cos_t, sin_t, lengths,
      static_cast<T*>(q_out), static_cast<T*>(ck), static_cast<T*>(cv), T_,
      H, KV, Smax, hd, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long q_ss = static_cast<long long>(H) * hd;
  const long long att[12] = {T_ * q_ss, q_ss, hd,              // q_out
                             st.v[9], st.v[10], st.v[11],      // cache k
                             st.v[12], st.v[13], st.v[14],     // cache v
                             T_ * q_ss, q_ss, hd};             // out
  return dispatch_hd<T>(hd, q_out, ck, cv, out, B, H, KV, T_, Smax, att, 1,
                        0, scale, lengths, stream);
}

}  // namespace

// q [B,Sq,H,hd], k and v [B,Skv,KV,hd], out [B,Sq,H,hd], each by strides
// (sb, ss, sh) in elements with a contiguous last dim: strides[12] =
// {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh}.
// Returns the cudaError_t of the launch, or ERR_UNSUPPORTED (-1) where
// the bf16 kernel cannot take the input: more q heads a kv head than a
// unit has rows (BM: 128, 64 at hd 160 and 256), or a tensor TMA cannot read
// (strides not 16-byte multiples, a base not 16-byte aligned).
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
                                     strides, causal, window, scale, nullptr,
                                     s);
  else if (dtype == repro::DTYPE_F32)
    err = dispatch_hd<float>(hd, q, k, v, out, B, H, KV, Sq, Skv, strides,
                             causal, window, scale, nullptr, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// The chunked-prefill step of one layer: q [B,T,H,hd], k and v [B,T,KV,hd]
// (the projections, before norm and RoPE), the dense cache view cache_k /
// cache_v [B,Smax,KV,hd] and lengths [B] (int32, on the device: tokens
// valid after the step, the new ones included).  q_w / k_w: the qk-norm's
// scales [hd] or null; cos / sin: [B,T,hd/2] fp32 or null; q_out: a
// [B,T,H,hd] scratch; out [B,T,H,hd] (both contiguous).  strides[15] =
// {q, k, v, cache_k, cache_v} x (sb, ss, sh).  Writes the new k, v into
// the cache view and the attention into out.  Returns as
// repro_flash_attention; where the bf16 kernel cannot take the input it
// returns ERR_UNSUPPORTED before launching anything.
extern "C" int repro_flash_attention_chunked(
    const void* q, const void* k, const void* v, const void* q_w,
    const void* k_w, const float* cos_t, const float* sin_t,
    const int* lengths, void* q_out, void* cache_k, void* cache_v, void* out,
    int dtype, int B, int T, int H, int KV, int Smax, int hd,
    const long long* strides, float eps, float scale, void* stream) {
  if (KV <= 0 || H % KV != 0 || T <= 0 || Smax <= 0 || B <= 0 ||
      hd / 2 > 32 * PRO_PAIRS)
    return (int)cudaErrorInvalidValue;
  StridesChunk st;
  for (int i = 0; i < 15; ++i) st.v[i] = strides[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == repro::DTYPE_BF16) {
    if (H / KV > (hd > 128 ? 64 : 128))      // FlashShape<hd>::BM
      return ERR_UNSUPPORTED;
    err = launch_chunked<__nv_bfloat16>(q, k, v, q_w, k_w, eps, cos_t, sin_t,
                                        lengths, q_out, cache_k, cache_v, out,
                                        B, T, H, KV, Smax, hd, st, scale, s);
  } else if (dtype == repro::DTYPE_F32) {
    err = launch_chunked<float>(q, k, v, q_w, k_w, eps, cos_t, sin_t,
                                lengths, q_out, cache_k, cache_v, out, B, T,
                                H, KV, Smax, hd, st, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
