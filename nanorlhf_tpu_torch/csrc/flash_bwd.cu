// GQA flash-attention backward for Hopper (sm_90a), bf16 in/out:
// warpgroup MMA (wgmma) with register accumulators, TMA loads into an
// mbarrier ring fed by a producer warp, and a balanced dK/dV split with no
// float atomics.
//
// Replaces the Pallas kernels nanorlhf_tpu/ops/attention.py:230 `_dq_kernel`
// and :282 `_dkv_kernel` (called from `_flash_backward`, :343). Same function,
// the FlashAttention-2 backward over the forward's per-row LSE:
//   P = exp(S·scale − lse),  Δ_i = Σ_d dO_id · O_id,
//   dV = Pᵀ·dO,  dP = dO·Vᵀ,  dS = P ⊙ (dP − Δ),
//   dQ = dS·K · scale,  dK = dSᵀ·Q · scale,
// for any T, the key_valid and causal masks, head_dim 64 and 128, any
// G = H / KV, dK/dV summed over each kv head's G query heads. Two kernels,
// as in JAX, and the same bits run to run:
//   * `flash_bwd_dq_bf16` launches a Δ pass (16-byte loads of dO and O),
//     then one block per (b, h, 64-row query tile), the heavy late tiles of
//     the causal mask first, walking the kv tiles up to the diagonal;
//   * `flash_bwd_dkv_bf16` launches one block per row of a schedule table
//     built on the host (ops/attention.py `dkv_schedule`): a (b, kv head,
//     64-key tile) and a range of its (g, query tile) steps. A key tile cut
//     into parts writes f32 partial dK/dV; a reduce pass sums the parts in
//     slot order and rounds to bf16. A tile of one part writes bf16 itself.
//
// What bounds it on this card. dq computes S, dP and dQ — 1.5× the
// forward's causal FLOPs — and moves q, O, dO, dq, k, v, lse and Δ; dkv
// computes S, dP, dV and dK — 2× — and moves q, dO, k, v, lse, Δ, dk and
// dv (`chip_smoke.py` counts both the same way). At the update shape B=4,
// H=12, KV=2, d=128, causal: at T=1510, 42.1 and 56.1 GFLOP (0.043 and
// 0.057 ms at 989 TFLOP/s) against 81.0 and 50.1 MB (0.024 and 0.015 ms
// at 3.35 TB/s), so both are bound by operations; at T=522, 5.0 and 6.7
// GFLOP (0.005 and 0.007 ms) against 28.0 and 17.3 MB (0.008 and 0.005
// ms): dq is bound by bytes there, dkv by operations.
//
// What each part of the design does about what held the WMMA version back:
//   1. state in shared memory → wgmma m64nNk16, one consumer warpgroup per
//      64 rows. S, dP and the dQ (or dK and dV) sums live in registers;
//      P and dS are rounded to bf16 in registers and fed back as wgmma's
//      register A operand. Nothing of S, P, dP or dS touches shared memory.
//      `setmaxnreg` gives the consumers 232 registers, the producer 24.
//   2. no copy overlapped compute → one producer thread starts TMA loads
//      (128-byte swizzle, the layout wgmma reads) into a 2-stage ring with
//      full/empty mbarriers: the next K/V (dq) or Q/dO (dkv) tile arrives
//      while the current one is computed. q/k/v/dO are described as 3-D
//      [B·heads, T, d], so a tile past T is zero-filled, never the next
//      head's rows. dkv's short rows, lse and Δ, come by 1-D TMA boxes
//      started at the 16-byte boundary below the row (a box must start on
//      one) and read at their offset. dq's key flags are global loads, two
//      bytes a lane one step ahead, turned into each thread's columns by
//      two warp ballots.
//   3. one block per SM → 97 KB of shared memory and 256 threads a block
//      at d = 128: two blocks per SM, one's exp pass under the other's MMA.
//   4. dK/dV filled the card poorly and unevenly → the schedule cuts the
//      heavy key tiles (low x under the causal mask) into more parts than
//      the light ones and lists the blocks heaviest first; S is chosen for
//      ≥ 2 blocks per SM and no block above 1.3× the mean steps.
//   5. Δ computed serially → its own pass, one 16-byte load per lane.
//
// Masking: scores of invalid keys (key_valid false, or past T) and, with
// `causal`, of future keys take the forward's finite NEG_INF. A left-pad
// query row whose keys are all masked has lse = NEG_INF, so its P is
// uniform and finite; its dO is 0 on the training path, so dS = 0 exactly.
// Query rows past T carry no gradient into dK/dV.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;            // query rows of a tile
constexpr int BK = 64;            // key rows of a tile
constexpr int STAGES = 2;         // depth of the TMA ring
constexpr int WG = 128;           // threads of a warpgroup
constexpr int THREADS = 2 * WG;   // producer warpgroup + one consumer warpgroup
constexpr int SCHED_COLS = 8;     // int32 per schedule / reduce row
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float NEG_INF_L2 = NEG_INF * LOG2E;
// 1-D box of a row of 64 floats, from the 16-byte boundary at or below its
// start
constexpr int ROW_BOX = BQ + 4;

// a [64, HD] bf16 tile in shared memory: HD / 64 column chunks, each 64
// rows of 128 bytes in TMA's 128-byte swizzle (1024-byte aligned)
template <int HD>
struct Tile {
  static constexpr int CHUNK = 64 * 128;
  static constexpr int BYTES = HD / 64 * CHUNK;
};

// ---------------------------------------------------------------- PTX --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// the producer's arrival, announcing the bytes its TMA loads will bring
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// TMA: a box of a 3-D map (d, row, head) / of a 1-D map into shared memory,
// completing on `bar`'s transaction count
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void tma_1d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0) : "memory");
}

// a [64, HD] tile (HD / 64 boxes of 64 x 64)
template <int HD>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int head) {
#pragma unroll
  for (int c = 0; c < HD / 64; ++c) tma_3d(dst + c * Tile<HD>::CHUNK, map, bar, c * 64, row, head);
}

// wgmma shared-memory descriptor, 128-byte swizzle. K-major operands
// (each row runs along the contraction dim): LBO unused, SBO = 1024 (8
// rows of 128 B);
// the k16 slice kk starts kk·32 bytes into the swizzle row. MN-major
// operands (the contraction dim runs down the rows): LBO = the stride of
// the 64-column chunks, SBO = 1024; slice kk starts 16 rows (2048 B) on.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4)
       | (static_cast<uint64_t>(lbo >> 4) << 16)
       | (static_cast<uint64_t>(sbo >> 4) << 32)
       | (1ull << 62);
}

template <int HD>
__device__ __forceinline__ uint64_t desc_kmajor(const unsigned char* tile, int kk) {
  return desc(tile + (kk / 4) * Tile<HD>::CHUNK + (kk % 4) * 32, 16, 1024);
}

__device__ __forceinline__ uint64_t desc_mnmajor(const unsigned char* tile, int kk) {
  return desc(tile + kk * 2048, 64 * 128, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving register reads / writes across a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d[0..31] (+)= A·B, m64n64k16: A and B both K-major in shared memory
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0..31] (+)= A·B, m64n64k16: A in registers (bf16x2), B MN-major in shared memory
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t* a,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d[0..63] (+)= A·B, m64n128k16: A in registers (bf16x2), B MN-major in shared memory
__device__ __forceinline__ void mma_rs_n128(float (&d)[64], const uint32_t* a,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (+)= A·B for the m64 x HD x 16 slice: A from registers, B MN-major
template <int HD>
__device__ __forceinline__ void mma_rs(float (&d)[HD / 2], const uint32_t* a,
                                       uint64_t db, int accumulate) {
  if constexpr (HD == 128) {
    mma_rs_n128(d, a, db, accumulate);
  } else {
    mma_rs_n64(d, a, db, accumulate);
  }
}

// S = A·Bᵀ over the HD contraction, both [64, HD] tiles K-major
template <int HD>
__device__ __forceinline__ void mma_abt(float (&d)[32], const unsigned char* a,
                                        const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    mma_ss_n64(d, desc_kmajor<HD>(a, kk), desc_kmajor<HD>(b, kk), kk > 0);
  }
}

// d += A·B over 64 rows of B: A the bf16 fragments of a 64 x 64 register
// tile (4 per k16 slice), B a [64, HD] tile read MN-major
template <int HD>
__device__ __forceinline__ void mma_ab(float (&d)[HD / 2], const uint32_t (&a)[16],
                                       const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_rs<HD>(d, a + 4 * kk, desc_mnmajor(b, kk), 1);
}

// The accumulator layout of m64nN: thread t of the warpgroup holds rows
// r = 16·(t/32) + (t%32)/4 and r + 8, and for each 8-column block j the
// columns 8j + 2·(t%4) + {0, 1}: d[4j + e] in row r, d[4j + 2 + e] in
// row r + 8. The k16 slice kk of a 64-column tile, as wgmma's register A
// operand, is then {d[8kk..8kk+1], d[8kk+2..+3], d[8kk+4..+5], d[8kk+6..+7]}
// packed in pairs.

// Δ = Σ_d dO·O per row, one 16-byte load of each per lane
template <int HD>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                       float* __restrict__ delta, int rows) {
  constexpr int LANES = HD / 8;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = t / LANES;
  const int c = (t % LANES) * 8;
  float s = 0.f;
  if (row < rows) {
    const uint4 o = *reinterpret_cast<const uint4*>(out + (size_t)row * HD + c);
    const uint4 g = *reinterpret_cast<const uint4*>(dout + (size_t)row * HD + c);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = __bfloat1622float2(o2[i]);
      const float2 b = __bfloat1622float2(g2[i]);
      s = fmaf(a.x, b.x, s);
      s = fmaf(a.y, b.y, s);
    }
  }
#pragma unroll
  for (int m = LANES / 2; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (row < rows && c == 0) delta[row] = s;
}

// dq's shared memory, byte offsets from a 1024-aligned base
template <int HD>
struct DqSmem {
  static constexpr int T_ = Tile<HD>::BYTES;
  static constexpr int Q = 0, DO = T_;
  static constexpr int K = 2 * T_;                  // + stage · 2 tiles
  static constexpr int V = 3 * T_;
  static constexpr int BARS = (2 + 2 * STAGES) * T_;    // full, empty, q
  static constexpr int BYTES = BARS + (2 * STAGES + 1) * 8 + 1024;  // + alignment
  static constexpr uint32_t STAGE_TX = 2 * T_;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023) & ~1023u) - a);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const uint8_t* __restrict__ key_valid,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int B, int H, int KV, int T, int causal,
                    float scale) {
  using L = DqSmem<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  // heavy (late) query tiles first under the causal mask
  const int n_qt = (T + BQ - 1) / BQ;
  const int n_kt = (T + BK - 1) / BK;
  const int bh = blockIdx.x % (B * H);
  const int q0 = (n_qt - 1 - blockIdx.x / (B * H)) * BQ;
  const int b = bh / H;
  const int kvh = (bh % H) / (H / KV);
  const int n_steps = causal ? min(n_kt, (q0 + BQ - 1) / BK + 1) : n_kt;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < WG) {
    // producer warpgroup: one thread streams the tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      mbar_expect_tx(qbar, 2 * Tile<HD>::BYTES);
      tma_tile<HD>(sm + L::Q, &tm_q, qbar, q0, bh);
      tma_tile<HD>(sm + L::DO, &tm_do, qbar, q0, bh);
      for (int j = 0; j < n_steps; ++j) {
        const int s = j % STAGES;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::STAGE_TX);
        const int kvrow = b * KV + kvh;
        tma_tile<HD>(sm + L::K + s * 2 * Tile<HD>::BYTES, &tm_k, &full[s], j * BK, kvrow);
        tma_tile<HD>(sm + L::V + s * 2 * Tile<HD>::BYTES, &tm_v, &full[s], j * BK, kvrow);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ct = tid - WG;
    const int r = 16 * (ct / 32) + (ct % 32) / 4;
    const int c2 = 2 * (ct % 4);
    const int qp0 = q0 + r, qp1 = q0 + r + 8;
    const size_t row0 = (size_t)bh * T;
    const float l0 = qp0 < T ? lse[row0 + qp0] * LOG2E : 0.f;
    const float l1 = qp1 < T ? lse[row0 + qp1] * LOG2E : 0.f;
    const float dl0 = qp0 < T ? delta[row0 + qp0] : 0.f;
    const float dl1 = qp1 < T ? delta[row0 + qp1] : 0.f;
    const float scale_l2 = scale * LOG2E;

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    // key tile j's flags, columns `lane` and 32 + `lane` of each warp's
    // lanes (0 past T), loaded one step ahead of the ballots that use them
    const uint8_t* flags_row = key_valid + (size_t)b * T;
    const int lane = ct % 32;
    uint32_t f_lo = lane < T ? flags_row[lane] : 0u;
    uint32_t f_hi = 32 + lane < T ? flags_row[32 + lane] : 0u;
    mbar_wait(qbar, 0);

    for (int j = 0; j < n_steps; ++j) {
      const int s = j % STAGES;
      const unsigned char* ks = sm + L::K + s * 2 * Tile<HD>::BYTES;
      const unsigned char* vs = sm + L::V + s * 2 * Tile<HD>::BYTES;
      const int k0 = j * BK;
      // the tile's 64 flags as bits, shifted so that bit 8·jn + e is this
      // thread's column 8·jn + c2 + e
      const uint64_t key_ok = ((uint64_t)__ballot_sync(0xffffffffu, f_lo != 0u)
                               | (uint64_t)__ballot_sync(0xffffffffu, f_hi != 0u) << 32) >> c2;
      if (j + 1 < n_steps) {
        f_lo = k0 + BK + lane < T ? flags_row[k0 + BK + lane] : 0u;
        f_hi = k0 + BK + 32 + lane < T ? flags_row[k0 + BK + 32 + lane] : 0u;
      }
      mbar_wait(&full[s], (j / STAGES) & 1);

      float sacc[32], pacc[32];
      wg_fence();
      mma_abt<HD>(sacc, sm + L::Q, ks);
      mma_abt<HD>(pacc, sm + L::DO, vs);
      wg_commit();
      wg_wait_all();
      fence_regs(sacc);
      fence_regs(pacc);

      // dS = P ⊙ (dP − Δ), P = exp(S·scale − lse), masked scores NEG_INF
      uint32_t ds[16];
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * jn + c2 + e;
          const bool kok = (key_ok >> (8 * jn + e)) & 1u;
          const bool ok0 = kok && (!causal || kp <= qp0);
          const bool ok1 = kok && (!causal || kp <= qp1);
          const float p0 = exp2_approx(ok0 ? fmaf(sacc[4 * jn + e], scale_l2, -l0)
                                           : NEG_INF_L2 - l0);
          const float p1 = exp2_approx(ok1 ? fmaf(sacc[4 * jn + 2 + e], scale_l2, -l1)
                                           : NEG_INF_L2 - l1);
          v[e] = p0 * (pacc[4 * jn + e] - dl0);
          v[2 + e] = p1 * (pacc[4 * jn + 2 + e] - dl1);
        }
        ds[2 * jn] = pack_bf16(v[0], v[1]);
        ds[2 * jn + 1] = pack_bf16(v[2], v[3]);
      }

      // dQ += dS·K
      wg_fence();
      fence_regs(acc);
      mma_ab<HD>(acc, ds, ks);
      wg_commit();
      wg_wait_all();
      fence_regs(acc);
      mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int jn = 0; jn < HD / 8; ++jn) {
      const int col = 8 * jn + c2;
      if (qp0 < T) {
        *reinterpret_cast<__nv_bfloat162*>(dq + (row0 + qp0) * HD + col) =
            __floats2bfloat162_rn(acc[4 * jn] * scale, acc[4 * jn + 1] * scale);
      }
      if (qp1 < T) {
        *reinterpret_cast<__nv_bfloat162*>(dq + (row0 + qp1) * HD + col) =
            __floats2bfloat162_rn(acc[4 * jn + 2] * scale, acc[4 * jn + 3] * scale);
      }
    }
  }
}

// dkv's shared memory, byte offsets from a 1024-aligned base
template <int HD>
struct DkvSmem {
  static constexpr int T_ = Tile<HD>::BYTES;
  static constexpr int K = 0, V = T_;
  static constexpr int Q = 2 * T_;                       // + stage · 2 tiles
  static constexpr int DO = 3 * T_;
  static constexpr int LSE = (2 + 2 * STAGES) * T_;      // + stage · 512
  static constexpr int DELTA = LSE + STAGES * 512;      // + stage · 512
  static constexpr int BARS = DELTA + STAGES * 512;      // full, empty, kv
  static constexpr int BYTES = BARS + (2 * STAGES + 1) * 8 + 1024;
  static constexpr uint32_t STAGE_TX = 2 * T_ + 2 * ROW_BOX * 4;
};

// One block per schedule row (b, kv head, key tile x, first step, end
// step, slot): dK and dV of the tile's 64 keys over steps [first, end) of
// its (g, query tile) walk, g outer. slot < 0: the whole walk, written as
// bf16; else f32 partials into slot `slot` of part_k / part_v.
template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_lse,
                     const __grid_constant__ CUtensorMap tm_delta,
                     const uint8_t* __restrict__ key_valid,
                     const int* __restrict__ sched, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, float* __restrict__ part_k,
                     float* __restrict__ part_v, int H, int KV, int T,
                     int causal, float scale) {
  using L = DkvSmem<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;

  const int* row = sched + (size_t)blockIdx.x * SCHED_COLS;
  const int b = row[0], kvh = row[1], x = row[2];
  const int first = row[3], end = row[4], slot = row[5];
  const int G = H / KV;
  const int k0 = x * BK;
  const int n_q = (T + BQ - 1) / BQ;
  const int i0 = causal ? k0 / BQ : 0;
  const int n_i = n_q - i0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < WG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      mbar_expect_tx(kvbar, 2 * Tile<HD>::BYTES);
      tma_tile<HD>(sm + L::K, &tm_k, kvbar, k0, b * KV + kvh);
      tma_tile<HD>(sm + L::V, &tm_v, kvbar, k0, b * KV + kvh);
      for (int j = 0; j < end - first; ++j) {
        const int s = j % STAGES;
        const int step = first + j;
        const int head = b * H + kvh * G + step / n_i;
        const int q0 = (i0 + step % n_i) * BQ;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::STAGE_TX);
        tma_tile<HD>(sm + L::Q + s * 2 * Tile<HD>::BYTES, &tm_q, &full[s], q0, head);
        tma_tile<HD>(sm + L::DO + s * 2 * Tile<HD>::BYTES, &tm_do, &full[s], q0, head);
        tma_1d(sm + L::LSE + s * 512, &tm_lse, &full[s], (head * T + q0) & ~3);
        tma_1d(sm + L::DELTA + s * 512, &tm_delta, &full[s], (head * T + q0) & ~3);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ct = tid - WG;
    const int r = 16 * (ct / 32) + (ct % 32) / 4;  // key rows r and r + 8
    const int c2 = 2 * (ct % 4);
    const int kp0 = k0 + r, kp1 = k0 + r + 8;
    const bool kok0 = kp0 < T && key_valid[(size_t)b * T + kp0] != 0;
    const bool kok1 = kp1 < T && key_valid[(size_t)b * T + kp1] != 0;
    const float scale_l2 = scale * LOG2E;

    float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) {
      dk_acc[i] = 0.f;
      dv_acc[i] = 0.f;
    }
    mbar_wait(kvbar, 0);

    for (int j = 0; j < end - first; ++j) {
      const int s = j % STAGES;
      const int step = first + j;
      const int q0 = (i0 + step % n_i) * BQ;
      const int shift = ((b * H + kvh * G + step / n_i) * T + q0) & 3;
      const unsigned char* qs = sm + L::Q + s * 2 * Tile<HD>::BYTES;
      const unsigned char* dos = sm + L::DO + s * 2 * Tile<HD>::BYTES;
      const float* lse_s = reinterpret_cast<const float*>(sm + L::LSE + s * 512) + shift;
      const float* delta_s = reinterpret_cast<const float*>(sm + L::DELTA + s * 512) + shift;
      mbar_wait(&full[s], (j / STAGES) & 1);

      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: keys down, queries across
      float sacc[32], pacc[32];
      wg_fence();
      mma_abt<HD>(sacc, sm + L::K, qs);
      mma_abt<HD>(pacc, sm + L::V, dos);
      wg_commit();
      wg_wait_all();
      fence_regs(sacc);
      fence_regs(pacc);

      uint32_t pf[16], dsf[16];
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        float p[4], d[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * jn + c2 + e;
          const int qp = q0 + col;
          // query rows past T carry no gradient (their lse is the next
          // head's, or 0 past the end)
          const float l = qp < T ? lse_s[col] * LOG2E : -NEG_INF_L2;
          const float dl = qp < T ? delta_s[col] : 0.f;
          const bool ok0 = kok0 && (!causal || kp0 <= qp);
          const bool ok1 = kok1 && (!causal || kp1 <= qp);
          p[e] = exp2_approx(ok0 ? fmaf(sacc[4 * jn + e], scale_l2, -l) : NEG_INF_L2 - l);
          p[2 + e] = exp2_approx(ok1 ? fmaf(sacc[4 * jn + 2 + e], scale_l2, -l)
                                     : NEG_INF_L2 - l);
          d[e] = p[e] * (pacc[4 * jn + e] - dl);
          d[2 + e] = p[2 + e] * (pacc[4 * jn + 2 + e] - dl);
        }
        pf[2 * jn] = pack_bf16(p[0], p[1]);
        pf[2 * jn + 1] = pack_bf16(p[2], p[3]);
        dsf[2 * jn] = pack_bf16(d[0], d[1]);
        dsf[2 * jn + 1] = pack_bf16(d[2], d[3]);
      }

      // dV += Pᵀ·dO, dK += dSᵀ·Q
      wg_fence();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      mma_ab<HD>(dv_acc, pf, dos);
      mma_ab<HD>(dk_acc, dsf, qs);
      wg_commit();
      wg_wait_all();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      mbar_arrive(&empty[s]);
    }

    const size_t kv_row = (size_t)(b * KV + kvh) * T;
#pragma unroll
    for (int jn = 0; jn < HD / 8; ++jn) {
      const int col = 8 * jn + c2;
      if (slot < 0) {
        if (kp0 < T) {
          *reinterpret_cast<__nv_bfloat162*>(dk + (kv_row + kp0) * HD + col) =
              __floats2bfloat162_rn(dk_acc[4 * jn] * scale, dk_acc[4 * jn + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + (kv_row + kp0) * HD + col) =
              __floats2bfloat162_rn(dv_acc[4 * jn], dv_acc[4 * jn + 1]);
        }
        if (kp1 < T) {
          *reinterpret_cast<__nv_bfloat162*>(dk + (kv_row + kp1) * HD + col) =
              __floats2bfloat162_rn(dk_acc[4 * jn + 2] * scale, dk_acc[4 * jn + 3] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + (kv_row + kp1) * HD + col) =
              __floats2bfloat162_rn(dv_acc[4 * jn + 2], dv_acc[4 * jn + 3]);
        }
      } else {
        const size_t p0 = ((size_t)slot * BK + r) * HD + col;
        const size_t p1 = p0 + 8 * HD;
        *reinterpret_cast<float2*>(part_k + p0) = make_float2(dk_acc[4 * jn], dk_acc[4 * jn + 1]);
        *reinterpret_cast<float2*>(part_k + p1) = make_float2(dk_acc[4 * jn + 2], dk_acc[4 * jn + 3]);
        *reinterpret_cast<float2*>(part_v + p0) = make_float2(dv_acc[4 * jn], dv_acc[4 * jn + 1]);
        *reinterpret_cast<float2*>(part_v + p1) = make_float2(dv_acc[4 * jn + 2], dv_acc[4 * jn + 3]);
      }
    }
  }
}

// One block per reduce row (b, kv head, key tile x, first slot, parts):
// dK = scale · Σ_p part_k[first + p], dV = Σ_p part_v[first + p], p in order
template <int HD>
__global__ void __launch_bounds__(256)
flash_bwd_dkv_reduce_kernel(const int* __restrict__ reduce,
                            const float* __restrict__ part_k,
                            const float* __restrict__ part_v, bf16* __restrict__ dk,
                            bf16* __restrict__ dv, int KV, int T, float scale) {
  const int* row = reduce + (size_t)blockIdx.x * SCHED_COLS;
  const int b = row[0], kvh = row[1], x = row[2], first = row[3], parts = row[4];
  const size_t kv_row = (size_t)(b * KV + kvh) * T;
  for (int i = threadIdx.x; i < BK * HD / 4; i += blockDim.x) {
    const int r = i / (HD / 4);
    const int c = (i % (HD / 4)) * 4;
    const int kp = x * BK + r;
    if (kp >= T) continue;
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int p = 0; p < parts; ++p) {
      const size_t off = ((size_t)(first + p) * BK + r) * HD + c;
      const float4 a = *reinterpret_cast<const float4*>(part_k + off);
      const float4 v = *reinterpret_cast<const float4*>(part_v + off);
      sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
      sv.x += v.x; sv.y += v.y; sv.z += v.z; sv.w += v.w;
    }
    __nv_bfloat162* okk = reinterpret_cast<__nv_bfloat162*>(dk + (kv_row + kp) * HD + c);
    __nv_bfloat162* ovv = reinterpret_cast<__nv_bfloat162*>(dv + (kv_row + kp) * HD + c);
    okk[0] = __floats2bfloat162_rn(sk.x * scale, sk.y * scale);
    okk[1] = __floats2bfloat162_rn(sk.z * scale, sk.w * scale);
    ovv[0] = __floats2bfloat162_rn(sv.x, sv.y);
    ovv[1] = __floats2bfloat162_rn(sv.z, sv.w);
  }
}

// ---------------------------------------------------------------- host --

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// [heads, T, HD] bf16 in boxes of 64 rows x 64 columns, 128-byte swizzle;
// a box past T is zero-filled
bool map_rows(CUtensorMap* m, const void* base, int heads, int T, int HD) {
  const cuuint64_t dims[3] = {(cuuint64_t)HD, (cuuint64_t)T, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)HD * 2, (cuuint64_t)T * HD * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encoder()(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                   strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a flat array of n elements in boxes of `box`
bool map_flat(CUtensorMap* m, const void* base, CUtensorMapDataType type, size_t n,
              int box) {
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {0};
  const cuuint32_t boxes[1] = {(cuuint32_t)box};
  const cuuint32_t step[1] = {1};
  return encoder()(m, type, 1, const_cast<void*>(base), dims, strides, boxes, step,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                   CU_TENSOR_MAP_L2_PROMOTION_NONE,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

float softmax_scale(int HD) { return (float)(1.0 / sqrt((double)HD)); }

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* key_valid,
              const void* out, const void* lse, const void* dout, void* dq,
              void* delta, int B, int H, int KV, int T, int causal,
              cudaStream_t stream) {
  if (encoder() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv, tdo;
  if (!map_rows(&tq, q, B * H, T, HD) || !map_rows(&tk, k, B * KV, T, HD) ||
      !map_rows(&tv, v, B * KV, T, HD) || !map_rows(&tdo, dout, B * H, T, HD)) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows = B * H * T;
  const int lanes = rows * (HD / 8);
  flash_bwd_delta_kernel<HD><<<(lanes + 255) / 256, 256, 0, stream>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<float*>(delta), rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int smem = DqSmem<HD>::BYTES;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (T + BQ - 1) / BQ * B * H;
  flash_bwd_dq_kernel<HD><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const uint8_t*>(key_valid), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), B, H, KV, T, causal,
      softmax_scale(HD));
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* key_valid,
               const void* lse, const void* delta, const void* dout, void* dk,
               void* dv, int B, int H, int KV, int T, int causal, const void* sched,
               int n_blocks, const void* reduce, int n_reduce, void* part_k,
               void* part_v, cudaStream_t stream) {
  if (encoder() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv, tdo, tlse, tdelta;
  const size_t rows = (size_t)B * H * T;
  if (!map_rows(&tq, q, B * H, T, HD) || !map_rows(&tk, k, B * KV, T, HD) ||
      !map_rows(&tv, v, B * KV, T, HD) || !map_rows(&tdo, dout, B * H, T, HD) ||
      !map_flat(&tlse, lse, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rows, ROW_BOX) ||
      !map_flat(&tdelta, delta, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rows, ROW_BOX)) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = DkvSmem<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = softmax_scale(HD);
  flash_bwd_dkv_kernel<HD><<<n_blocks, THREADS, smem, stream>>>(
      tq, tk, tv, tdo, tlse, tdelta, static_cast<const uint8_t*>(key_valid),
      static_cast<const int*>(sched), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<float*>(part_k), static_cast<float*>(part_v), H, KV, T, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_reduce == 0) return (int)err;
  flash_bwd_dkv_reduce_kernel<HD><<<n_reduce, 256, 0, stream>>>(
      static_cast<const int*>(reduce), static_cast<const float*>(part_k),
      static_cast<const float*>(part_v), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      KV, T, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int occupancy(int which, int* blocks) {
  const int smem = which == 0 ? DqSmem<HD>::BYTES : DkvSmem<HD>::BYTES;
  const void* fn = which == 0 ? (const void*)flash_bwd_dq_kernel<HD>
                              : (const void*)flash_bwd_dkv_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, THREADS, smem);
}

}  // namespace

// q/out/dout/dq [B, H, T, HD] bf16, k/v [B, KV, T, HD] bf16, key_valid
// [B, T] uint8, lse [B, H, T] f32 (the forward's); writes delta [B, H, T]
// f32 (Σ dO·O, read by flash_bwd_dkv_bf16) and dq. Every base but
// key_valid's 16-byte aligned. Returns the CUDA error code.
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* key_valid, const void* out,
                                 const void* lse, const void* dout, void* dq,
                                 void* delta, int B, int H, int KV, int T,
                                 int HD, int causal, void* stream) {
  if (B <= 0 || T <= 0 || KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (HD == 128) return launch_dq<128>(q, k, v, key_valid, out, lse, dout, dq, delta, B, H, KV, T, causal, s);
  if (HD == 64) return launch_dq<64>(q, k, v, key_valid, out, lse, dout, dq, delta, B, H, KV, T, causal, s);
  return (int)cudaErrorInvalidValue;
}

// dk/dv [B, KV, T, HD] bf16, summed over each kv head's G query heads;
// delta as written by flash_bwd_dq_bf16 on the same stream. sched:
// n_blocks rows of 8 int32 (b, kv head, key tile, first step, end step,
// slot, 0, 0); reduce: n_reduce rows (b, kv head, key tile, first slot,
// parts, 0, 0, 0); part_k / part_v: f32 [slots, 64, HD] each.
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* key_valid, const void* lse,
                                  const void* delta, const void* dout, void* dk,
                                  void* dv, int B, int H, int KV, int T, int HD,
                                  int causal, const void* sched, int n_blocks,
                                  const void* reduce, int n_reduce, void* part_k,
                                  void* part_v, void* stream) {
  if (B <= 0 || T <= 0 || KV <= 0 || H % KV != 0 || n_blocks <= 0 || n_reduce < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (HD == 128) return launch_dkv<128>(q, k, v, key_valid, lse, delta, dout, dk, dv, B, H, KV, T, causal, sched, n_blocks, reduce, n_reduce, part_k, part_v, s);
  if (HD == 64) return launch_dkv<64>(q, k, v, key_valid, lse, delta, dout, dk, dv, B, H, KV, T, causal, sched, n_blocks, reduce, n_reduce, part_k, part_v, s);
  return (int)cudaErrorInvalidValue;
}

// blocks of the dq (which = 0) or dkv (1) kernel resident on one SM
extern "C" int flash_bwd_blocks_per_sm(int which, int HD, int* blocks) {
  if (HD == 128) return occupancy<128>(which, blocks);
  if (HD == 64) return occupancy<64>(which, blocks);
  return (int)cudaErrorInvalidValue;
}
