// Causal GQA flash-attention forward for Hopper (sm_90a), bf16 in/out:
// warpgroup MMA (wgmma) with register accumulators, TMA loads into an
// mbarrier ring fed by a producer warp, the online softmax on the
// accumulator registers.
//
// Replaces the Pallas kernel nanorlhf_tpu/ops/attention.py:91 `_flash_kernel`
// (driver `_flash_forward`, :160). Same function: online softmax over kv
// tiles, the [B, T] key_valid mask, kv tiles above the diagonal skipped, kv
// head h // G read directly (no repeat), and a per-row LSE, here [B, H, T]
// f32 (the TPU's lane-expanded LSE and sublane-broadcast mask were tiling
// workarounds, not semantics). Any T, head_dim 64 and 128, any G = H / KV.
//
// What bounds it on this card: at the scoring shape (B=16, H=12, KV=2,
// T=1510, d=128, causal) the work is 112 GFLOP (0.113 ms at 989 TFLOP/s)
// against 20 MB of q/k/v/out/lse (0.006 ms at 3.35 TB/s): operations, so
// only the tensor cores can feed it. It is PR 5's dq kernel (flash_bwd.cu)
// run forward, with the same tools (hopper_ptx.cuh):
//   1. one block per (b, h, 64-row query tile): a producer warpgroup whose
//      one thread streams TMA loads, and one consumer warpgroup that owns
//      the 64 query rows. `setmaxnreg` gives the consumers 232 registers,
//      the producer 24. 80 KB of shared memory and 256 threads at d = 128:
//      two blocks per SM, one's softmax under the other's products.
//   2. the Q tile comes once by TMA; K and V tiles through a 2-stage ring
//      with full/empty mbarriers, so tile j + 1 arrives while tile j is
//      computed. Q/K/V are 3-D maps [B·heads, T, d] with 128-byte swizzle
//      (the layout wgmma reads): a box past T is zero-filled, never the
//      next head's rows.
//   3. S = Q·Kᵀ is a wgmma m64n64k16 with both operands in shared memory
//      (K-major) and the f32 sum in registers.
//   4. the online softmax runs on those registers, in log2 units (one FFMA
//      and one ex2 a score). A row lives in one quad of four threads (the
//      accumulator layout, hopper_ptx.cuh): the row max takes two quad
//      shuffles a tile; each thread keeps its share of the row sum l and
//      the quad adds the shares once, in the epilogue (the rescale by α is
//      the same in the four threads, so the sum is the same).
//   5. P is rounded to bf16 in registers and fed back as wgmma's register A
//      operand of O += P·V (m64nHDk16, V read MN-major); O stays in f32
//      registers and is rescaled by α there. Nothing of S, P or O touches
//      shared memory.
//   6. heaviest first: block i takes query tile n_qt − 1 − i / (B·H), so
//      under the causal mask the longest walks start first and the short
//      ones fill the tail (the grid's order is this index arithmetic; there
//      is no host schedule).
//   7. the key flags are global loads, two bytes a lane one step ahead,
//      turned into each thread's columns by two warp ballots, as dq reads
//      them: in PR 5 this was 2–5% faster than a flags box in the TMA ring,
//      and it puts no alignment rule on key_valid and no slot in the ring.
//
// Masking: scores of invalid keys (key_valid false, or past T) and, with
// `causal`, of future keys take the finite NEG_INF (as the Pallas kernel
// does), so a fully masked row — a left-pad query row — averages V over the
// keys it walked and stays finite, and l is clamped at 1e-30 before the
// division. Only the diagonal tile needs the causal test. Epilogue: bf16
// O / l and f32 LSE = m + log(l).

#include "hopper_ptx.cuh"  // mbarrier, TMA, wgmma and tensor-map helpers

namespace {

constexpr int BQ = 64;            // query rows of a tile
constexpr int BK = 64;            // key rows of a tile
constexpr int STAGES = 2;         // depth of the TMA ring
constexpr int WG = 128;           // threads of a warpgroup
constexpr int THREADS = 2 * WG;   // producer warpgroup + one consumer warpgroup
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_INF_L2 = NEG_INF * LOG2E;

// shared memory, byte offsets from a 1024-aligned base
template <int HD>
struct FwdSmem {
  static constexpr int T_ = Tile<HD>::BYTES;
  static constexpr int Q = 0;
  static constexpr int K = T_;                        // + stage · 2 tiles
  static constexpr int V = 2 * T_;
  static constexpr int BARS = (1 + 2 * STAGES) * T_;   // full, empty, q
  static constexpr int BYTES = BARS + (2 * STAGES + 1) * 8 + 1024;  // + alignment
  static constexpr uint32_t STAGE_TX = 2 * T_;
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const uint8_t* __restrict__ key_valid, bf16* __restrict__ out,
                 float* __restrict__ lse, int B, int H, int KV, int T, int causal,
                 float scale) {
  using L = FwdSmem<HD>;
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
      mbar_expect_tx(qbar, Tile<HD>::BYTES);
      tma_tile<HD>(sm + L::Q, &tm_q, qbar, q0, bh);
      const int kvrow = b * KV + kvh;
      for (int j = 0; j < n_steps; ++j) {
        const int s = j % STAGES;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], L::STAGE_TX);
        tma_tile<HD>(sm + L::K + s * 2 * Tile<HD>::BYTES, &tm_k, &full[s], j * BK, kvrow);
        tma_tile<HD>(sm + L::V + s * 2 * Tile<HD>::BYTES, &tm_v, &full[s], j * BK, kvrow);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int ct = tid - WG;
    const int r = 16 * (ct / 32) + (ct % 32) / 4;  // query rows r and r + 8
    const int c2 = 2 * (ct % 4);
    const int qp0 = q0 + r, qp1 = q0 + r + 8;
    const float scale_l2 = scale * LOG2E;

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    // running row maxima (log2 units, the same in the quad) and this
    // thread's share of the row sums
    float m0 = NEG_INF_L2, m1 = NEG_INF_L2, l0 = 0.f, l1 = 0.f;
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

      float sacc[32];
      wg_fence();
      mma_abt<HD>(sacc, sm + L::Q, ks);
      wg_commit();
      wg_wait_all();
      fence_regs(sacc);

      // scores in log2 units, masked to NEG_INF; the causal test only
      // where the tile reaches past the block's first query row
      const bool diag = causal && k0 + BK - 1 > q0;
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * jn + c2 + e;
          const bool kok = (key_ok >> (8 * jn + e)) & 1u;
          const bool ok0 = kok && (!diag || kp <= qp0);
          const bool ok1 = kok && (!diag || kp <= qp1);
          float& s0 = sacc[4 * jn + e];
          float& s1 = sacc[4 * jn + 2 + e];
          s0 = ok0 ? s0 * scale_l2 : NEG_INF_L2;
          s1 = ok1 ? s1 * scale_l2 : NEG_INF_L2;
          mx0 = fmaxf(mx0, s0);
          mx1 = fmaxf(mx1, s1);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float alpha0 = exp2_approx(m0 - mx0);
      const float alpha1 = exp2_approx(m1 - mx1);
      m0 = mx0;
      m1 = mx1;

      // P = exp2(S − m), rounded to bf16 as the register A operand
      uint32_t pf[16];
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const float p00 = exp2_approx(sacc[4 * jn] - m0);
        const float p01 = exp2_approx(sacc[4 * jn + 1] - m0);
        const float p10 = exp2_approx(sacc[4 * jn + 2] - m1);
        const float p11 = exp2_approx(sacc[4 * jn + 3] - m1);
        sum0 += p00 + p01;
        sum1 += p10 + p11;
        pf[2 * jn] = pack_bf16(p00, p01);
        pf[2 * jn + 1] = pack_bf16(p10, p11);
      }
      l0 = alpha0 * l0 + sum0;
      l1 = alpha1 * l1 + sum1;
#pragma unroll
      for (int jn = 0; jn < HD / 8; ++jn) {
        o[4 * jn] *= alpha0;
        o[4 * jn + 1] *= alpha0;
        o[4 * jn + 2] *= alpha1;
        o[4 * jn + 3] *= alpha1;
      }

      // O += P·V
      wg_fence();
      fence_regs(o);
      mma_ab<HD>(o, pf, vs);
      wg_commit();
      wg_wait_all();
      fence_regs(o);
      mbar_arrive(&empty[s]);
    }

    // the quad's shares of the row sums
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    l0 = fmaxf(l0, 1e-30f);
    l1 = fmaxf(l1, 1e-30f);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const size_t row0 = (size_t)bh * T;
#pragma unroll
    for (int jn = 0; jn < HD / 8; ++jn) {
      const int col = 8 * jn + c2;
      if (qp0 < T) {
        *reinterpret_cast<__nv_bfloat162*>(out + (row0 + qp0) * HD + col) =
            __floats2bfloat162_rn(o[4 * jn] * inv0, o[4 * jn + 1] * inv0);
      }
      if (qp1 < T) {
        *reinterpret_cast<__nv_bfloat162*>(out + (row0 + qp1) * HD + col) =
            __floats2bfloat162_rn(o[4 * jn + 2] * inv1, o[4 * jn + 3] * inv1);
      }
    }
    if (c2 == 0) {
      if (qp0 < T) lse[row0 + qp0] = m0 * LN2 + logf(l0);
      if (qp1 < T) lse[row0 + qp1] = m1 * LN2 + logf(l1);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* key_valid,
           void* out, void* lse, int B, int H, int KV, int T, int causal,
           cudaStream_t stream) {
  if (encoder() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  if (!map_rows(&tq, q, B * H, T, HD) || !map_rows(&tk, k, B * KV, T, HD) ||
      !map_rows(&tv, v, B * KV, T, HD)) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = FwdSmem<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (T + BQ - 1) / BQ * B * H;
  flash_fwd_kernel<HD><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<const uint8_t*>(key_valid), static_cast<bf16*>(out),
      static_cast<float*>(lse), B, H, KV, T, causal, softmax_scale(HD));
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, H, T, HD], k/v [B, KV, T, HD] bf16 (bases 16-byte aligned),
// key_valid [B, T] uint8; out [B, H, T, HD] bf16, lse [B, H, T] f32.
// Returns the CUDA error code.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              const void* key_valid, void* out, void* lse,
                              int B, int H, int KV, int T, int HD, int causal,
                              void* stream) {
  if (B <= 0 || T <= 0 || KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (HD == 128) return launch<128>(q, k, v, key_valid, out, lse, B, H, KV, T, causal, s);
  if (HD == 64) return launch<64>(q, k, v, key_valid, out, lse, B, H, KV, T, causal, s);
  return (int)cudaErrorInvalidValue;
}
