// Causal GQA flash-attention backward for Hopper (sm_90a), bf16 in/out.
//
// Replaces the Pallas kernels nanorlhf_tpu/ops/attention.py:230 `_dq_kernel`
// and :282 `_dkv_kernel` (called from `_flash_backward`, :343). Same function,
// the FlashAttention-2 backward over the forward's per-row LSE:
//   P = exp(S − lse),  Δ_i = Σ_d dO_id · O_id,
//   dV = Pᵀ·dO,  dP = dO·Vᵀ,  dS = P ⊙ (dP − Δ),
//   dQ = dS·K · scale,  dK = dSᵀ·Q · scale.
// Two kernels and no float atomics, as in JAX, so the gradients are the
// same bits run to run:
//   * `flash_bwd_dq` — one block per (b, h, 64-row query tile) walks the kv
//     tiles up to the diagonal (the forward's causal skip) and accumulates
//     dQ. It also computes Δ for its rows in its body (as the Pallas kernel
//     does per block) and writes it out as [B, H, T] f32 for the second
//     kernel, which runs after it on the same stream;
//   * `flash_bwd_dkv` — one block per (b, kv head, 64-key tile) walks the G
//     query heads of its group and, for each, the query tiles from the
//     diagonal down; dK and dV accumulate over both loops inside the block,
//     so they come out already reduced to [B, KV, T, d] (no per-query-head
//     [B, H, T, d] buffer).
//
// What bounds it on this card: at the update shape (B=4, H=12, KV=2,
// T≈1.5k, d=128) the backward does 2.5× the forward's causal FLOPs,
// ~0.12 TFLOP a layer, against ~10 MB of q/k/v/o/dO/dq/dk/dv, so it is
// bound by operations. The design follows the forward kernel
// (csrc/flash_fwd.cu): every product runs on the tensor cores through WMMA
// 16x16x16 bf16 fragments with f32 accumulation; the tile operands sit in
// shared memory; each warp owns 16 rows (query rows in dq, key rows in
// dkv), so the elementwise P/dS step and the f32 accumulators in shared
// memory need only warp-level synchronisation. dS and P are rounded to bf16
// for their products, as the forward rounds P.
//
// Masking: scores of invalid keys (key_valid false, or past T) and, with
// `causal`, of future keys take the forward's finite NEG_INF. A left-pad
// query row whose keys are all masked has lse = NEG_INF (the forward's
// m + log l), so its P is uniform and finite; its dO is 0 on the training
// path, so Δ = 0, dP = 0 and dS = 0 exactly. Rows and keys past a ragged T
// are zero-filled in shared memory and masked, never padded by a copy.
//
// Not done yet (later PRs): wgmma, TMA, pipelined loads, a dkv split that
// fills more than 1.5 waves of SMs at B=4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BT = 64;        // rows per tile (queries and keys alike)
constexpr int WARPS = 4;      // each warp owns 16 rows of the block's tile
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1e30f;

template <int HD>
struct Lay {
  // padded leading dimensions (elements): multiples of 8 (bf16) / 4 (f32)
  // as WMMA requires; every 16-row fragment start stays 32-byte aligned
  static constexpr int LD_T = HD + 8;   // bf16 [64, HD] tiles
  static constexpr int LD_S = BT + 4;   // f32 [64, 64] scores
  static constexpr int LD_P = BT + 8;   // bf16 [64, 64] P / dS
  static constexpr int LD_A = HD + 4;   // f32 [64, HD] accumulators
  static constexpr size_t TILE = sizeof(bf16) * BT * LD_T;
  static constexpr size_t SCORE = sizeof(float) * BT * LD_S;
  static constexpr size_t PROB = sizeof(bf16) * BT * LD_P;
  static constexpr size_t ACC = sizeof(float) * BT * LD_A;
  static constexpr size_t ROWS = sizeof(float) * BT;
  // dq: Q, dO, K, V tiles; S, dP; dS; dQ acc; lse, delta, key ok
  static constexpr size_t DQ_BYTES = 4 * TILE + 2 * SCORE + PROB + ACC + 3 * ROWS;
  // dkv: K, V, Q, dO tiles; Sᵀ, dPᵀ; Pᵀ, dSᵀ; dK, dV acc; lse, delta, key ok
  static constexpr size_t DKV_BYTES = 4 * TILE + 2 * SCORE + 2 * PROB + 2 * ACC + 3 * ROWS;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows [row0, row0 + 64) of a [T, HD] bf16 matrix into shared memory
// (leading dimension LD); rows past T are zero-filled
template <int HD, int LD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0,
                                          int T, int tid) {
  constexpr int VEC = 8;  // 16-byte vectors
  constexpr int PER_ROW = HD / VEC;
  for (int i = tid; i < BT * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * HD + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// C[16 x 64] (f32, smem, ld LD_C) = A[16 x HD] · Bᵀ where A is this warp's
// 16 rows of a row-major tile and B a row-major [64, HD] tile (read as a
// col-major HD x 64 matrix)
template <int HD, int LD_T, int LD_C>
__device__ __forceinline__ void mm_abt(float* c, const bf16* a, const bf16* b) {
#pragma unroll
  for (int nt = 0; nt < BT / 16; ++nt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, a + kk * 16, LD_T);
      wmma::load_matrix_sync(fb, b + nt * 16 * LD_T + kk * 16, LD_T);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + nt * 16, acc, LD_C, wmma::mem_row_major);
  }
}

// ACC[16 x HD] (f32, smem, ld LD_A) += A[16 x 64] · B[64 x HD], A this
// warp's 16 rows of a row-major bf16 [64, 64] tile, B a row-major tile
template <int HD, int LD_P, int LD_T, int LD_A>
__device__ __forceinline__ void mm_acc(float* acc_s, const bf16* a, const bf16* b) {
#pragma unroll
  for (int nt = 0; nt < HD / 16; ++nt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, acc_s + nt * 16, LD_A, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, a + kk * 16, LD_P);
      wmma::load_matrix_sync(fb, b + kk * 16 * LD_T + nt * 16, LD_T);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(acc_s + nt * 16, acc, LD_A, wmma::mem_row_major);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const uint8_t* __restrict__ key_valid,
                    const bf16* __restrict__ out, const float* __restrict__ lse,
                    const bf16* __restrict__ dout, bf16* __restrict__ dq,
                    float* __restrict__ delta, int H, int KV, int T,
                    int causal, float scale) {
  using L = Lay<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  bf16* qs = reinterpret_cast<bf16*>(p);  p += L::TILE;
  bf16* dos = reinterpret_cast<bf16*>(p); p += L::TILE;
  bf16* ks = reinterpret_cast<bf16*>(p);  p += L::TILE;
  bf16* vs = reinterpret_cast<bf16*>(p);  p += L::TILE;
  float* ss = reinterpret_cast<float*>(p);  p += L::SCORE;
  float* dps = reinterpret_cast<float*>(p); p += L::SCORE;
  bf16* dss = reinterpret_cast<bf16*>(p);   p += L::PROB;
  float* acc = reinterpret_cast<float*>(p); p += L::ACC;
  float* lse_s = reinterpret_cast<float*>(p);   p += L::ROWS;
  float* delta_s = reinterpret_cast<float*>(p); p += L::ROWS;
  int* kok = reinterpret_cast<int*>(p);

  const int q0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = warp * 16;

  const size_t head = (size_t)(b * H + h) * T;
  const bf16* kb = k + (size_t)(b * KV + kvh) * T * HD;
  const bf16* vb = v + (size_t)(b * KV + kvh) * T * HD;
  const uint8_t* valid_b = key_valid + (size_t)b * T;

  load_tile<HD, L::LD_T>(qs, q + head * HD, q0, T, tid);
  load_tile<HD, L::LD_T>(dos, dout + head * HD, q0, T, tid);
  for (int i = tid; i < BT * L::LD_A; i += THREADS) acc[i] = 0.f;
  __syncthreads();

  // Δ = Σ_d dO·O (f32) and lse for this warp's rows; Δ goes out for dkv
  for (int r = 0; r < 16; ++r) {
    const int row = r0 + r;
    const int qp = q0 + row;
    float d = 0.f;
    if (qp < T) {
      const bf16* orow = out + (head + qp) * HD;
      for (int c = lane; c < HD; c += 32) {
        d += __bfloat162float(dos[row * L::LD_T + c]) * __bfloat162float(orow[c]);
      }
    }
    d = warp_sum(d);
    if (lane == 0) {
      delta_s[row] = d;
      lse_s[row] = qp < T ? lse[head + qp] : 0.f;
      if (qp < T) delta[head + qp] = d;
    }
  }
  __syncwarp();

  const int n_kv = (T + BT - 1) / BT;
  const int last = causal ? min(n_kv - 1, (q0 + BT - 1) / BT) : n_kv - 1;
  for (int j = 0; j <= last; ++j) {
    const int k0 = j * BT;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<HD, L::LD_T>(ks, kb, k0, T, tid);
    load_tile<HD, L::LD_T>(vs, vb, k0, T, tid);
    if (tid < BT) {
      const int kp = k0 + tid;
      kok[tid] = (kp < T && valid_b[kp]) ? 1 : 0;
    }
    __syncthreads();

    // S = Q·Kᵀ and dP = dO·Vᵀ for this warp's 16 rows
    mm_abt<HD, L::LD_T, L::LD_S>(ss + r0 * L::LD_S, qs + r0 * L::LD_T, ks);
    mm_abt<HD, L::LD_T, L::LD_S>(dps + r0 * L::LD_S, dos + r0 * L::LD_T, vs);
    __syncwarp();

    // dS = P ⊙ (dP − Δ), P = exp(S·scale − lse) with masked scores NEG_INF
    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r;
      const int qp = q0 + row;
      const float l = lse_s[row];
      const float dl = delta_s[row];
#pragma unroll
      for (int c2 = 0; c2 < BT / 32; ++c2) {
        const int col = lane + 32 * c2;
        const bool ok = kok[col] && (!causal || k0 + col <= qp);
        const float s = ok ? ss[row * L::LD_S + col] * scale : NEG_INF;
        const float pr = __expf(s - l);
        dss[row * L::LD_P + col] =
            __float2bfloat16(pr * (dps[row * L::LD_S + col] - dl));
      }
    }
    __syncwarp();

    // dQ += dS·K
    mm_acc<HD, L::LD_P, L::LD_T, L::LD_A>(acc + r0 * L::LD_A, dss + r0 * L::LD_P, ks);
    __syncwarp();
  }

  for (int r = 0; r < 16; ++r) {
    const int row = r0 + r;
    const int qp = q0 + row;
    if (qp < T) {
      bf16* drow = dq + (head + qp) * HD;
      for (int c = lane; c < HD; c += 32) {
        drow[c] = __float2bfloat16(acc[row * L::LD_A + c] * scale);
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const uint8_t* __restrict__ key_valid,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const bf16* __restrict__ dout, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int KV, int T, int causal,
                     float scale) {
  using L = Lay<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  bf16* ks = reinterpret_cast<bf16*>(p);  p += L::TILE;
  bf16* vs = reinterpret_cast<bf16*>(p);  p += L::TILE;
  bf16* qs = reinterpret_cast<bf16*>(p);  p += L::TILE;
  bf16* dos = reinterpret_cast<bf16*>(p); p += L::TILE;
  float* ss = reinterpret_cast<float*>(p);  p += L::SCORE;   // Sᵀ [keys, queries]
  float* dps = reinterpret_cast<float*>(p); p += L::SCORE;   // dPᵀ
  bf16* ps = reinterpret_cast<bf16*>(p);    p += L::PROB;    // Pᵀ
  bf16* dss = reinterpret_cast<bf16*>(p);   p += L::PROB;    // dSᵀ
  float* dk_acc = reinterpret_cast<float*>(p); p += L::ACC;
  float* dv_acc = reinterpret_cast<float*>(p); p += L::ACC;
  float* lse_s = reinterpret_cast<float*>(p);   p += L::ROWS;
  float* delta_s = reinterpret_cast<float*>(p); p += L::ROWS;
  int* kok = reinterpret_cast<int*>(p);

  const int k0 = blockIdx.x * BT;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = warp * 16;  // this warp's first KEY row inside the tile

  const size_t kv_head = (size_t)(b * KV + kvh) * T;
  load_tile<HD, L::LD_T>(ks, k + kv_head * HD, k0, T, tid);
  load_tile<HD, L::LD_T>(vs, v + kv_head * HD, k0, T, tid);
  if (tid < BT) {
    const int kp = k0 + tid;
    kok[tid] = (kp < T && key_valid[(size_t)b * T + kp]) ? 1 : 0;
  }
  for (int i = tid; i < BT * L::LD_A; i += THREADS) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  const int n_q = (T + BT - 1) / BT;
  // causal: query tiles that end before this key tile starts see none of it
  const int first = causal ? k0 / BT : 0;
  for (int g = 0; g < G; ++g) {
    const size_t head = (size_t)(b * H + kvh * G + g) * T;
    for (int i = first; i < n_q; ++i) {
      const int q0 = i * BT;
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_tile<HD, L::LD_T>(qs, q + head * HD, q0, T, tid);
      load_tile<HD, L::LD_T>(dos, dout + head * HD, q0, T, tid);
      if (tid < BT) {
        const int qp = q0 + tid;
        lse_s[tid] = qp < T ? lse[head + qp] : 0.f;
        delta_s[tid] = qp < T ? delta[head + qp] : 0.f;
      }
      __syncthreads();

      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for this warp's 16 key rows
      mm_abt<HD, L::LD_T, L::LD_S>(ss + r0 * L::LD_S, ks + r0 * L::LD_T, qs);
      mm_abt<HD, L::LD_T, L::LD_S>(dps + r0 * L::LD_S, vs + r0 * L::LD_T, dos);
      __syncwarp();

      for (int r = 0; r < 16; ++r) {
        const int row = r0 + r;       // key row
        const int kp = k0 + row;
        const bool key_ok = kok[row] != 0;
#pragma unroll
        for (int c2 = 0; c2 < BT / 32; ++c2) {
          const int col = lane + 32 * c2;  // query column
          const int qp = q0 + col;
          const bool ok = key_ok && (!causal || kp <= qp);
          const float s = ok ? ss[row * L::LD_S + col] * scale : NEG_INF;
          // query rows past T carry no gradient
          const float pr = qp < T ? __expf(s - lse_s[col]) : 0.f;
          ps[row * L::LD_P + col] = __float2bfloat16(pr);
          dss[row * L::LD_P + col] =
              __float2bfloat16(pr * (dps[row * L::LD_S + col] - delta_s[col]));
        }
      }
      __syncwarp();

      // dV += Pᵀ·dO, dK += dSᵀ·Q
      mm_acc<HD, L::LD_P, L::LD_T, L::LD_A>(dv_acc + r0 * L::LD_A, ps + r0 * L::LD_P, dos);
      mm_acc<HD, L::LD_P, L::LD_T, L::LD_A>(dk_acc + r0 * L::LD_A, dss + r0 * L::LD_P, qs);
      __syncwarp();
    }
  }

  for (int r = 0; r < 16; ++r) {
    const int row = r0 + r;
    const int kp = k0 + row;
    if (kp < T) {
      bf16* krow = dk + (kv_head + kp) * HD;
      bf16* vrow = dv + (kv_head + kp) * HD;
      for (int c = lane; c < HD; c += 32) {
        krow[c] = __float2bfloat16(dk_acc[row * L::LD_A + c] * scale);
        vrow[c] = __float2bfloat16(dv_acc[row * L::LD_A + c]);
      }
    }
  }
}

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* key_valid,
              const void* out, const void* lse, const void* dout, void* dq,
              void* delta, int B, int H, int KV, int T, int causal,
              cudaStream_t stream) {
  const size_t smem = Lay<HD>::DQ_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BT - 1) / BT, H, B);
  flash_bwd_dq_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(key_valid),
      static_cast<const bf16*>(out), static_cast<const float*>(lse),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dq),
      static_cast<float*>(delta), H, KV, T, causal,
      (float)(1.0 / sqrt((double)HD)));
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* key_valid,
               const void* lse, const void* delta, const void* dout, void* dk,
               void* dv, int B, int H, int KV, int T, int causal,
               cudaStream_t stream) {
  const size_t smem = Lay<HD>::DKV_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BT - 1) / BT, KV, B);
  flash_bwd_dkv_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(key_valid),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, KV, T, causal, (float)(1.0 / sqrt((double)HD)));
  return (int)cudaGetLastError();
}

}  // namespace

// q/out/dout/dq [B, H, T, HD] bf16, k/v [B, KV, T, HD] bf16, key_valid
// [B, T] uint8, lse [B, H, T] f32 (the forward's); writes dq and
// delta [B, H, T] f32 (Σ dO·O, read by flash_bwd_dkv_bf16). Returns the
// CUDA error code.
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

// dk/dv [B, KV, T, HD] bf16, already summed over each kv head's G query
// heads; delta as written by flash_bwd_dq_bf16 on the same stream.
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* key_valid, const void* lse,
                                  const void* delta, const void* dout, void* dk,
                                  void* dv, int B, int H, int KV, int T, int HD,
                                  int causal, void* stream) {
  if (B <= 0 || T <= 0 || KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (HD == 128) return launch_dkv<128>(q, k, v, key_valid, lse, delta, dout, dk, dv, B, H, KV, T, causal, s);
  if (HD == 64) return launch_dkv<64>(q, k, v, key_valid, lse, delta, dout, dk, dv, B, H, KV, T, causal, s);
  return (int)cudaErrorInvalidValue;
}
