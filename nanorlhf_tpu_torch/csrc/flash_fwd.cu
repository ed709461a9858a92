// Causal GQA flash-attention forward for Hopper (sm_90a), bf16 in/out.
//
// Replaces the Pallas kernel nanorlhf_tpu/ops/attention.py:91 `_flash_kernel`
// (driver `_flash_forward`, :160). Same function: online softmax over kv
// tiles, the [B, T] key_valid mask, kv tiles above the diagonal skipped, kv
// head h // G read directly (no repeat), and a per-row LSE, here [B, H, T]
// f32 (the TPU's lane-expanded LSE and sublane-broadcast mask were tiling
// workarounds, not semantics).
//
// What bounds it on this card: at the scoring shape (B=16, H=12, T≈1.5k,
// d=128) the work is ~0.1 TFLOP per layer against ~20 MB of q/k/v/out, so
// it is bound by operations: only the tensor cores can feed it. The design:
//   * one block of 4 warps per (b, h, 64-row query tile); the q tile stays
//     in shared memory for the whole kv loop, each 64-key K/V tile is
//     loaded once per block into shared memory;
//   * S = Q·Kᵀ and O += P·V run on the tensor cores through WMMA
//     16x16x16 bf16 fragments with f32 accumulation; each warp owns 16
//     query rows, so the online-softmax bookkeeping (m, l per row) needs
//     only warp shuffles, no block barrier;
//   * the O accumulator lives in shared memory in f32, so the per-row
//     rescale by exp(m_old − m_new) is a plain shared-memory multiply
//     (WMMA accumulator fragments have no documented row layout);
//   * masked scores use a large finite NEG_INF (as the Pallas kernel does),
//     so a fully masked row gives a finite average instead of NaN, and
//     l is clamped at 1e-30 before the division.
// Not done yet (later PRs): wgmma, TMA, pipelined K/V loads, warp
// specialisation. The backward kernels belong to the training slice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per kv tile
constexpr int WARPS = 4;      // each warp owns 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1e30f;

template <int HD>
struct Layout {
  // padded leading dimensions (elements) — multiples of 8 (bf16) / 4 (f32)
  // as WMMA requires, and every 16-row fragment start stays 32-byte aligned
  static constexpr int LD_QKV = HD + 8;
  static constexpr int LD_S = BK + 4;
  static constexpr int LD_P = BK + 8;
  static constexpr int LD_O = HD + 4;
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + sizeof(bf16) * BQ * LD_QKV;
  static constexpr size_t V = K + sizeof(bf16) * BK * LD_QKV;
  static constexpr size_t S = V + sizeof(bf16) * BK * LD_QKV;
  static constexpr size_t P = S + sizeof(float) * BQ * LD_S;
  static constexpr size_t O = P + sizeof(bf16) * BQ * LD_P;
  static constexpr size_t OK = O + sizeof(float) * BQ * LD_O;
  static constexpr size_t BYTES = OK + sizeof(int) * BK;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

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
  for (int i = tid; i < 64 * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * HD + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v,
                 const uint8_t* __restrict__ key_valid,
                 bf16* __restrict__ out, float* __restrict__ lse, int H,
                 int KV, int T, int causal, float scale) {
  using L = Layout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::K);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::V);
  float* ss = reinterpret_cast<float*>(smem + L::S);
  bf16* ps = reinterpret_cast<bf16*>(smem + L::P);
  float* os = reinterpret_cast<float*>(smem + L::O);
  int* kok = reinterpret_cast<int*>(smem + L::OK);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = warp * 16;  // this warp's first row inside the tile

  const bf16* qb = q + (size_t)(b * H + h) * T * HD;
  const bf16* kb = k + (size_t)(b * KV + kvh) * T * HD;
  const bf16* vb = v + (size_t)(b * KV + kvh) * T * HD;
  const uint8_t* valid_b = key_valid + (size_t)b * T;

  load_tile<HD, L::LD_QKV>(qs, qb, q0, T, tid);
  for (int i = tid; i < BQ * L::LD_O; i += THREADS) os[i] = 0.f;

  float m_row[16], l_row[16];  // identical in every lane of the warp
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m_row[r] = NEG_INF;
    l_row[r] = 0.f;
  }

  const int n_kv = (T + BK - 1) / BK;
  // causal: tiles starting past the block's last query row are pure future
  const int last = causal ? min(n_kv - 1, (q0 + BQ - 1) / BK) : n_kv - 1;

  for (int j = 0; j <= last; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<HD, L::LD_QKV>(ks, kb, k0, T, tid);
    load_tile<HD, L::LD_QKV>(vs, vb, k0, T, tid);
    if (tid < BK) {
      const int kp = k0 + tid;
      kok[tid] = (kp < T && valid_b[kp]) ? 1 : 0;
    }
    __syncthreads();

    // S[16 x 64] = Q[16 x HD] · K[64 x HD]ᵀ for this warp's rows
#pragma unroll
    for (int nt = 0; nt < BK / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, qs + r0 * L::LD_QKV + kk * 16, L::LD_QKV);
        wmma::load_matrix_sync(fb, ks + nt * 16 * L::LD_QKV + kk * 16, L::LD_QKV);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(ss + r0 * L::LD_S + nt * 16, acc, L::LD_S,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax, one row at a time; lane owns columns lane, lane + 32
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r;
      const int qp = q0 + row;
      float sv[BK / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < BK / 32; ++c) {
        const int col = lane + 32 * c;
        const bool ok = kok[col] && (!causal || k0 + col <= qp);
        const float s = ok ? ss[row * L::LD_S + col] * scale : NEG_INF;
        sv[c] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_new = fmaxf(m_row[r], mx);
      const float alpha = __expf(m_row[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < BK / 32; ++c) {
        const float p = __expf(sv[c] - m_new);
        sum += p;
        ps[row * L::LD_P + lane + 32 * c] = __float2bfloat16(p);
      }
      sum = warp_sum(sum);
      l_row[r] = alpha * l_row[r] + sum;
      m_row[r] = m_new;
#pragma unroll
      for (int c = lane; c < HD; c += 32) os[row * L::LD_O + c] *= alpha;
    }
    __syncwarp();

    // O[16 x HD] += P[16 x 64] · V[64 x HD]
#pragma unroll
    for (int nt = 0; nt < HD / 16; ++nt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, os + r0 * L::LD_O + nt * 16, L::LD_O,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, ps + r0 * L::LD_P + kk * 16, L::LD_P);
        wmma::load_matrix_sync(fb, vs + kk * 16 * L::LD_QKV + nt * 16, L::LD_QKV);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(os + r0 * L::LD_O + nt * 16, acc, L::LD_O,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

  // out = O / l in the input dtype, lse = m + log(l); rows past T unwritten
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = r0 + r;
    const int qp = q0 + row;
    if (qp < T) {
      const float l = fmaxf(l_row[r], 1e-30f);
      const float inv = 1.f / l;
      bf16* orow = out + ((size_t)(b * H + h) * T + qp) * HD;
      for (int c = lane; c < HD; c += 32) {
        orow[c] = __float2bfloat16(os[row * L::LD_O + c] * inv);
      }
      if (lane == 0) lse[(size_t)(b * H + h) * T + qp] = m_row[r] + logf(l);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* key_valid,
           void* out, void* lse, int B, int H, int KV, int T, int causal,
           cudaStream_t stream) {
  const size_t smem = Layout<HD>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const uint8_t*>(key_valid),
      static_cast<bf16*>(out), static_cast<float*>(lse), H, KV, T, causal,
      (float)(1.0 / sqrt((double)HD)));
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, H, T, HD], k/v [B, KV, T, HD] bf16, key_valid [B, T] uint8;
// out [B, H, T, HD] bf16, lse [B, H, T] f32. Returns the CUDA error code.
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
