// Fused hidden→logprob (linear cross-entropy forward) for Hopper (sm_90a).
//
// Replaces the Pallas kernel nanorlhf_tpu/ops/fused_logprob.py:228
// `_fused_kernel` (driver `_pallas_forward`, :307). Same function: per row,
// z = h · W / T computed inside the kernel, a vocab-blocked online
// logsumexp with the tail masked at V, the label logit gathered (exactly one
// column matches across all vocab tiles), and optionally the entropy via the
// unnormalised Σ exp(z − m)·z; the [rows, V] logits never reach device
// memory. W is read in either layout without a transposed copy: [D, V], or
// the tied embedding [V, D] (`transposed`).
//
// What bounds it on this card: operations. At the scoring shape
// (R = 16·1500 rows, D = 1536, V = 151936) the product is ~11 TFLOP against
// ~0.5 GB of W and h, so only the tensor cores can carry it.
//
// Design choice — vocab split across blocks, then a merge pass. The Pallas
// grid walks the vocab axis in order and carries (m, l, g, u) in scratch;
// on Hopper blocks run in parallel in no order. One block per row tile
// looping over all of V would give only R/128 = 188 blocks at the scoring
// shape, 1.4 waves over 132 SMs with a ragged last wave. Instead the grid is
// (row tiles × vocab splits): each block runs a 128×128 output tile GEMM
// (WMMA bf16 16x16x16, f32 accumulation, 64-deep K steps through shared
// memory) for each vocab tile of its split and folds the tile into per-row
// running (m, l, g, u) with an online-logsumexp epilogue; partial states go
// to a small [splits, R] buffer and a second kernel merges them
// (M = max m_s, L = Σ l_s·e^{m_s−M}, U = Σ u_s·e^{m_s−M}, G = Σ g_s).
// Not done yet (later PRs): wgmma, TMA, a cp.async pipeline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128;   // rows per block
constexpr int BN = 128;   // vocab columns per tile
constexpr int BKD = 64;   // depth (D) per shared-memory step
constexpr int WARPS = 8;  // 2 (rows) x 4 (cols), each warp a 64x32 sub-tile
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1e30f;

constexpr int LDA = BKD + 8;  // A tile [BM][LDA], transposed-W tile [BN][LDA]
constexpr int LDB = BN + 8;   // [D, V] W tile [BKD][LDB]
constexpr int LDC = BN + 4;   // f32 output tile [BM][LDC]
constexpr size_t A_OFF = 0;
constexpr size_t B_OFF = A_OFF + sizeof(bf16) * BM * LDA;
constexpr size_t B_BYTES = (sizeof(bf16) * BN * LDA > sizeof(bf16) * BKD * LDB)
                               ? sizeof(bf16) * BN * LDA
                               : sizeof(bf16) * BKD * LDB;
constexpr size_t C_OFF = B_OFF + B_BYTES;
constexpr size_t ST_OFF = C_OFF + sizeof(float) * BM * LDC;  // m, l, g, u
constexpr size_t LAB_OFF = ST_OFF + sizeof(float) * 4 * BM;
constexpr size_t SMEM_BYTES = LAB_OFF + sizeof(int) * BM;

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

template <bool TRANSPOSED, bool ENTROPY>
__global__ void __launch_bounds__(THREADS)
fused_partial_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                     const int* __restrict__ labels, float* __restrict__ part,
                     int R, int D, int V, int tiles_per_split, float inv_temp) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem + A_OFF);
  bf16* Bs = reinterpret_cast<bf16*>(smem + B_OFF);
  float* Cs = reinterpret_cast<float*>(smem + C_OFF);
  float* st_m = reinterpret_cast<float*>(smem + ST_OFF);
  float* st_l = st_m + BM;
  float* st_g = st_l + BM;
  float* st_u = st_g + BM;
  int* lab = reinterpret_cast<int*>(smem + LAB_OFF);

  const int row0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp % 2;  // 64-row half
  const int wn = warp / 2;  // 32-column quarter

  for (int r = tid; r < BM; r += THREADS) {
    st_m[r] = NEG_INF;
    st_l[r] = 0.f;
    st_g[r] = 0.f;
    st_u[r] = 0.f;
    lab[r] = (row0 + r < R) ? labels[row0 + r] : -1;
  }

  const int n_vt = (V + BN - 1) / BN;
  const int vt_begin = split * tiles_per_split;
  const int vt_end = min(n_vt, vt_begin + tiles_per_split);

  for (int vt = vt_begin; vt < vt_end; ++vt) {
    const int v0 = vt * BN;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int k0 = 0; k0 < D; k0 += BKD) {
      __syncthreads();  // previous step's tiles (and the epilogue) are done
      // A: rows [row0, row0+BM) x depth [k0, k0+BKD) of h [R, D]
      for (int i = tid; i < BM * (BKD / 8); i += THREADS) {
        const int r = i / (BKD / 8);
        const int c = (i % (BKD / 8)) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + r < R) {
          val = *reinterpret_cast<const uint4*>(h + (size_t)(row0 + r) * D + k0 + c);
        }
        *reinterpret_cast<uint4*>(As + r * LDA + c) = val;
      }
      if (TRANSPOSED) {
        // W [V, D]: vocab rows [v0, v0+BN) x depth [k0, k0+BKD)
        for (int i = tid; i < BN * (BKD / 8); i += THREADS) {
          const int r = i / (BKD / 8);
          const int c = (i % (BKD / 8)) * 8;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (v0 + r < V) {
            val = *reinterpret_cast<const uint4*>(w + (size_t)(v0 + r) * D + k0 + c);
          }
          *reinterpret_cast<uint4*>(Bs + r * LDA + c) = val;
        }
      } else {
        // W [D, V]: depth rows [k0, k0+BKD) x vocab [v0, v0+BN); V % 8 == 0
        for (int i = tid; i < BKD * (BN / 8); i += THREADS) {
          const int r = i / (BN / 8);
          const int c = (i % (BN / 8)) * 8;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if (v0 + c < V) {
            val = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * V + v0 + c);
          }
          *reinterpret_cast<uint4*>(Bs + r * LDB + c) = val;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BKD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          wmma::load_matrix_sync(fa[i], As + (wm * 64 + i * 16) * LDA + kk * 16, LDA);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = wn * 32 + j * 16;
          if (TRANSPOSED) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
            wmma::load_matrix_sync(fb, Bs + n * LDA + kk * 16, LDA);
#pragma unroll
            for (int i = 0; i < 4; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
          } else {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
            wmma::load_matrix_sync(fb, Bs + kk * 16 * LDB + n, LDB);
#pragma unroll
            for (int i = 0; i < 4; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Cs + (wm * 64 + i * 16) * LDC + wn * 32 + j * 16,
                                acc[i][j], LDC, wmma::mem_row_major);
    __syncthreads();

    // epilogue: warp w folds rows [16w, 16w+16) of the tile into the
    // running per-row state; lane owns columns lane + 32c
    for (int r = warp * 16; r < warp * 16 + 16; ++r) {
      float s[BN / 32];
      float mx = NEG_INF, gsum = 0.f;
      const int label = lab[r];
#pragma unroll
      for (int c = 0; c < BN / 32; ++c) {
        const int col = v0 + lane + 32 * c;
        // vocab tail mask: columns past V are neutralised, never read
        const float z = col < V ? Cs[r * LDC + lane + 32 * c] * inv_temp : NEG_INF;
        s[c] = z;
        mx = fmaxf(mx, z);
        if (col == label) gsum += z;
      }
      mx = warp_max(mx);
      gsum = warp_sum(gsum);
      const float m_prev = st_m[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = __expf(m_prev - m_new);
      float psum = 0.f, pz = 0.f;
#pragma unroll
      for (int c = 0; c < BN / 32; ++c) {
        const float p = __expf(s[c] - m_new);
        psum += p;
        if (ENTROPY) pz += p * s[c];
      }
      psum = warp_sum(psum);
      if (ENTROPY) pz = warp_sum(pz);
      __syncwarp();
      if (lane == 0) {
        st_m[r] = m_new;
        st_l[r] = alpha * st_l[r] + psum;
        st_g[r] += gsum;
        if (ENTROPY) st_u[r] = alpha * st_u[r] + pz;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int r = tid; r < BM; r += THREADS) {
    const int row = row0 + r;
    if (row < R) {
      float* p = part + ((size_t)split * R + row) * 4;
      p[0] = st_m[r];
      p[1] = st_l[r];
      p[2] = st_g[r];
      p[3] = st_u[r];
    }
  }
}

__global__ void merge_kernel(const float* __restrict__ part, float* __restrict__ lp,
                             float* __restrict__ ent, int R, int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= R) return;
  float M = NEG_INF;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, part[((size_t)s * R + row) * 4]);
  float Lsum = 0.f, G = 0.f, U = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* p = part + ((size_t)s * R + row) * 4;
    const float f = expf(p[0] - M);
    Lsum += p[1] * f;
    G += p[2];
    U += p[3] * f;
  }
  const float l = fmaxf(Lsum, 1e-30f);
  const float lse = M + logf(l);
  lp[row] = G - lse;
  if (ent != nullptr) ent[row] = lse - U / l;
}

template <bool TRANSPOSED, bool ENTROPY>
int launch_partial(const void* h, const void* w, const void* labels, void* part,
                   int R, int D, int V, int splits, int tiles_per_split,
                   float inv_temp, cudaStream_t stream) {
  auto kernel = fused_partial_kernel<TRANSPOSED, ENTROPY>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((R + BM - 1) / BM, splits);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w),
      static_cast<const int*>(labels), static_cast<float*>(part), R, D, V,
      tiles_per_split, inv_temp);
  return (int)cudaGetLastError();
}

}  // namespace

// h [R, D] bf16; w [D, V] bf16, or [V, D] when `transposed`; labels [R]
// int32; part [splits, R, 4] f32 scratch; lp [R] f32; ent [R] f32 or null
// (null = no entropy work at all). D % 64 == 0; V % 8 == 0 when not
// transposed. Returns the CUDA error code of the launches.
extern "C" int fused_logprob_bf16(const void* h, const void* w, const void* labels,
                                  void* part, void* lp, void* ent, int R, int D,
                                  int V, int transposed, int splits,
                                  float inv_temp, void* stream) {
  if (R <= 0 || D % BKD != 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  if (!transposed && V % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_vt = (V + BN - 1) / BN;
  const int tiles_per_split = (n_vt + splits - 1) / splits;
  const bool entropy = ent != nullptr;
  int err;
  if (transposed) {
    err = entropy ? launch_partial<true, true>(h, w, labels, part, R, D, V, splits, tiles_per_split, inv_temp, s)
                  : launch_partial<true, false>(h, w, labels, part, R, D, V, splits, tiles_per_split, inv_temp, s);
  } else {
    err = entropy ? launch_partial<false, true>(h, w, labels, part, R, D, V, splits, tiles_per_split, inv_temp, s)
                  : launch_partial<false, false>(h, w, labels, part, R, D, V, splits, tiles_per_split, inv_temp, s);
  }
  if (err != 0) return err;
  merge_kernel<<<(R + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(lp),
      static_cast<float*>(ent), R, splits);
  return (int)cudaGetLastError();
}
