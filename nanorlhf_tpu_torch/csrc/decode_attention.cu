// Prefix-bounded single-query GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel nanorlhf_tpu/ops/decode_attention.py:61
// `_decode_kernel` (driver `decode_attention`, :409). Same function: for
// each row b, the G query heads of kv head g attend over the contiguous
// cache slots [start[b], filled[b]) only; slots outside are never read, and
// a row with no valid slot (filled <= start, e.g. filled == 0) reads nothing
// and returns zeros, as the Pallas kernel does. The TPU's Gp = max(8, G)
// query padding was a sublane workaround and is not copied.
//
// What bounds it on this card: bytes. Each call reads the valid K/V prefix
// once (2 · KV · n_valid · hd · 2 B per row) and does only ~2 · G flops per
// byte, far below the ~295 flop/byte at which the tensor cores would be the
// limit. The design therefore spends nothing on the tensor cores and
// everything on reading the prefix once, coalesced:
//   * one block of 8 warps per (kv head, row); the G query vectors sit in
//     shared memory and every K/V row is read once for all G heads;
//   * warps take 32-key tiles round-robin; in a tile each lane scores one
//     key against all G heads (its K row as 16-byte vectors), the warp runs
//     the online-softmax update with shuffles, and the V rows are read
//     coalesced, each lane accumulating hd/32 output dims for every head;
//   * the 8 warps' partial (m, l, acc) are merged through shared memory.
// Known limit, left for the next PR: B·KV blocks (32 at the rollout shape)
// occupy a quarter of the 132 SMs; splitting the prefix over more blocks
// with an LSE merge (flash-decoding) is the fix.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAXG = 8;  // query heads per kv head handled by one block
constexpr float NEG_INF = -1e30f;

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

template <int HD>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kc,
              const bf16* __restrict__ vc, const int* __restrict__ start,
              const int* __restrict__ filled, bf16* __restrict__ out, int H,
              int KV, int T, float scale) {
  constexpr int PER = HD / 32;  // output dims per lane
  __shared__ float qs[MAXG][HD];
  __shared__ float part_m[WARPS][MAXG];
  __shared__ float part_l[WARPS][MAXG];
  __shared__ float part_acc[WARPS][MAXG][HD];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int i = tid; i < G * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    qs[g][d] = __bfloat162float(q[((size_t)b * H + kvh * G + g) * HD + d]);
  }
  __syncthreads();

  const int s0 = max(start[b], 0);
  const int s1 = min(filled[b], T);
  const bf16* kb = kc + (size_t)(b * KV + kvh) * T * HD;
  const bf16* vb = vc + (size_t)(b * KV + kvh) * T * HD;

  float m[MAXG], l[MAXG], acc[MAXG][PER];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int d = 0; d < PER; ++d) acc[g][d] = 0.f;
  }

  for (int t0 = s0 + warp * 32; t0 < s1; t0 += WARPS * 32) {
    const int key = t0 + lane;
    const bool ok = key < s1;
    float s[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) s[g] = 0.f;
    if (ok) {
      const bf16* krow = kb + (size_t)key * HD;
#pragma unroll 4
      for (int c = 0; c < HD; c += 8) {
        const uint4 u = *reinterpret_cast<const uint4*>(krow + c);
        const bf16* kv8 = reinterpret_cast<const bf16*>(&u);
        float kf[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[e] = __bfloat162float(kv8[e]);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < G) {
#pragma unroll
            for (int e = 0; e < 8; ++e) s[g] += qs[g][c + e] * kf[e];
          }
        }
      }
    }
    float p[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        const float sg = ok ? s[g] * scale : NEG_INF;
        const float m_new = fmaxf(m[g], warp_max(sg));
        const float alpha = __expf(m[g] - m_new);
        p[g] = ok ? __expf(sg - m_new) : 0.f;
        l[g] = alpha * l[g] + warp_sum(p[g]);
        m[g] = m_new;
#pragma unroll
        for (int d = 0; d < PER; ++d) acc[g][d] *= alpha;
      }
    }
    const int nk = min(32, s1 - t0);
    for (int j = 0; j < nk; ++j) {
      const bf16* vrow = vb + (size_t)(t0 + j) * HD + lane * PER;
      float vf[PER];
#pragma unroll
      for (int d = 0; d < PER; ++d) vf[d] = __bfloat162float(vrow[d]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float pj = __shfl_sync(0xffffffffu, p[g], j);
#pragma unroll
          for (int d = 0; d < PER; ++d) acc[g][d] += pj * vf[d];
        }
      }
    }
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
      if (lane == 0) {
        part_m[warp][g] = m[g];
        part_l[warp][g] = l[g];
      }
#pragma unroll
      for (int d = 0; d < PER; ++d) part_acc[warp][g][lane * PER + d] = acc[g][d];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    float mx = NEG_INF;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, part_m[w][g]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float f = __expf(part_m[w][g] - mx);
      lsum += part_l[w][g] * f;
      a += part_acc[w][g][d] * f;
    }
    out[((size_t)b * H + kvh * G + g) * HD + d] =
        __float2bfloat16(a / fmaxf(lsum, 1e-30f));
  }
}

template <int HD>
int launch(const void* q, const void* kc, const void* vc, const void* start,
           const void* filled, void* out, int B, int H, int KV, int T,
           cudaStream_t stream) {
  dim3 grid(KV, B);
  decode_kernel<HD><<<grid, THREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kc),
      static_cast<const bf16*>(vc), static_cast<const int*>(start),
      static_cast<const int*>(filled), static_cast<bf16*>(out), H, KV, T,
      (float)(1.0 / sqrt((double)HD)));
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, H, HD], k/v cache [B, KV, T, HD] bf16, start/filled [B] int32;
// out [B, H, HD] bf16. Returns the CUDA error code of the launch.
extern "C" int decode_attention_bf16(const void* q, const void* kc,
                                     const void* vc, const void* start,
                                     const void* filled, void* out, int B,
                                     int H, int KV, int T, int HD,
                                     void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || H / KV > MAXG) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (HD == 128) return launch<128>(q, kc, vc, start, filled, out, B, H, KV, T, s);
  if (HD == 64) return launch<64>(q, kc, vc, start, filled, out, B, H, KV, T, s);
  return (int)cudaErrorInvalidValue;
}
