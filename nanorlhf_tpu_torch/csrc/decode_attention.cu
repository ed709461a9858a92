// Prefix-bounded single-query GQA decode attention for Hopper (sm_90a):
// the contiguous bf16 cache, the paged bf16 cache, and their int8 twins.
//
// Replaces four Pallas kernels of nanorlhf_tpu/ops/decode_attention.py:
//   K4 `_decode_kernel` (:61)           -> decode_attention_bf16
//   K7 `_paged_decode_kernel` (:537)    -> paged_decode_attention_bf16
//   K5 `_decode_q8_kernel` (:124)       -> decode_attention_q8
//   K8 `_paged_decode_q8_kernel` (:546) -> paged_decode_attention_q8
// Same function as there: for each row b, the G query heads of kv head g
// attend over the logical cache slots [start[b], filled[b]) only; slots
// outside are never read, and a row with no valid slot (filled <= start,
// e.g. filled == 0) reads nothing and returns zeros. The TPU's Gp = max(8, G)
// query padding and its [.., 8, T] sublane-expanded scales were tiling
// workarounds and are not copied.
//
// One body, four ways to read the cache. As in JAX, where K7/K8 are the
// K4/K5 bodies behind another index map, only the address of a logical slot
// differs between the four instances (`slot_index` below):
//   * contiguous: slot t of row b sits at [b, kvh, t] of [B, KV, T, hd];
//   * paged: at [table[b, t / P], kvh, t % P] of the pool [N, KV, P, hd].
//     The table row goes into shared memory once per block. Each key is
//     resolved on its own, so a 32-key tile may straddle pages and any page
//     size works (P need not divide 32 or T_max). K7 walks the same tiles in
//     the same order as K4 and does the same arithmetic, so on the same
//     logical cache it returns the same bits. A sentinel entry (>= N, an
//     unallocated or released block) is clamped to N - 1, as in JAX: such
//     slots lie outside [start, filled) or belong to a released row whose
//     output the caller discards, and the clamp keeps a bad table inside the
//     pool.
//   * int8 (K5/K8): values int8 [.., hd] with one bf16 scale per (kv head,
//     slot), scales [B, KV, T] or [N, KV, P]. The int8 bytes are read once
//     and widened in registers only; the K scale folds into the score, the V
//     scale into the probability (sum_t p_t * (vq_t * vs_t) = sum_t (p_t *
//     vs_t) * vq_t), as the Pallas kernel does.
//
// What bounds it on this card: bytes. Each call reads the valid K/V prefix
// once (bf16: 2 * KV * n_valid * hd * 2 B per row; int8: half that plus 2 *
// 2 B of scales per (kv head, slot)) and does only ~2 * G flops per byte, far
// below the ~295 flop/byte at which the tensor cores would be the limit. The
// design therefore spends nothing on the tensor cores and everything on
// reading the prefix once, coalesced:
//   * one block of 8 warps per (kv head, row); the G query vectors sit in
//     shared memory and every K/V row is read once for all G heads;
//   * warps take 32-key tiles round-robin; in a tile each lane scores one
//     key against all G heads (its K row as 16-byte bf16 or 8-byte int8
//     vectors), the warp runs the online-softmax update with shuffles, and
//     the V rows are read coalesced, each lane accumulating hd/32 output
//     dims for every head;
//   * the 8 warps' partial (m, l, acc) are merged through shared memory.
// Known limit, left for later work: B*KV blocks (64 at the rollout's 32
// resident rows) occupy half of the 132 SMs or less; splitting the prefix
// over more blocks with an LSE merge (flash-decoding) is the fix.
//
// The k-query speculative verify (second kernel body, below the decode one):
//   K6 `_verify_kernel` (:280)        -> decode_verify_attention_bf16
//   K9 `_paged_verify_kernel` (:555)  -> paged_decode_verify_attention_bf16
// q [B, H, Tq, HD] holds Tq = spec_k + 1 candidate queries per head. Row r
// of kv head kvh is query head kvh * G + r / Tq at candidate qi = r % Tq
// (JAX's row order); it attends to logical slots start <= t < fill + qi + 1
// (the candidates' K/V are already written at [fill, fill + Tq)). A block
// holds R = G * Tq rows (30 at G = 6, spec_k = 4): the decode body's
// per-lane registers for every row and its cross-warp merge buffer
// ([WARPS][R][HD] floats) do not stretch that far, so the verify body works
// the other way round. Each 32-key K/V tile is copied into shared memory
// once per block (cp.async, double-buffered: tile i + 1 loads while tile i
// is used; keys past the block's range are zero-filled, so the key loops
// unroll fully); each warp owns R / 8 rows over the block's whole key range,
// so every row's online softmax runs in one warp. In a tile lane j scores
// key j against the warp's rows (K rows padded by 16 bytes in shared
// memory, so the lanes' 16-byte reads do not collide), then each lane
// accumulates HD / 32 output dims of every row from the V tile. Each row is
// masked at its own bound. Such a block is latency-bound (a few warps, long
// dependent chains): one block per (row, kv head) took 0.68 ms at the
// rollout's B = 16 on an H100, 32 blocks on 132 SMs. So each row's key range
// is split into S ranges of whole tiles over a third grid axis (S chosen by
// the wrapper from the SM count and B * KV), each block writes its partial
// (acc, m, l) to f32 scratch, and a second kernel merges them (the
// flash-decoding split that K4 still lacks). Still bytes-bound in
// principle: ~2 * R flops per cache byte against the ~295 at which the
// tensor cores would limit, so no wgmma. K9 is the same body with K7's
// slot address and the same S: on the same logical cache it returns K6's
// bits. Its key range is clamped to the table (nb * P): a row one token
// short of its page budget has candidates past the table, whose writes the
// model drops and whose outputs the sampler discards.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAXG = 8;     // query heads per kv head handled by one block
constexpr int MAX_NB = 1024;  // block-table entries per row (paged)
constexpr float NEG_INF = -1e30f;

struct Args {
  const bf16* q;        // [B, H, HD]
  const void* k;        // bf16 or int8, contiguous [B, KV, T, HD] or pool [N+, KV, P, HD]
  const void* v;
  const bf16* ks;       // int8 only: scales [B, KV, T] or [N+, KV, P]
  const bf16* vs;
  const int* table;     // paged only: [B, nb]
  const int* start;     // [B]
  const int* filled;    // [B]
  bf16* out;            // [B, H, HD]
  int H, KV, T, N, P, nb;
  float scale;
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

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

// 8 consecutive elements of a K row as floats (16 bytes of bf16, 8 of int8)
__device__ __forceinline__ void load8(const bf16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = __bfloat162float(h[e]);
}

__device__ __forceinline__ void load8(const int8_t* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = (float)c[e];
}

template <int HD, bool PAGED, bool Q8>
__global__ void __launch_bounds__(THREADS) decode_kernel(Args a) {
  typedef typename std::conditional<Q8, int8_t, bf16>::type E;
  constexpr int PER = HD / 32;  // output dims per lane
  __shared__ float qs[MAXG][HD];
  __shared__ float part_m[WARPS][MAXG];
  __shared__ float part_l[WARPS][MAXG];
  __shared__ float part_acc[WARPS][MAXG][HD];
  __shared__ int tbl[PAGED ? MAX_NB : 1];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int H = a.H, KV = a.KV;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int i = tid; i < G * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    qs[g][d] = __bfloat162float(a.q[((size_t)b * H + kvh * G + g) * HD + d]);
  }
  if constexpr (PAGED) {
    for (int i = tid; i < a.nb; i += THREADS)
      tbl[i] = min(max(a.table[(size_t)b * a.nb + i], 0), a.N - 1);
  }
  __syncthreads();

  // the index of logical slot t of this (row, kv head) in units of HD
  // elements of K/V, and in elements of the scales
  auto slot_index = [&](int t) -> size_t {
    if constexpr (PAGED) {
      const int page = tbl[t / a.P];
      return ((size_t)page * KV + kvh) * a.P + (t % a.P);
    } else {
      return ((size_t)b * KV + kvh) * a.T + t;
    }
  };

  const int t_max = PAGED ? a.nb * a.P : a.T;
  const int s0 = max(a.start[b], 0);
  const int s1 = min(a.filled[b], t_max);
  const E* kc = static_cast<const E*>(a.k);
  const E* vc = static_cast<const E*>(a.v);

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
    float kscale = 1.f, vscale = 1.f;
    if (ok) {
      const size_t si = slot_index(key);
      const E* krow = kc + si * HD;
      if constexpr (Q8) {
        kscale = __bfloat162float(a.ks[si]);
        vscale = __bfloat162float(a.vs[si]);
      }
#pragma unroll 4
      for (int c = 0; c < HD; c += 8) {
        float kf[8];
        load8(krow + c, kf);
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
        float sg = NEG_INF;
        if (ok) sg = Q8 ? s[g] * a.scale * kscale : s[g] * a.scale;
        const float m_new = fmaxf(m[g], warp_max(sg));
        const float alpha = __expf(m[g] - m_new);
        p[g] = ok ? __expf(sg - m_new) : 0.f;
        l[g] = alpha * l[g] + warp_sum(p[g]);
        m[g] = m_new;
        if (Q8) p[g] *= vscale;  // the V scale folds into the probability
#pragma unroll
        for (int d = 0; d < PER; ++d) acc[g][d] *= alpha;
      }
    }
    const int nk = min(32, s1 - t0);
    for (int j = 0; j < nk; ++j) {
      const E* vrow = vc + slot_index(t0 + j) * HD + lane * PER;
      float vf[PER];
#pragma unroll
      for (int d = 0; d < PER; ++d) vf[d] = to_f(vrow[d]);
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
    float lsum = 0.f, acc_d = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float f = __expf(part_m[w][g] - mx);
      lsum += part_l[w][g] * f;
      acc_d += part_acc[w][g][d] * f;
    }
    a.out[((size_t)b * H + kvh * G + g) * HD + d] =
        __float2bfloat16(acc_d / fmaxf(lsum, 1e-30f));
  }
}

template <bool PAGED, bool Q8>
int launch(Args a, int B, int HD, void* stream) {
  if (B <= 0 || a.KV <= 0 || a.H % a.KV != 0 || a.H / a.KV > MAXG)
    return (int)cudaErrorInvalidValue;
  if (PAGED && (a.P <= 0 || a.N <= 0 || a.nb <= 0 || a.nb > MAX_NB))
    return (int)cudaErrorInvalidValue;
  a.scale = (float)(1.0 / sqrt((double)HD));
  dim3 grid(a.KV, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (HD == 128)
    decode_kernel<128, PAGED, Q8><<<grid, THREADS, 0, s>>>(a);
  else if (HD == 64)
    decode_kernel<64, PAGED, Q8><<<grid, THREADS, 0, s>>>(a);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------------------
// K6 / K9: the k-query verify (see the header)
// --------------------------------------------------------------------------

constexpr int VTILE = 32;             // keys per shared-memory tile: one per lane
constexpr int MAXR = 64;              // query rows G * Tq per block
constexpr int MAXRW = MAXR / WARPS;   // query rows per warp
constexpr int MAXTQ = 8;              // candidates per head (spec_k <= 7)
constexpr int KPAD = 8;               // bf16 padding of a K tile row
constexpr int MAXS = 16;              // key-range splits per (row, kv head)

struct VerifyArgs {
  const bf16* q;      // [B, H, Tq, HD]
  const bf16* k;      // contiguous [B, KV, T, HD] or pool [N+, KV, P, HD]
  const bf16* v;
  const int* table;   // paged only: [B, nb]
  const int* start;   // [B]
  const int* fill;    // [B]: the slot of candidate 0
  bf16* out;          // [B, H, Tq, HD]
  float* part;        // partial states [B, KV, S, R, HD + 2] (acc, m, l)
  int H, KV, T, N, P, nb, Tq, S;
  float scale;
};

// 16 bytes global -> shared, or 16 zero bytes when `full` is false
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = full ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// dynamic shared memory: K tiles [2][VTILE][HD + KPAD] and V tiles
// [2][VTILE][HD] bf16, the block's queries [R][HD] f32, the table row [nb]
// N = 2 or 4 consecutive bf16 (4 or 8 bytes) as floats
template <int N>
__device__ __forceinline__ void load_row_part(const bf16* p, float* f) {
  if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = __bfloat162float(h[e]);
  } else {
    const unsigned u = *reinterpret_cast<const unsigned*>(p);
    const bf16* h = reinterpret_cast<const bf16*>(&u);
    f[0] = __bfloat162float(h[0]);
    f[1] = __bfloat162float(h[1]);
  }
}

template <int HD>
size_t verify_smem_bytes(int R, int nb) {
  return (size_t)2 * VTILE * (HD + KPAD) * 2 + (size_t)2 * VTILE * HD * 2 +
         (size_t)R * HD * 4 + (size_t)nb * 4;
}

template <int HD, bool PAGED>
__global__ void __launch_bounds__(THREADS) verify_kernel(VerifyArgs a) {
  constexpr int PER = HD / 32;      // output dims per lane
  constexpr int KROW = HD + KPAD;   // 16-byte aligned: HD * 2 + 16 bytes
  constexpr int CH = HD / 8;        // 16-byte chunks per K/V row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* kt = reinterpret_cast<bf16*>(smem);
  bf16* vt = kt + 2 * VTILE * KROW;
  float* qs = reinterpret_cast<float*>(vt + 2 * VTILE * HD);

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int H = a.H, KV = a.KV, Tq = a.Tq;
  const int G = H / KV;
  const int R = G * Tq;
  int* tbl = reinterpret_cast<int*>(qs + R * HD);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // rows r = g * Tq + qi of this kv head are contiguous in q and out
  const size_t row0 = ((size_t)b * H + (size_t)kvh * G) * Tq;
  for (int i = tid; i < R * HD; i += THREADS)
    qs[i] = __bfloat162float(a.q[row0 * HD + i]);
  if constexpr (PAGED) {
    for (int i = tid; i < a.nb; i += THREADS)
      tbl[i] = min(max(a.table[(size_t)b * a.nb + i], 0), a.N - 1);
  }
  __syncthreads();

  auto slot_index = [&](int t) -> size_t {
    if constexpr (PAGED) {
      const int page = tbl[t / a.P];
      return ((size_t)page * KV + kvh) * a.P + (t % a.P);
    } else {
      return ((size_t)b * KV + kvh) * a.T + t;
    }
  };

  const int t_max = PAGED ? a.nb * a.P : a.T;
  const int fill = a.fill[b];
  // the row's keys [start, min(fill + Tq, t_max)) are split into S ranges of
  // whole tiles; this block takes range blockIdx.z
  const int r0 = max(a.start[b], 0);
  const int r1 = max(min(fill + Tq, t_max), r0);
  const int chunk = ((r1 - r0 + a.S - 1) / a.S + VTILE - 1) / VTILE * VTILE;
  const int s0 = min(r0 + (int)blockIdx.z * chunk, r1);
  const int s1 = min(s0 + chunk, r1);  // one past the last key of this block
  const int nrw = warp < R ? (R - warp + WARPS - 1) / WARPS : 0;  // warp-uniform

  float m[MAXRW], l[MAXRW], acc[MAXRW][PER];
  int hi[MAXRW];
#pragma unroll
  for (int j = 0; j < MAXRW; ++j) {
    const int r = warp + j * WARPS;
    hi[j] = min(fill + r % Tq + 1, s1);
    m[j] = NEG_INF;
    l[j] = 0.f;
#pragma unroll
    for (int d = 0; d < PER; ++d) acc[j][d] = 0.f;
  }

  // keys past s1 are zero-filled: their scores are masked and their zero
  // V rows add nothing, so every tile runs the full, unrolled 32-key loops
  // (K rows padded by 16 bytes: the lanes' 16-byte reads do not collide)
  auto load_tile = [&](int buf, int t0) {
    for (int i = tid; i < VTILE * CH; i += THREADS) {
      const int kk = i / CH, c = (i % CH) * 8;
      const bool in = t0 + kk < s1;
      const size_t si = in ? slot_index(t0 + kk) * HD + c : 0;
      cp_async16(kt + ((size_t)buf * VTILE + kk) * KROW + c, a.k + si, in);
      cp_async16(vt + ((size_t)buf * VTILE + kk) * HD + c, a.v + si, in);
    }
    cp_async_commit();
  };

  int buf = 0;
  if (s0 < s1) load_tile(0, s0);
  for (int t0 = s0; t0 < s1; t0 += VTILE) {
    if (t0 + VTILE < s1)
      load_tile(buf ^ 1, t0 + VTILE);
    else
      cp_async_commit();  // an empty group keeps "all but the newest" right
    cp_async_wait_one();
    __syncthreads();
    const bf16* kb = kt + (size_t)buf * VTILE * KROW;
    const bf16* vb = vt + (size_t)buf * VTILE * HD;
    const int key = t0 + lane;

    float s[MAXRW];
#pragma unroll
    for (int j = 0; j < MAXRW; ++j) s[j] = 0.f;
    {
      const bf16* krow = kb + lane * KROW;
#pragma unroll
      for (int c = 0; c < HD; c += 8) {
        float kf[8];
        load8(krow + c, kf);
#pragma unroll
        for (int j = 0; j < MAXRW; ++j) {
          if (j < nrw) {
            const float* qr = qs + (warp + j * WARPS) * HD + c;
#pragma unroll
            for (int e = 0; e < 8; ++e) s[j] += qr[e] * kf[e];
          }
        }
      }
    }
    float p[MAXRW];
#pragma unroll
    for (int j = 0; j < MAXRW; ++j) {
      p[j] = 0.f;
      if (j < nrw) {
        const bool ok = key < hi[j];  // key >= s0 holds for every tile
        const float sg = ok ? s[j] * a.scale : NEG_INF;
        const float m_new = fmaxf(m[j], warp_max(sg));
        const float alpha = __expf(m[j] - m_new);
        p[j] = ok ? __expf(sg - m_new) : 0.f;
        l[j] = alpha * l[j] + warp_sum(p[j]);
        m[j] = m_new;
#pragma unroll
        for (int d = 0; d < PER; ++d) acc[j][d] *= alpha;
      }
    }
#pragma unroll
    for (int jj = 0; jj < VTILE; ++jj) {
      float vf[PER];
      load_row_part<PER>(vb + jj * HD + lane * PER, vf);
#pragma unroll
      for (int j = 0; j < MAXRW; ++j) {
        if (j < nrw) {
          const float pj = __shfl_sync(0xffffffffu, p[j], jj);
#pragma unroll
          for (int d = 0; d < PER; ++d) acc[j][d] += pj * vf[d];
        }
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
    buf ^= 1;
  }

#pragma unroll
  for (int j = 0; j < MAXRW; ++j) {
    if (j < nrw) {
      const int r = warp + j * WARPS;
      float* e = a.part + ((((size_t)b * KV + kvh) * a.S + blockIdx.z) * R + r) * (HD + 2);
#pragma unroll
      for (int d = 0; d < PER; ++d) e[lane * PER + d] = acc[j][d];
      if (lane == 0) {
        e[HD] = m[j];
        e[HD + 1] = l[j];
      }
    }
  }
}

// the S partial softmax states of row r -> its output: one block of HD
// threads per (row, kv head, batch row), one output dim per thread
template <int HD>
__global__ void __launch_bounds__(HD) verify_merge_kernel(VerifyArgs a) {
  const int r = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int d = threadIdx.x;
  const int G = a.H / a.KV;
  const int R = G * a.Tq;
  const size_t row0 = ((size_t)b * a.H + (size_t)kvh * G) * a.Tq;
  const float* pb = a.part + (((size_t)b * a.KV + kvh) * a.S * R + r) * (HD + 2);
  const size_t stride = (size_t)R * (HD + 2);  // from one split to the next
  float mx = NEG_INF;
  for (int s = 0; s < a.S; ++s) mx = fmaxf(mx, pb[s * stride + HD]);
  float lsum = 0.f, o = 0.f;
  for (int s = 0; s < a.S; ++s) {
    const float f = __expf(pb[s * stride + HD] - mx);
    lsum += pb[s * stride + HD + 1] * f;
    o += pb[s * stride + d] * f;
  }
  a.out[(row0 + r) * HD + d] = __float2bfloat16(o / fmaxf(lsum, 1e-30f));
}

template <int HD, bool PAGED>
int launch_verify_hd(const VerifyArgs& a, int B, cudaStream_t s) {
  const size_t bytes = verify_smem_bytes<HD>(a.H / a.KV * a.Tq, PAGED ? a.nb : 0);
  const cudaError_t e = cudaFuncSetAttribute(
      verify_kernel<HD, PAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  verify_kernel<HD, PAGED><<<dim3(a.KV, B, a.S), THREADS, bytes, s>>>(a);
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return (int)e1;
  verify_merge_kernel<HD><<<dim3(a.H / a.KV * a.Tq, a.KV, B), HD, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool PAGED>
int launch_verify(VerifyArgs a, int B, int HD, void* stream) {
  if (B <= 0 || a.KV <= 0 || a.H % a.KV != 0 || a.H / a.KV > MAXG ||
      a.Tq < 1 || a.Tq > MAXTQ || (a.H / a.KV) * a.Tq > MAXR || a.S < 1 ||
      a.S > MAXS || a.part == nullptr)
    return (int)cudaErrorInvalidValue;
  if (PAGED && (a.P <= 0 || a.N <= 0 || a.nb <= 0 || a.nb > MAX_NB))
    return (int)cudaErrorInvalidValue;
  a.scale = (float)(1.0 / sqrt((double)HD));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (HD == 128) return launch_verify_hd<128, PAGED>(a, B, s);
  if (HD == 64) return launch_verify_hd<64, PAGED>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Each entry returns the CUDA error code of the launch (0 = launched).

// K4. q [B, H, HD], k/v cache [B, KV, T, HD] bf16, start/filled [B] int32;
// out [B, H, HD] bf16.
extern "C" int decode_attention_bf16(const void* q, const void* kc,
                                     const void* vc, const void* start,
                                     const void* filled, void* out, int B,
                                     int H, int KV, int T, int HD,
                                     void* stream) {
  Args a{};
  a.q = static_cast<const bf16*>(q); a.k = kc; a.v = vc;
  a.start = static_cast<const int*>(start);
  a.filled = static_cast<const int*>(filled);
  a.out = static_cast<bf16*>(out);
  a.H = H; a.KV = KV; a.T = T;
  return launch<false, false>(a, B, HD, stream);
}

// K7. k/v pools [>= N, KV, P, HD] bf16 (entries >= N of the table clamp to
// N - 1), table [B, nb] int32; logical slots [0, nb * P).
extern "C" int paged_decode_attention_bf16(const void* q, const void* kp,
                                           const void* vp, const void* table,
                                           const void* start,
                                           const void* filled, void* out,
                                           int B, int H, int KV, int N, int P,
                                           int nb, int HD, void* stream) {
  Args a{};
  a.q = static_cast<const bf16*>(q); a.k = kp; a.v = vp;
  a.table = static_cast<const int*>(table);
  a.start = static_cast<const int*>(start);
  a.filled = static_cast<const int*>(filled);
  a.out = static_cast<bf16*>(out);
  a.H = H; a.KV = KV; a.N = N; a.P = P; a.nb = nb;
  return launch<true, false>(a, B, HD, stream);
}

// K5. k/v int8 [B, KV, T, HD], scales bf16 [B, KV, T].
extern "C" int decode_attention_q8(const void* q, const void* kq,
                                   const void* ks, const void* vq,
                                   const void* vs, const void* start,
                                   const void* filled, void* out, int B, int H,
                                   int KV, int T, int HD, void* stream) {
  Args a{};
  a.q = static_cast<const bf16*>(q); a.k = kq; a.v = vq;
  a.ks = static_cast<const bf16*>(ks); a.vs = static_cast<const bf16*>(vs);
  a.start = static_cast<const int*>(start);
  a.filled = static_cast<const int*>(filled);
  a.out = static_cast<bf16*>(out);
  a.H = H; a.KV = KV; a.T = T;
  return launch<false, true>(a, B, HD, stream);
}

// K8. int8 pools [>= N, KV, P, HD], scale pools bf16 [>= N, KV, P].
extern "C" int paged_decode_attention_q8(const void* q, const void* kq,
                                         const void* ks, const void* vq,
                                         const void* vs, const void* table,
                                         const void* start, const void* filled,
                                         void* out, int B, int H, int KV,
                                         int N, int P, int nb, int HD,
                                         void* stream) {
  Args a{};
  a.q = static_cast<const bf16*>(q); a.k = kq; a.v = vq;
  a.ks = static_cast<const bf16*>(ks); a.vs = static_cast<const bf16*>(vs);
  a.table = static_cast<const int*>(table);
  a.start = static_cast<const int*>(start);
  a.filled = static_cast<const int*>(filled);
  a.out = static_cast<bf16*>(out);
  a.H = H; a.KV = KV; a.N = N; a.P = P; a.nb = nb;
  return launch<true, true>(a, B, HD, stream);
}

// K6. q [B, H, Tq, HD], k/v cache [B, KV, T, HD] bf16, start/fill [B] int32
// (candidate qi attends to [start, fill + qi + 1)); out [B, H, Tq, HD] bf16.
// Tq <= 8 and (H / KV) * Tq <= 64. Each row's keys are split over S <= 16
// blocks; `part` is f32 scratch of B * KV * S * R * (HD + 2) floats
// (R = H / KV * Tq) and a second kernel merges the partial states (at S = 1
// the merge divides by the one split's sum, as a direct write would).
extern "C" int decode_verify_attention_bf16(const void* q, const void* kc,
                                            const void* vc, const void* start,
                                            const void* fill, void* out,
                                            void* part, int B, int H, int KV,
                                            int T, int Tq, int S, int HD,
                                            void* stream) {
  VerifyArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(kc);
  a.v = static_cast<const bf16*>(vc);
  a.start = static_cast<const int*>(start);
  a.fill = static_cast<const int*>(fill);
  a.out = static_cast<bf16*>(out);
  a.part = static_cast<float*>(part);
  a.H = H; a.KV = KV; a.T = T; a.Tq = Tq; a.S = S;
  return launch_verify<false>(a, B, HD, stream);
}

// K9. k/v pools [>= N, KV, P, HD] bf16, table [B, nb] int32; logical slots
// [0, nb * P).
extern "C" int paged_decode_verify_attention_bf16(
    const void* q, const void* kp, const void* vp, const void* table,
    const void* start, const void* fill, void* out, void* part, int B, int H,
    int KV, int N, int P, int nb, int Tq, int S, int HD, void* stream) {
  VerifyArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(kp);
  a.v = static_cast<const bf16*>(vp);
  a.table = static_cast<const int*>(table);
  a.start = static_cast<const int*>(start);
  a.fill = static_cast<const int*>(fill);
  a.out = static_cast<bf16*>(out);
  a.part = static_cast<float*>(part);
  a.H = H; a.KV = KV; a.N = N; a.P = P; a.nb = nb; a.Tq = Tq; a.S = S;
  return launch_verify<true>(a, B, HD, stream);
}
