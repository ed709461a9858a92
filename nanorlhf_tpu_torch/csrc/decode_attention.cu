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
// below the ~295 flop/byte at which the tensor cores would be the limit. At
// the rollout's shapes the prefix is small (B=16, T_max=1510: ~12 MB, 3.6 us
// at 3.35 TB/s), so what a call costs is the longest dependent chain of one
// block, not bandwidth: one block per (kv head, row), walking its tiles in
// series with one V load in flight per lane, took 0.169 ms at B=16 and the
// same at B=32. The design therefore spends nothing on the tensor cores and
// everything on many short, parallel chains:
//   * the split: each row's window [start, filled) is cut into S contiguous
//     ranges of whole 32-key tiles (counted from start), one block each, on
//     a grid of (S, KV, B). S depends on the shape alone (B, KV and the SM
//     count: `decode_split_count`, the same rule as ops/decode_attention.py
//     `decode_split_count`), never on T_max, nb * P or a row's length, so
//     the four instances split alike and K7 returns K4's bits;
//   * the merge: the S blocks of one (row, kv head) are a thread-block
//     cluster (S <= 8, the portable cluster size), launched with
//     cudaLaunchKernelEx and a cluster attribute. Each block merges its
//     warps' partial states (m, l, acc) in shared memory; after
//     cluster.sync() the rank-0 block reads its peers' partials through
//     distributed shared memory (map_shared_rank) and merges them in f32, in
//     split order, and writes the output. No second kernel, no f32 scratch
//     in device memory, no atomics; a second cluster.sync() keeps each
//     peer's shared memory alive until rank 0 has read it;
//   * loads in flight: in a 32-key tile each lane scores one key, its K
//     row read as HD / 8 vectors issued together (16 bytes bf16, 8 int8),
//     and then issues the loads of its HD / 32 dims of all 32 V rows at
//     once (the loop is unrolled; a row past the range reads nothing and
//     holds zeros), so their latency runs under the softmax;
//   * short dependent chains: a tile's work is a few thousand instructions
//     a warp, and with a handful of warps on an SM what limits it is how
//     long each waits on the one before (a first version, with a branch on
//     G around each head, kept most of its time with its K/V loads taken
//     out: kernel_ab.py --ablate). So the G heads are
//     padded to 8 (zero query rows), no loop branches on G, and the eight
//     heads' chains interleave: the queries sit transposed in shared memory
//     (a dim's eight heads are two 16-byte reads), the warp's max and sum
//     reductions run for the eight heads side by side, and P goes through
//     shared memory by key (key j's eight weights are two broadcast reads)
//     instead of 32 x G shuffles. At G = 6 a third of the FFMAs are padding;
//     the chains, not the FFMA rate, set the time;
//   * 4 warps a block, taking the block's tiles round-robin: with the split
//     a block holds 1–6 tiles at the rollout's shapes (B=16: S=8, 192 keys
//     of a 1510-slot row; B=64: S=3), so more warps would idle, and 4 warps
//     keep three blocks on an SM (at most 168 registers a thread): the rule
//     fills 3 blocks x SMs.
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
// flash-decoding split). Still bytes-bound in
// principle: ~2 * R flops per cache byte against the ~295 at which the
// tensor cores would limit, so no wgmma. K9 is the same body with K7's
// slot address and the same S: on the same logical cache it returns K6's
// bits. Its key range is clamped to the table (nb * P): a row one token
// short of its page budget has candidates past the table, whose writes the
// model drops and whose outputs the sampler discards.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

typedef __nv_bfloat16 bf16;
namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 8;                    // verify body
constexpr int THREADS = WARPS * 32;
constexpr int DECODE_WARPS = 4;             // decode body (see the note above)
constexpr int DECODE_THREADS = DECODE_WARPS * 32;
constexpr int DECODE_BLOCKS_PER_SM = 3;     // what the split rule fills
constexpr int MAX_SPLITS = 8;               // decode splits: the portable cluster size
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
  int S;                // key-range splits per (row, kv head): the cluster size
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

// 8 consecutive bf16 of a K row (16 bytes) as floats
__device__ __forceinline__ void load8(const bf16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = __bfloat162float(h[e]);
}

// an aligned vector of N bytes, read in one load
template <int N> struct Vec;
template <> struct Vec<16> { typedef uint4 T; };
template <> struct Vec<8> { typedef uint2 T; };
template <> struct Vec<4> { typedef uint32_t T; };
template <> struct Vec<2> { typedef uint16_t T; };

// element e of a vector of E as a float
template <typename E, typename R>
__device__ __forceinline__ float elem(const R& r, int e) {
  return to_f(reinterpret_cast<const E*>(&r)[e]);
}

// One block per (split, kv head, row): the split-th range of whole 32-key
// tiles of the row's window, merged across the cluster of the row's S
// blocks (see the note above).
template <int HD, bool PAGED, bool Q8>
__global__ void __launch_bounds__(DECODE_THREADS, DECODE_BLOCKS_PER_SM)
decode_kernel(Args a) {
  typedef typename std::conditional<Q8, int8_t, bf16>::type E;
  constexpr int PER = HD / 32;  // output dims per lane
  typedef typename Vec<8 * sizeof(E)>::T KVec;    // 8 elements of a K row
  typedef typename Vec<PER * sizeof(E)>::T VVec;  // a lane's dims of a V row
  static_assert(DECODE_THREADS % HD == 0, "rank 0's merge covers HD dims a pass");
  // the queries transposed, [dim][head], heads G..7 zero: one dim's eight
  // heads are two 16-byte reads, and no loop below branches on G
  __shared__ __align__(16) float qt[HD][MAXG];
  __shared__ __align__(16) float p_tile[DECODE_WARPS][32][MAXG];  // a tile's P, by key
  __shared__ float part_m[DECODE_WARPS][MAXG];
  __shared__ float part_l[DECODE_WARPS][MAXG];
  __shared__ float part_acc[DECODE_WARPS][MAXG][HD];
  // the block's partial state, which the cluster's rank 0 reads
  __shared__ float blk_m[MAXG], blk_l[MAXG];
  __shared__ float blk_acc[MAXG][HD];
  __shared__ float split_w[MAX_SPLITS][MAXG];  // rank 0's merge weights
  __shared__ float merged_l[MAXG];
  __shared__ int tbl[PAGED ? MAX_NB : 1];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();  // == blockIdx.x
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int H = a.H, KV = a.KV;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // the G query rows are contiguous in q: one 16-byte load per thread
  for (int i = tid; i < MAXG * HD / 8; i += DECODE_THREADS) {
    const int g = i / (HD / 8), d0 = (i % (HD / 8)) * 8;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (g < G) u = *reinterpret_cast<const uint4*>(a.q + ((size_t)b * H + kvh * G + g) * HD + d0);
    const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) qt[d0 + e][g] = __bfloat162float(h[e]);
  }
  if constexpr (PAGED) {
    for (int i = tid; i < a.nb; i += DECODE_THREADS)
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

  // the row's window [s0, s1) in S ranges of whole 32-key tiles
  const int t_max = PAGED ? a.nb * a.P : a.T;
  const int s0 = max(a.start[b], 0);
  const int s1 = max(min(a.filled[b], t_max), s0);
  const int chunk = ((s1 - s0 + a.S - 1) / a.S + 31) / 32 * 32;
  const int lo = min(s0 + split * chunk, s1);
  const int hi = min(lo + chunk, s1);
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

  for (int t0 = lo + warp * 32; t0 < hi; t0 += DECODE_WARPS * 32) {
    // lane j scores key t0 + j against the eight heads; a key past the
    // range re-reads the last valid slot and weighs 0
    const int key = t0 + lane;
    const bool ok = key < hi;
    const size_t si = slot_index(min(key, hi - 1));
    KVec kv[HD / 8];
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) kv[c] = reinterpret_cast<const KVec*>(kc + si * HD)[c];
    float kscale = 1.f, vscale = 1.f;
    if constexpr (Q8) {
      kscale = __bfloat162float(a.ks[si]);
      vscale = __bfloat162float(a.vs[si]);
    }
    float s[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) s[g] = 0.f;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float kf = elem<E>(kv[c], e);
        const float4 q0 = *reinterpret_cast<const float4*>(&qt[8 * c + e][0]);
        const float4 q1 = *reinterpret_cast<const float4*>(&qt[8 * c + e][4]);
        s[0] += q0.x * kf; s[1] += q0.y * kf; s[2] += q0.z * kf; s[3] += q0.w * kf;
        s[4] += q1.x * kf; s[5] += q1.y * kf; s[6] += q1.z * kf; s[7] += q1.w * kf;
      }
    }
    // the 32 V rows: issued now, so their latency runs under the softmax;
    // rows past the range read nothing and hold zeros (their P is 0)
    VVec vv[32];
    const int last = hi - 1 - t0;  // keys t0 .. t0 + last are in the range
    if constexpr (PAGED) {
      int page_j = t0 / a.P, off_j = t0 % a.P;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        vv[j] = VVec{};
        if (j <= last) {
          vv[j] = *reinterpret_cast<const VVec*>(
              vc + (((size_t)tbl[page_j] * KV + kvh) * a.P + off_j) * HD + lane * PER);
          if (++off_j == a.P) {
            off_j = 0;
            ++page_j;
          }
        }
      }
    } else {
      // one base pointer: row j is an immediate offset from it
      const E* vrow = vc + (((size_t)b * KV + kvh) * a.T + t0) * HD + lane * PER;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        vv[j] = j <= last ? *reinterpret_cast<const VVec*>(vrow + j * HD) : VVec{};
    }
    // the online-softmax update, the eight heads' warp reductions
    // interleaved; the scores become the probabilities in place and the
    // maxima's registers carry the sums
    float red[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      s[g] = ok ? (Q8 ? s[g] * a.scale * kscale : s[g] * a.scale) : NEG_INF;
      red[g] = s[g];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g) red[g] = fmaxf(red[g], __shfl_xor_sync(0xffffffffu, red[g], o));
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      const float m_new = fmaxf(m[g], red[g]);
      const float alpha = __expf(m[g] - m_new);
      m[g] = m_new;
      l[g] *= alpha;
#pragma unroll
      for (int d = 0; d < PER; ++d) acc[g][d] *= alpha;
      s[g] = ok ? __expf(s[g] - m_new) : 0.f;
      red[g] = s[g];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g) red[g] += __shfl_xor_sync(0xffffffffu, red[g], o);
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      l[g] += red[g];
      if (Q8) s[g] *= vscale;  // the V scale folds into the probability
    }
    // P by key through shared memory: key j's eight weights are two
    // broadcast reads
    float4* pw = reinterpret_cast<float4*>(&p_tile[warp][lane][0]);
    pw[0] = make_float4(s[0], s[1], s[2], s[3]);
    pw[1] = make_float4(s[4], s[5], s[6], s[7]);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float vf[PER];
#pragma unroll
      for (int d = 0; d < PER; ++d) vf[d] = elem<E>(vv[j], d);
      const float4 p0 = *reinterpret_cast<const float4*>(&p_tile[warp][j][0]);
      const float4 p1 = *reinterpret_cast<const float4*>(&p_tile[warp][j][4]);
      const float pj[MAXG] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
#pragma unroll
        for (int d = 0; d < PER; ++d) acc[g][d] += pj[g] * vf[d];
      }
    }
    __syncwarp();  // the warp is done with p_tile before the next tile's
  }

  // the block's state: its warps' partial softmax states merged
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (lane == 0) {
      part_m[warp][g] = m[g];
      part_l[warp][g] = l[g];
    }
#pragma unroll
    for (int d = 0; d < PER; ++d) part_acc[warp][g][lane * PER + d] = acc[g][d];
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += DECODE_THREADS) {
    const int g = i / HD, d = i % HD;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < DECODE_WARPS; ++w) mx = fmaxf(mx, part_m[w][g]);
    float lsum = 0.f, acc_d = 0.f;
#pragma unroll
    for (int w = 0; w < DECODE_WARPS; ++w) {
      const float f = __expf(part_m[w][g] - mx);
      lsum += part_l[w][g] * f;
      acc_d += part_acc[w][g][d] * f;
    }
    blk_acc[g][d] = acc_d;
    if (d == 0) {
      blk_m[g] = mx;
      blk_l[g] = lsum;
    }
  }

  // the cluster's S states, merged by rank 0 in split order through
  // distributed shared memory. Every peer read is issued up front: each
  // thread's output dims of all heads, then the heads' (m, l), from which
  // the split weights exp(m_r - m) and the merged sum l come
  cluster.sync();
  if (split == 0) {
    constexpr int ROWS = DECODE_THREADS / HD;  // heads a pass covers
    constexpr int PASSES = MAXG / ROWS;
    const int d = tid % HD;
    float ar[PASSES][MAX_SPLITS];
#pragma unroll
    for (int pz = 0; pz < PASSES; ++pz) {
      const int g = pz * ROWS + tid / HD;
#pragma unroll
      for (int r = 0; r < MAX_SPLITS; ++r) {
        ar[pz][r] = 0.f;
        if (r < a.S && g < G) ar[pz][r] = *cluster.map_shared_rank(&blk_acc[g][d], r);
      }
    }
    if (tid < G) {
      const int g = tid;
      float mr[MAX_SPLITS], lr[MAX_SPLITS];
      float mx = NEG_INF;
#pragma unroll
      for (int r = 0; r < MAX_SPLITS; ++r) {
        if (r < a.S) {
          mr[r] = *cluster.map_shared_rank(&blk_m[g], r);
          lr[r] = *cluster.map_shared_rank(&blk_l[g], r);
          mx = fmaxf(mx, mr[r]);
        }
      }
      float lsum = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_SPLITS; ++r) {
        if (r < a.S) {
          const float f = __expf(mr[r] - mx);
          split_w[r][g] = f;
          lsum += lr[r] * f;
        }
      }
      merged_l[g] = fmaxf(lsum, 1e-30f);
    }
    __syncthreads();
#pragma unroll
    for (int pz = 0; pz < PASSES; ++pz) {
      const int g = pz * ROWS + tid / HD;
      if (g < G) {
        float o = 0.f;
#pragma unroll
        for (int r = 0; r < MAX_SPLITS; ++r) {
          if (r < a.S) o += ar[pz][r] * split_w[r][g];
        }
        a.out[((size_t)b * H + kvh * G + g) * HD + d] = __float2bfloat16(o / merged_l[g]);
      }
    }
  }
  cluster.sync();  // every peer's shared memory stays alive until rank 0 has read it
}

// the SMs of the current device (cached per device)
int sm_count() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms[dev];
}

// S, the key-range splits of each (row, kv head): the fewest that give
// one wave of DECODE_BLOCKS_PER_SM blocks on every SM, at most MAX_SPLITS;
// a function of (B, KV, SMs) only (ops/decode_attention.py
// `decode_split_count` is the same rule)
int split_count(int B, int KV, int sms) {
  return std::max(1, std::min(MAX_SPLITS, DECODE_BLOCKS_PER_SM * sms / (B * KV)));
}

template <int HD, bool PAGED, bool Q8>
int launch_decode(const Args& a, int B, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.S, a.KV, B);
  cfg.blockDim = dim3(DECODE_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, decode_kernel<HD, PAGED, Q8>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool PAGED, bool Q8>
int launch(Args a, int B, int HD, void* stream) {
  if (B <= 0 || a.KV <= 0 || a.H % a.KV != 0 || a.H / a.KV > MAXG)
    return (int)cudaErrorInvalidValue;
  if (PAGED && (a.P <= 0 || a.N <= 0 || a.nb <= 0 || a.nb > MAX_NB))
    return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  a.S = split_count(B, a.KV, sms);
  a.scale = (float)(1.0 / sqrt((double)HD));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (HD == 128) return launch_decode<128, PAGED, Q8>(a, B, s);
  if (HD == 64) return launch_decode<64, PAGED, Q8>(a, B, s);
  return (int)cudaErrorInvalidValue;
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

// S, the key-range splits (cluster size) the four decode entries use for
// a batch of B rows of KV kv heads on the current device; < 0 on error.
extern "C" int decode_split_count(int B, int KV) {
  const int sms = sm_count();
  if (B <= 0 || KV <= 0 || sms <= 0) return -1;
  return split_count(B, KV, sms);
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
