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
// q [B, H, Tq, HD] holds Tq candidate queries per head: Tq = spec_k + 1 in
// speculative decode, up to the prompt width for the serving path's suffix
// prefill and prefill chunks (no cap: nothing in the body is sized by Tq).
// Row r of kv head kvh is query head kvh * G + r / Tq at candidate
// qi = r % Tq (JAX's row order); it attends to logical slots
// start <= t < fill + qi + 1 (the candidates' K/V are already written at
// [fill, fill + Tq)). A block holds up to 32 such rows (R = G * Tq = 30 at
// G = 6, spec_k = 4; a kv head with more takes ceil(R / 32) row groups, one
// block each: 96 at G = 6, Tq = 512, each reading the row's whole key
// range, the bound `hi` masking what its rows do not see), and that many
// rows make the products worth the tensor cores: mma.sync m16n8k16 (bf16
// in, f32 sums) on two m16 row tiles, where wgmma's m64 would be more than
// half padding. The design:
//   * the queries load once into shared memory, read as m16k16 A
//     fragments by ldmatrix (held in registers beside the O sums and the
//     two-part P below they spilled at HD = 128). Per
//     16-key tile, S = Q·Kᵀ (K read by ldmatrix), the online softmax on the
//     S fragments (a row lives in one quad: two quad shuffles a row a tile;
//     each thread keeps its share of the row sum l, as the flash kernels
//     do), then O += P·V with the S fragments as P's A fragments, V read by
//     ldmatrix.trans. P goes in as two bf16 parts, its rounding and what
//     the rounding left out: one bf16 P is off by up to 2^-9 of each term,
//     which at an output near cancellation is many bf16 ulps, and the
//     kernel is held to one. The second product costs what the card has to
//     spare: the work is bytes, not operations;
//   * warps split the keys, not the rows: each of the 4 warps takes the
//     block's 16-key tiles round-robin through its own 3-stage cp.async
//     ring (keys past the range zero-filled), so each K/V byte is read once
//     from device memory and once from shared memory, with two tiles a warp
//     in flight behind the one in use;
//   * each row is masked at its own bound; a row with an empty window
//     returns zeros;
//   * the split and the merge: each row's window is cut into S ranges of
//     whole 16-key tiles, one block each, S from (B, KV, SMs) only
//     (`verify_split_count`, at most 8, the portable cluster size). A
//     block's warps merge their (m, l, O) in shared memory, and the S
//     blocks of a (row, kv head, row group) form a cluster whose rank 0
//     merges theirs through distributed shared memory, in split order, and
//     writes the output: one launch, no f32 scratch in device memory;
//   * two blocks fit an SM: 4 warps with 102 KB of rings at HD = 128, and
//     at most 255 registers a thread (the O sums of 32 rows x HD take 128
//     at HD = 128); the split rule fills one a SM, which measured faster.
// Bytes-bound in principle (~2 * R flops per cache byte against the ~295 at
// which the tensor cores would limit). K9 is the same body with K7's slot
// address and the same S: on the same logical cache it returns K6's bits.
// Its key range is clamped to the table (nb * P): a row one token short of
// its page budget has candidates past the table, whose writes the model
// drops and whose outputs the sampler discards.

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

constexpr int DECODE_WARPS = 4;             // decode body (see the note above)
constexpr int DECODE_THREADS = DECODE_WARPS * 32;
constexpr int DECODE_BLOCKS_PER_SM = 3;     // what the split rule fills
constexpr int MAX_SPLITS = 8;               // decode splits: the portable cluster size
constexpr int MAXG = 8;     // query heads per kv head handled by one block
constexpr int MAX_NB = 1024;  // block-table entries per row (paged)
constexpr float NEG_INF = -1e30f;
constexpr float NEG_INF_L2 = NEG_INF * 1.4426950408889634f;  // NEG_INF in log2 units

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

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

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

constexpr int VWARPS = 4;               // warps of a verify block
constexpr int VTHREADS = VWARPS * 32;
constexpr int VBLOCKS_PER_SM = 2;       // resident blocks an SM the registers allow
constexpr int VSPLIT_BLOCKS_PER_SM = 1; // what the split rule fills
constexpr int VT = 16;                  // keys of a warp's step: one k16 slice of P·V
constexpr int VSTAGES = 3;              // a warp's ring of K/V step tiles
constexpr int VROWS = 32;               // query rows of a block: two m16 tiles
constexpr int VMAX_SPLITS = 8;          // key-range splits: the portable cluster size

struct VerifyArgs {
  const bf16* q;      // [B, H, Tq, HD]
  const bf16* k;      // contiguous [B, KV, T, HD] or pool [N+, KV, P, HD]
  const bf16* v;
  const int* table;   // paged only: [B, nb]
  const int* start;   // [B]
  const int* fill;    // [B]: the slot of candidate 0
  bf16* out;          // [B, H, Tq, HD]
  int H, KV, T, N, P, nb, Tq, S;
  int n_rg;           // row groups of VROWS rows per (row, kv head)
  float scale_l2;     // 1 / sqrt(HD) in log2 units
};

// shared memory of a verify block: each warp's ring of K and V step tiles
// [VSTAGES][VT][HD + 8] bf16 (16 bytes of padding a row: the eight rows an
// ldmatrix reads fall on distinct banks), after the key loop the warps'
// partial states over the same bytes (O [VWARPS][VROWS][HD], m and l
// [VWARPS][VROWS] f32); then the block's queries [VROWS][HD + 8] bf16.
// Two blocks fit an SM (2 x 110.5 KB at HD = 128)
template <int HD>
struct VerifySmem {
  static constexpr int KROW = HD + 8;
  static constexpr int TILE = VT * KROW;                      // bf16
  static constexpr int WARP = 2 * VSTAGES * TILE * 2;         // bytes: K and V rings
  static constexpr int RING = VWARPS * WARP;
  static constexpr int MERGE = VWARPS * VROWS * (HD + 2) * 4;
  static_assert(MERGE <= RING, "the partial states go over the rings");
  static constexpr int BYTES = RING + VROWS * KROW * 2;
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// d += A·B, m16n8k16, bf16 in, f32 sums (A row-major, B column-major)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float vexp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (lo, hi) f32 -> the bf16x2 of their rounding, and of what it left out
__device__ __forceinline__ void split_bf16(float lo, float hi, uint32_t& big, uint32_t& small) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  const float2 bf = __bfloat1622float2(b);
  const __nv_bfloat162 s = __floats2bfloat162_rn(lo - bf.x, hi - bf.y);
  big = *reinterpret_cast<const uint32_t*>(&b);
  small = *reinterpret_cast<const uint32_t*>(&s);
}

// One block per (split, kv head · row group, row), the S splits of a (row,
// kv head, row group) one cluster (see the header).
template <int HD, bool PAGED>
__global__ void __launch_bounds__(VTHREADS, VBLOCKS_PER_SM) verify_kernel(VerifyArgs a) {
  constexpr int KS = HD / 16;  // k16 slices of a query or key row
  constexpr int NT = HD / 8;   // n8 tiles of an output row
  using L = VerifySmem<HD>;
  constexpr int KROW = L::KROW;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float blk_m[VROWS], blk_l[VROWS];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();  // == blockIdx.x
  const int kvh = blockIdx.y / a.n_rg;
  const int rg = blockIdx.y % a.n_rg;
  const int b = blockIdx.z;
  const int KV = a.KV, Tq = a.Tq;
  const int G = a.H / KV;
  const int rows = min(VROWS, G * Tq - rg * VROWS);  // this block's query rows
  // rows r = g * Tq + qi of this kv head are contiguous in q and out
  const size_t qrow0 = ((size_t)b * a.H + (size_t)kvh * G) * Tq + (size_t)rg * VROWS;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int quad = lane / 4;
  const int c2 = 2 * (lane % 4);

  // a key's slot; the table is read where a key is (a sentinel entry
  // clamped to N - 1, as in K7)
  auto slot_index = [&](int t) -> size_t {
    if constexpr (PAGED) {
      const int page = min(max(__ldg(a.table + (size_t)b * a.nb + t / a.P), 0), a.N - 1);
      return ((size_t)page * KV + kvh) * a.P + (t % a.P);
    } else {
      return ((size_t)b * KV + kvh) * a.T + t;
    }
  };

  // the row's keys [start, min(fill + Tq, t_max)) are cut into S ranges of
  // whole VT-key tiles; this block takes range `split`, its warps the
  // range's tiles round-robin
  const int t_max = PAGED ? a.nb * a.P : a.T;
  const int fill = a.fill[b];
  const int r0 = max(a.start[b], 0);
  const int r1 = max(min(fill + Tq, t_max), r0);
  const int chunk = ((r1 - r0 + a.S - 1) / a.S + VT - 1) / VT * VT;
  const int s0 = min(r0 + split * chunk, r1);
  const int s1 = min(s0 + chunk, r1);  // one past the last key of this block
  const int n_tiles = (s1 - s0 + VT - 1) / VT;
  const int steps = n_tiles > warp ? (n_tiles - warp + VWARPS - 1) / VWARPS : 0;

  // the block's queries, once into shared memory (rows past the block's
  // are zeros), read as m16k16 A fragments by ldmatrix at each tile: with
  // P in two parts, registers do not hold them beside the O sums (at HD =
  // 128 the fragments held in registers took the kernel to 255 registers
  // and a spill). Each row's key bound: candidate qi reads keys below
  // fill + qi + 1 (rows past the block's read none). Thread rows: 16·mt +
  // 8·h + quad
  bf16* qs = reinterpret_cast<bf16*>(smem + L::RING);
  for (int i = tid; i < VROWS * (HD / 8); i += VTHREADS) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    *reinterpret_cast<uint4*>(qs + r * KROW + c) =
        r < rows ? __ldg(reinterpret_cast<const uint4*>(a.q + (qrow0 + r) * HD + c))
                 : make_uint4(0u, 0u, 0u, 0u);
  }
  int hi[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * mt + 8 * h + quad;
      const int qi = (rg * VROWS + r) % Tq;
      hi[mt][h] = r < rows ? min(fill + qi + 1, s1) : -1;
    }
  }
  __syncthreads();

  // this warp's ring: step i of the warp reads tile warp + i·VWARPS; keys
  // past s1 are zero-filled (their scores are masked, their zero V rows
  // add nothing)
  bf16* kring = reinterpret_cast<bf16*>(smem + warp * L::WARP);
  bf16* vring = kring + VSTAGES * L::TILE;
  auto load_step = [&](int i) {
    if (i < steps) {
      const int t0 = s0 + (warp + i * VWARPS) * VT;
      const int buf = i % VSTAGES;
#pragma unroll
      for (int c = lane; c < VT * (HD / 8); c += 32) {
        const int kk = c / (HD / 8), off = (c % (HD / 8)) * 8;
        const bool in = t0 + kk < s1;
        const size_t si = in ? slot_index(t0 + kk) * HD + off : 0;
        cp_async16(kring + (buf * VT + kk) * KROW + off, a.k + si, in);
        cp_async16(vring + (buf * VT + kk) * KROW + off, a.v + si, in);
      }
    }
    cp_async_commit();  // an empty group keeps the count of groups in flight right
  };

  float o[2][NT][4];
  float m[2][2], l[2][2];  // running max (log2 units, the same in the quad), l share
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[mt][h] = NEG_INF_L2;
      l[mt][h] = 0.f;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][nt][e] = 0.f;
  }

#pragma unroll
  for (int i = 0; i < VSTAGES - 1; ++i) load_step(i);
  for (int i = 0; i < steps; ++i) {
    load_step(i + VSTAGES - 1);
    cp_async_wait<VSTAGES - 1>();
    __syncwarp();
    const bf16* kb = kring + (i % VSTAGES) * L::TILE;
    const bf16* vb = vring + (i % VSTAGES) * L::TILE;
    const int t0 = s0 + (warp + i * VWARPS) * VT;

    // S = Q·Kᵀ over the tile's 16 keys (two n8 tiles)
    float s[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t kf[4];  // keys 0-7 and 8-15, depth 16kk + {0..7, 8..15}
      ldmatrix_x4(kf, kb + ((lane / 16) * 8 + lane % 8) * KROW + 16 * kk + ((lane / 8) % 2) * 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t qf[4];  // rows 16mt + {0..7, 8..15}, depth 16kk + {0..7, 8..15}
        ldmatrix_x4(qf, qs + (16 * mt + ((lane / 8) % 2) * 8 + lane % 8) * KROW + 16 * kk +
                            (lane / 16) * 8);
        mma16816(s[mt][0], qf, kf[0], kf[1]);
        mma16816(s[mt][1], qf, kf[2], kf[3]);
      }
    }

    // the online softmax on the fragments, each row at its own bound;
    // P = exp2(S − m) is fed to P·V as two bf16 parts (its rounding and
    // what the rounding left out): one bf16 P is off by up to 2^-9 of each
    // term, more than one bf16 ulp of an output near cancellation
    uint32_t pb[2][4], ps[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = m[mt][h];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool ok = t0 + 8 * nt + c2 + e < hi[mt][h];
            float& x = s[mt][nt][2 * h + e];
            x = ok ? x * a.scale_l2 : NEG_INF_L2;
            mx = fmaxf(mx, x);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float alpha = vexp2(m[mt][h] - mx);
        m[mt][h] = mx;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool ok = t0 + 8 * nt + c2 + e < hi[mt][h];
            float& x = s[mt][nt][2 * h + e];
            x = ok ? vexp2(x - mx) : 0.f;
            sum += x;
          }
        }
        l[mt][h] = alpha * l[mt][h] + sum;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          o[mt][nt][2 * h] *= alpha;
          o[mt][nt][2 * h + 1] *= alpha;
        }
      }
      // the m16n8 sums of S are the m16k16 A fragments of P
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          split_bf16(s[mt][nt][2 * h], s[mt][nt][2 * h + 1], pb[mt][2 * nt + h],
                     ps[mt][2 * nt + h]);
      }
    }

    // O += P·V, V read transposed by ldmatrix (two n8 tiles of HD a load)
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t vf[4];  // keys 0-7 and 8-15 of columns 16np + {0..7}, then + {8..15}
      ldmatrix_x4_trans(vf, vb + (((lane / 8) % 2) * 8 + lane % 8) * KROW + 16 * np + (lane / 16) * 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma16816(o[mt][2 * np], pb[mt], vf[0], vf[1]);
        mma16816(o[mt][2 * np], ps[mt], vf[0], vf[1]);
        mma16816(o[mt][2 * np + 1], pb[mt], vf[2], vf[3]);
        mma16816(o[mt][2 * np + 1], ps[mt], vf[2], vf[3]);
      }
    }
    __syncwarp();  // every lane is done with this slot before it is refilled
  }
  cp_async_wait<0>();

  // the block's merge: each warp's (m, l, O) into shared memory (over its
  // ring: every warp must be done with its loads first), then per (row,
  // dim) over the warps in order; the block's O goes over warp 0's (each
  // element is read and written by one thread), its m and l to blk_*
  __syncthreads();
  float* wO = reinterpret_cast<float*>(smem);   // [VWARPS][VROWS][HD]
  float* wm = wO + VWARPS * VROWS * HD;          // [VWARPS][VROWS]
  float* wl = wm + VWARPS * VROWS;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * mt + 8 * h + quad;
      float lr = l[mt][h];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        *reinterpret_cast<float2*>(wO + (warp * VROWS + r) * HD + 8 * nt + c2) =
            make_float2(o[mt][nt][2 * h], o[mt][nt][2 * h + 1]);
      }
      if (c2 == 0) {
        wm[warp * VROWS + r] = m[mt][h];
        wl[warp * VROWS + r] = lr;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * HD; i += VTHREADS) {
    const int r = i / HD;
    float mx = NEG_INF_L2;
#pragma unroll
    for (int w = 0; w < VWARPS; ++w) mx = fmaxf(mx, wm[w * VROWS + r]);
    float lsum = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < VWARPS; ++w) {
      const float f = vexp2(wm[w * VROWS + r] - mx);
      lsum += wl[w * VROWS + r] * f;
      acc += wO[w * VROWS * HD + i] * f;
    }
    wO[i] = acc;
    if (i % HD == 0) {
      blk_m[r] = mx;
      blk_l[r] = lsum;
    }
  }

  // the cluster's S states, merged by rank 0 in split order through
  // distributed shared memory; a second cluster.sync() keeps each peer's
  // shared memory alive until rank 0 has read it
  cluster.sync();
  if (split == 0) {
    for (int i = tid; i < rows * HD; i += VTHREADS) {
      const int r = i / HD;
      float mr[VMAX_SPLITS];
      float mx = NEG_INF_L2;
#pragma unroll
      for (int z = 0; z < VMAX_SPLITS; ++z) {
        if (z < a.S) {
          mr[z] = *cluster.map_shared_rank(&blk_m[r], z);
          mx = fmaxf(mx, mr[z]);
        }
      }
      float lsum = 0.f, acc = 0.f;
#pragma unroll
      for (int z = 0; z < VMAX_SPLITS; ++z) {
        if (z < a.S) {
          const float f = vexp2(mr[z] - mx);
          lsum += *cluster.map_shared_rank(&blk_l[r], z) * f;
          acc += *cluster.map_shared_rank(wO + i, z) * f;
        }
      }
      a.out[qrow0 * HD + i] = __float2bfloat16(acc / fmaxf(lsum, 1e-30f));
    }
  }
  cluster.sync();
}

// S, the key-range splits of each (row, kv head): the most that fit one
// wave of VSPLIT_BLOCKS_PER_SM blocks on every SM, at most VMAX_SPLITS; a
// function of (B, KV, SMs) only (ops/decode_attention.py
// `verify_split_count` is the same rule), so K6 and K9 split alike. One
// block an SM, not the two that fit: `kernel_ab.py --ablate K6` read it 5%
// faster at B = 64 (S = 1), 32% at B = 32 and 43% at B = 16, and K9 38%
// faster at B = 32 (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6)
int verify_split_count(int B, int KV, int sms) {
  return std::max(1, std::min(VMAX_SPLITS, VSPLIT_BLOCKS_PER_SM * sms / (B * KV)));
}

// the verify instance's dynamic shared memory limit, set once per device
// (cached as `sms[]` is): the launch itself then enqueues only stream work,
// which a CUDA-graph capture of the decode loop records
template <int HD, bool PAGED>
cudaError_t verify_smem_attribute(int bytes) {
  static bool set[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!set[dev]) {
    e = cudaFuncSetAttribute(verify_kernel<HD, PAGED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    set[dev] = true;
  }
  return cudaSuccess;
}

template <int HD, bool PAGED>
int launch_verify_hd(const VerifyArgs& a, int B, cudaStream_t s) {
  const int bytes = VerifySmem<HD>::BYTES;
  const cudaError_t e = verify_smem_attribute<HD, PAGED>(bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.S, a.KV * a.n_rg, B);
  cfg.blockDim = dim3(VTHREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, verify_kernel<HD, PAGED>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool PAGED>
int launch_verify(VerifyArgs a, int B, int HD, void* stream) {
  if (B <= 0 || a.KV <= 0 || a.H % a.KV != 0 || a.H / a.KV > MAXG || a.Tq < 1)
    return (int)cudaErrorInvalidValue;
  if (PAGED && (a.P <= 0 || a.N <= 0 || a.nb <= 0 || a.nb > MAX_NB))
    return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  a.S = verify_split_count(B, a.KV, sms);
  a.n_rg = (a.H / a.KV * a.Tq + VROWS - 1) / VROWS;
  // gridDim.y = KV * n_rg (384 at KV = 2, G = 6, Tq = 1024) and gridDim.z = B
  // stay within the launch's 65535
  if ((long long)a.KV * a.n_rg > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  a.scale_l2 = (float)(1.4426950408889634 / sqrt((double)HD));
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

// S, the key-range splits (cluster size) the two verify entries use for a
// batch of B rows of KV kv heads on the current device; < 0 on error.
extern "C" int decode_verify_split_count(int B, int KV) {
  const int sms = sm_count();
  if (B <= 0 || KV <= 0 || sms <= 0) return -1;
  return verify_split_count(B, KV, sms);
}

// K6. q [B, H, Tq, HD], k/v cache [B, KV, T, HD] bf16, start/fill [B] int32
// (candidate qi attends to [start, fill + qi + 1)); out [B, H, Tq, HD] bf16.
// any Tq >= 1, H / KV <= 8. Each row's keys are split over the S blocks of a
// cluster (S = decode_verify_split_count(B, KV)), merged by its rank 0.
extern "C" int decode_verify_attention_bf16(const void* q, const void* kc,
                                            const void* vc, const void* start,
                                            const void* fill, void* out, int B,
                                            int H, int KV, int T, int Tq, int HD,
                                            void* stream) {
  VerifyArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(kc);
  a.v = static_cast<const bf16*>(vc);
  a.start = static_cast<const int*>(start);
  a.fill = static_cast<const int*>(fill);
  a.out = static_cast<bf16*>(out);
  a.H = H; a.KV = KV; a.T = T; a.Tq = Tq;
  return launch_verify<false>(a, B, HD, stream);
}

// K9. k/v pools [>= N, KV, P, HD] bf16, table [B, nb] int32; logical slots
// [0, nb * P).
extern "C" int paged_decode_verify_attention_bf16(
    const void* q, const void* kp, const void* vp, const void* table,
    const void* start, const void* fill, void* out, int B, int H, int KV, int N,
    int P, int nb, int Tq, int HD, void* stream) {
  VerifyArgs a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(kp);
  a.v = static_cast<const bf16*>(vp);
  a.table = static_cast<const int*>(table);
  a.start = static_cast<const int*>(start);
  a.fill = static_cast<const int*>(fill);
  a.out = static_cast<bf16*>(out);
  a.H = H; a.KV = KV; a.N = N; a.P = P; a.nb = nb; a.Tq = Tq;
  return launch_verify<true>(a, B, HD, stream);
}
