// Fused hidden→logprob (linear cross-entropy forward) for Hopper (sm_90a):
// warpgroup MMA (wgmma) with register accumulators, TMA loads into an
// mbarrier ring fed by a producer warp, the online logsumexp on the
// accumulator registers.
//
// Replaces the Pallas kernel nanorlhf_tpu/ops/fused_logprob.py:228
// `_fused_kernel` (driver `_pallas_forward`, :307). Same function: per row,
// z = h · W / T computed inside the kernel (f32 sums, scaled by 1/T in f32),
// a vocab-blocked online logsumexp with the tail masked at V, the label
// logit gathered (exactly one column matches across all vocab tiles), and,
// only in the ENTROPY instances, the entropy via the unnormalised
// Σ exp(z − m)·z; the [rows, V] logits never reach device memory. W is read
// in either layout without a transposed copy: the tied embedding [V, D]
// (`transposed`, the main path: wgmma's B K-major) or [D, V] (B MN-major).
//
// What bounds it on this card: operations. At the scoring shape (R =
// 16·1500 rows, D = 1536, V = 151936) the product is 11.2 TFLOP (11.3 ms at
// 989 TFLOP/s) against 0.54 GB of W and h (0.16 ms at 3.35 TB/s), so only
// the tensor cores at a high share of their rate can carry it. The design
// is a GEMM main loop of the usual Hopper shape with the softmax folded into
// its epilogue:
//   1. one block per (128-row tile, vocab split): a producer warpgroup whose
//      one thread streams TMA loads, and two consumer warpgroups that own 64
//      rows each of a 128 x 256 output tile (wgmma m64n256k16, 128 f32
//      accumulators a thread). `setmaxnreg` gives the consumers 232
//      registers, the producer 40. 384 threads, one block per SM;
//   2. the h tile [128 x 64] and the W tile [256 x 64] of each 64-deep step
//      arrive by TMA (2-D maps, 128-byte swizzle: the layout wgmma reads)
//      into a 4-stage ring of full/empty mbarriers (48 KB a stage), so the
//      loads of the next steps — and of the next vocab tile, during this
//      tile's epilogue — run under the products. Each consumer keeps one
//      wgmma group in flight and frees a stage when the group that read it
//      has retired. A box past R or V is zero-filled;
//   3. the epilogue runs on the accumulator registers: a row lives in one
//      quad of four threads (hopper_ptx.cuh), so its tile maximum takes two
//      quad shuffles; the logits are scaled to log2 units (one FMUL, one
//      ex2 a logit), masked past V in the last tile only, and each thread
//      keeps its share of the row sums l (and u), rescaled by the same α in
//      the four threads and added across the quad once at the end, as K1
//      does. The label compare runs only in the thread whose columns hold
//      the label (one quad member, one vocab tile a row). No shared-memory
//      C tile, no spill;
//   4. split and merge: a row tile's 594 vocab tiles (at V = 151936) are
//      cut into `splits` ranges of whole tiles, one block each; each block
//      writes its rows' partial (m, l, g, u) and a second kernel merges them
//      (M = max m_s, L = Σ l_s·e^{m_s−M}, U = Σ u_s·e^{m_s−M}, G = Σ g_s).
//      `splits` is a function of (R, V, SMs) only (`split_count`, the same
//      rule as ops/fused_logprob.py `fused_logprob_split_count`): the count
//      whose waves of one block an SM make the shortest schedule, a block's
//      fixed cost taken as 1/8 of a tile;
//   5. block order: row tiles fastest inside groups of GROUP_ROWS row tiles.
//      The 132 blocks in flight then cover about 32 row tiles × 4 splits:
//      they share each W tile in L2 (the 32 blocks of a split walk the same
//      W tiles in step) and their h tiles (32 × 393 KB) stay in L2 while
//      they are re-read for every vocab tile. Row tiles fastest across the
//      whole grid would put 132 h tiles (52 MB, more than the 50 MB L2) in
//      flight and stream them from device memory for every vocab tile.
//
// Not done (PERF.md §7): a persistent tile scheduler (one block an SM walking
// tiles, so one tile's epilogue overlaps the next tile's products), TMA
// multicast of W across a cluster, ping-pong of the two consumer warpgroups.

#include "hopper_ptx.cuh"  // mbarrier, TMA, wgmma and tensor-map helpers

namespace {

constexpr int BM = 128;            // rows of a block's tile (two consumer warpgroups)
constexpr int BN = 256;            // vocab columns of a tile
constexpr int BK = 64;             // depth of a step: one 128-byte swizzle row
constexpr int STAGES = 4;          // depth of the TMA ring
constexpr int WG = 128;            // threads of a warpgroup
constexpr int THREADS = 3 * WG;    // producer warpgroup + two consumer warpgroups
constexpr int GROUP_ROWS = 32;     // row tiles of a raster group (note 5 above)
constexpr int CHUNK = 64 * 128;    // a 64-row x 128-byte swizzled box
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int BARS = STAGES * STAGE_BYTES;
constexpr int SMEM_BYTES = BARS + 2 * STAGES * 8 + 1024;  // + alignment
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_INF_L2 = NEG_INF * LOG2E;

template <bool TRANSPOSED, bool ENTROPY>
__global__ void __launch_bounds__(THREADS, 1)
fused_partial_kernel(const __grid_constant__ CUtensorMap tm_h,
                     const __grid_constant__ CUtensorMap tm_w,
                     const int* __restrict__ labels, float* __restrict__ part,
                     int R, int V, int n_k, int splits, int tiles_per_split,
                     float inv_temp) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + BARS);
  uint64_t* empty = full + STAGES;

  // block -> (row tile, split): row tiles fastest inside a group
  const int n_rt = (R + BM - 1) / BM;
  const int per_group = GROUP_ROWS * splits;
  const int group = blockIdx.x / per_group;
  const int in_group = blockIdx.x % per_group;
  const int rows_here = min(GROUP_ROWS, n_rt - group * GROUP_ROWS);
  const int row0 = (group * GROUP_ROWS + in_group % rows_here) * BM;
  const int split = in_group / rows_here;
  const int n_vt = (V + BN - 1) / BN;
  const int vt_begin = split * tiles_per_split;
  const int vt_end = min(n_vt, vt_begin + tiles_per_split);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < WG) {
    // producer warpgroup: one thread streams the h and W tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      int it = 0;
      for (int vt = vt_begin; vt < vt_end; ++vt) {
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], STAGE_BYTES);
          unsigned char* st = sm + s * STAGE_BYTES;
          tma_2d(st, &tm_h, &full[s], kt * BK, row0);
          if (TRANSPOSED) {
            tma_2d(st + A_BYTES, &tm_w, &full[s], kt * BK, vt * BN);
          } else {
#pragma unroll
            for (int c = 0; c < BN / 64; ++c)
              tma_2d(st + A_BYTES + c * CHUNK, &tm_w, &full[s], vt * BN + 64 * c, kt * BK);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = tid / WG - 1;  // consumer warpgroup: rows [64·cw, 64·cw + 64)
    const int ct = tid % WG;
    const int c2 = 2 * (ct % 4);
    const float scale_l2 = inv_temp * LOG2E;
    int row[2], lab[2];
    // per row h (r and r + 8): running max (log2 units, the same in the
    // quad), this thread's shares of l and u (log2 units), the label logit
    float m[2], l[2], u[2], g[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[h] = row0 + 64 * cw + 16 * (ct / 32) + (ct % 32) / 4 + 8 * h;
      lab[h] = row[h] < R ? labels[row[h]] : -1;
      m[h] = NEG_INF_L2;
      l[h] = u[h] = g[h] = 0.f;
    }

    float acc[128];
    int it = 0;
    for (int vt = vt_begin; vt < vt_end; ++vt) {
      const int v0 = vt * BN;
      for (int kt = 0; kt < n_k; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const unsigned char* at = sm + s * STAGE_BYTES + cw * CHUNK;
        const unsigned char* bt = sm + s * STAGE_BYTES + A_BYTES;
        fence_regs(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t db = TRANSPOSED ? desc(bt + kk * 32, 16, 1024)
                                         : desc_mnmajor(bt, kk);
          mma_ss_n256<TRANSPOSED ? 0 : 1>(acc, desc(at + kk * 32, 16, 1024), db,
                                           kt > 0 || kk > 0);
        }
        wg_commit();
        wg_wait<1>();  // the previous step's group has read its stage
        fence_regs(acc);
        if (kt > 0) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      wg_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[(it - 1) % STAGES]);

      // the label's logit, only in the thread whose columns hold it;
      // thread columns are v0 + 8j + c2 + e, acc[4j + 2h + e] in row h
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rel = lab[h] - v0 - c2;
        if ((unsigned)rel < (unsigned)BN && (rel & 6) == 0) {
          const bool live = v0 + c2 + rel < V;  // masked past V, as the logits are
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (rel == 8 * j + e) g[h] += live ? acc[4 * j + 2 * h + e] * inv_temp : NEG_INF;
            }
          }
        }
      }

      // logits in log2 units, masked past V (the last tile only)
      const bool tail = v0 + BN > V;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = acc[4 * j + i] * scale_l2;
          if (tail && v0 + 8 * j + c2 + (i & 1) >= V) x = NEG_INF_L2;
          acc[4 * j + i] = x;
          mx[i >> 1] = fmaxf(mx[i >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        alpha[h] = exp2_approx(m[h] - mx[h]);
        m[h] = mx[h];
      }
      // four independent chains of sums (row h, column parity e)
      float ps[4] = {0.f, 0.f, 0.f, 0.f}, pz[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = exp2_approx(acc[4 * j + i] - m[i >> 1]);
          ps[i] += p;
          if (ENTROPY) pz[i] += p * acc[4 * j + i];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float sum = ps[2 * h] + ps[2 * h + 1];
        l[h] = l[h] * alpha[h] + sum;
        if (ENTROPY) u[h] = u[h] * alpha[h] + (pz[2 * h] + pz[2 * h + 1]);
      }
    }

    // the quad's shares, then the partial state in natural units
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], o);
        g[h] += __shfl_xor_sync(0xffffffffu, g[h], o);
        if (ENTROPY) u[h] += __shfl_xor_sync(0xffffffffu, u[h], o);
      }
      if (c2 == 0 && row[h] < R) {
        *reinterpret_cast<float4*>(part + ((size_t)split * R + row[h]) * 4) =
            make_float4(m[h] * LN2, l[h], g[h], u[h] * LN2);
      }
    }
  }
}

__global__ void fused_merge_kernel(const float* __restrict__ part, float* __restrict__ lp,
                             float* __restrict__ ent, int R, int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= R) return;
  float M = NEG_INF;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, part[((size_t)s * R + row) * 4]);
  float Lsum = 0.f, G = 0.f, U = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float4 p = *reinterpret_cast<const float4*>(part + ((size_t)s * R + row) * 4);
    const float f = expf(p.x - M);
    Lsum += p.y * f;
    G += p.z;
    U += p.w * f;
  }
  const float l = fmaxf(Lsum, 1e-30f);
  const float lse = M + logf(l);
  lp[row] = G - lse;
  if (ent != nullptr) ent[row] = lse - U / l;
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

// the vocab splits: the count whose waves of one block an SM give the
// shortest schedule, in tile units with a block's fixed cost taken as 1/8
// of a tile, the fewest splits among equals (ops/fused_logprob.py
// `fused_logprob_split_count` is the same rule)
int split_count(int R, int V, int sms) {
  const long n_rt = (R + BM - 1) / BM;
  const long n_vt = (V + BN - 1) / BN;
  int best = 1;
  long best_cost = -1;
  for (long s = 1; s <= n_vt; ++s) {
    const long tiles = (n_vt + s - 1) / s;
    const long waves = (n_rt * s + sms - 1) / sms;
    const long cost = waves * (8 * tiles + 1);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = (int)s;
    }
  }
  return best;
}

template <bool TRANSPOSED, bool ENTROPY>
int launch_partial(const CUtensorMap& th, const CUtensorMap& tw, const void* labels,
                   void* part, int R, int V, int n_k, int splits, float inv_temp,
                   cudaStream_t stream) {
  auto kernel = fused_partial_kernel<TRANSPOSED, ENTROPY>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int n_rt = (R + BM - 1) / BM;
  const int n_vt = (V + BN - 1) / BN;
  kernel<<<n_rt * splits, THREADS, SMEM_BYTES, stream>>>(
      th, tw, static_cast<const int*>(labels), static_cast<float*>(part), R, V, n_k,
      splits, (n_vt + splits - 1) / splits, inv_temp);
  return (int)cudaGetLastError();
}

}  // namespace

// The vocab splits fused_logprob_bf16 uses for R rows over a vocab of V on
// the current device; < 0 on error.
extern "C" int fused_logprob_split_count(int R, int V) {
  const int sms = sm_count();
  if (R <= 0 || V <= 0 || sms <= 0) return -1;
  return split_count(R, V, sms);
}

// h [R, D] bf16; w [D, V] bf16, or [V, D] when `transposed` (bases 16-byte
// aligned); labels [R] int32; part [fused_logprob_split_count(R, V), R, 4]
// f32 scratch; lp [R] f32; ent [R] f32 or null (null = no entropy work at
// all). D % 64 == 0; V % 8 == 0 when not transposed. Returns the CUDA error
// code of the launches.
extern "C" int fused_logprob_bf16(const void* h, const void* w, const void* labels,
                                  void* part, void* lp, void* ent, int R, int D,
                                  int V, int transposed, float inv_temp,
                                  void* stream) {
  if (R <= 0 || V <= 0 || D <= 0 || D % BK != 0) return (int)cudaErrorInvalidValue;
  if (!transposed && V % 8 != 0) return (int)cudaErrorInvalidValue;
  if (encoder() == nullptr) return (int)cudaErrorSymbolNotFound;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int splits = split_count(R, V, sms);
  CUtensorMap th, tw;
  const bool ok = map_2d(&th, h, D, R, BK, BM) &&
                  (transposed ? map_2d(&tw, w, D, V, BK, BN) : map_2d(&tw, w, V, D, 64, BK));
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_k = D / BK;
  const bool entropy = ent != nullptr;
  int err;
  if (transposed) {
    err = entropy ? launch_partial<true, true>(th, tw, labels, part, R, V, n_k, splits, inv_temp, s)
                  : launch_partial<true, false>(th, tw, labels, part, R, V, n_k, splits, inv_temp, s);
  } else {
    err = entropy ? launch_partial<false, true>(th, tw, labels, part, R, V, n_k, splits, inv_temp, s)
                  : launch_partial<false, false>(th, tw, labels, part, R, V, n_k, splits, inv_temp, s);
  }
  if (err != 0) return err;
  fused_merge_kernel<<<(R + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(lp),
      static_cast<float*>(ent), R, splits);
  return (int)cudaGetLastError();
}
