// One-read fused Gibbs sweep for the full-covariance Gaussian family:
// steps (e) + (f) of the restricted sampler and the sub-cluster statistic
// fold, on an NVIDIA Hopper card (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sweep.py:sweep_gauss
// (_sweep_gauss_kernel). What it computes, per point i with global index
// gidx[i]:
//   (e) z_i  = first argmax_k [ 0.5 (logdet_k - |F_k^T (x_i - mu_k)|^2)
//                               - 0.5 d log(2 pi) + logw_k  (-1e30 if the
//                               slot is inactive) + Gumbel(key_z, gidx_i,
//                               slots_k) ]
//   (f) zb_i = first argmax_s of the same form over the two sub-clusters
//              of cluster z_i, with Gumbel(key_zb, gidx_i, s)
//   and, per STATS_BLOCK of points, the (K, 2) partials n / sx / sxx over
//   segments 2 z + zb (block_stats.cuh).
//
// Design. The TPU grid (point blocks, phase, K tiles) ran in order and
// carried the running (max, argmax) from one K tile to the next in
// scratch. Here, above d = 16, step (e) is a launch of its own
// (sweep_assign_tiled, below): a register-tiled product over tiles of 128
// points, the x tile resident in shared memory and the active slots'
// factors streamed in row slabs through a cp.async ring (up to four slots
// side by side in a 128-column tile at d <= 32), |y|^2 finished in the
// parent layout's order, and the first max merged by (max, least slot).
// At d <= 16 one thread block owns one STATS_BLOCK and loops over K tiles
// of factors staged in shared memory (gauss_assign_narrow, assign_tile.cuh,
// shared with assign_gauss.cu). Then one thread block a STATS_BLOCK runs
// step (f) grouped by label: the block's points are sorted by their label,
// and each present label's two sub-factors are staged in shared memory
// once (a batch of labels at d <= 64), so a point reads its operands from
// shared memory and not through L1/L2. The stats of the block are then
// folded without float atomics (block_stats.cuh fold_segments), so the
// per-STATS_BLOCK partials are (nsb, K, 2, ...) and never the
// per-(point block, K block) layout of the TPU kernel. Every label,
// sub-label and partial has the bits of the first version (one thread a
// point for (e) and (f), one thread an entry for the fold): the same
// chains in the same order, whatever the grid.
//
// Layouts of step (f) (assign_tile.cuh): for d <= 64 a thread owns a point
// and keeps its d-vector in registers (template DP = d rounded up to a
// power of two, at least 4); for 64 < d <= 128 four lanes share a point,
// 32 output columns each, the point's row staged in shared memory.
//
// What bounds it. Step (e) is 2 N K d^2 FLOP of fp32 FMA over the K live
// slots (35 GFLOP at N = 1e6, K = 17, d = 32) against N d 4 B of x, so it
// is bound by the CUDA cores' fp32 rate, not by memory: about 0.5 ms at
// the H100 SXM's 67 TFLOP/s. The tiled product issues 64 FMAs for 4
// 16-byte shared loads and 8 subtractions; the fold writes S d^2 floats a
// STATS_BLOCK. Tensor cores (TF32 would change the bits) are not used.
//
// Limits: 1 <= d <= 128, 1 <= K <= 2048 (segment offsets live in shared
// memory).
#include <cuda_runtime.h>
#include <stdint.h>

#include "assign_tile.cuh"
#include "block_stats.cuh"
#include "threefry.cuh"

namespace repro_torch {

constexpr int SWEEP_THREADS = 256;

// Shared memory after the step-(e) tile: best, lab, seg, idx, w
// (STATS_BLOCK each), the segment offsets start (S + 1) and the sort's
// scratch (block_stats.cuh).
struct FoldSmem {
  float* best;
  int* lab;
  int* seg;
  int* idx;
  float* w;
  int* start;
  int* scratch;
  __device__ FoldSmem(float* base, int S) {
    best = base;
    lab = reinterpret_cast<int*>(best + STATS_BLOCK);
    seg = lab + STATS_BLOCK;
    idx = seg + STATS_BLOCK;
    w = reinterpret_cast<float*>(idx + STATS_BLOCK);
    start = reinterpret_cast<int*>(w + STATS_BLOCK);
    scratch = start + S + 1;
  }
};

__host__ inline size_t fold_smem_words(int K) {
  return 5 * (size_t)STATS_BLOCK + 2 * (size_t)K + 1 +
         sort_scratch_ints(2 * K);
}

// The stat fold of the block (block_stats.cuh fold_segments) once seg and w
// are set: tile edge E, 16-byte rows when vec.
template <int E>
__device__ __forceinline__ void sweep_fold(const float* __restrict__ xb,
                                           int d, int np, int S,
                                           const FoldSmem& fs, bool vec,
                                           float* n_out, float* sx_out,
                                           float* sxx_out) {
  if (vec)
    fold_segments<E, true>(xb, fs.w, d, np, S, fs.seg, fs.idx, fs.start,
                           fs.scratch, n_out, sx_out, sxx_out);
  else
    fold_segments<E, false>(xb, fs.w, d, np, S, fs.seg, fs.idx, fs.start,
                            fs.scratch, n_out, sx_out, sxx_out);
}

// Slots of the shared tile region: step (e)'s bk_max, and at least one
// label's two sub-factors for step (f).
__host__ __device__ inline int sweep_region_slots(int bk_max) {
  return bk_max < 2 ? 2 : bk_max;
}

// Step (f) grouped by label: sort the block's points by their step-(e)
// label (every point has one), and list the labels present in order:
// list[r] (written over best, dead after step (e)) the r-th present label,
// pos[l] (the sort's cursor ints, free after it) its rank. Returns the
// count of present labels.
__device__ int group_by_label(const FoldSmem& fs, int np, int K, int*& list,
                              int*& pos) {
  sort_segments_block(fs.lab, np, K, fs.start, fs.idx, fs.scratch,
                      [](const int*) {});
  pos = fs.scratch;                                   // K ints
  list = reinterpret_cast<int*>(fs.best);             // <= np ints
  for (int l = threadIdx.x; l < K; l += blockDim.x)
    pos[l] = fs.start[l + 1] > fs.start[l] ? 1 : 0;
  __syncthreads();
  const int nl = block_scan_excl(pos, K, fs.scratch + 2 * K);
  for (int l = threadIdx.x; l < K; l += blockDim.x)
    if (fs.start[l + 1] > fs.start[l]) list[pos[l]] = l;
  __syncthreads();
  return nl;
}

// Stage the two sub-components of labels list[0..nb) into slots 2 r + s of
// tile t (factors zero-padded to DP x DP, means to DP, sub_logdet in ld,
// sublogw in lw), between two barriers: the arithmetic of step (f) then
// reads its operands from shared memory, as step (e) does, with the bits of
// gauss_sub_narrow / gauss_sub_wide (a zero row or column adds exact
// zeros to a sum of squares).
template <int DP>
__device__ void stage_sub_labels(const GaussTile<DP>& t, const int* list,
                                 int nb, int d,
                                 const float* __restrict__ sub_mu,
                                 const float* __restrict__ sub_chol,
                                 const float* __restrict__ sub_logdet,
                                 const float* __restrict__ sublogw) {
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * nb; i += blockDim.x) {
    const size_t ks = 2 * (size_t)list[i >> 1] + (i & 1);
    t.ld[i] = sub_logdet[ks];
    t.lw[i] = sublogw[ks];
  }
  if ((d & 3) == 0 && ((uintptr_t)sub_chol & 15) == 0) {
    constexpr int Q = DP / 4;
    for (int i = threadIdx.x; i < 2 * nb * DP * Q; i += blockDim.x) {
      const int kk = i / (DP * Q), r = (i / Q) % DP, c = 4 * (i % Q);
      const size_t ks = 2 * (size_t)list[kk >> 1] + (kk & 1);
      *reinterpret_cast<float4*>(t.f + (size_t)kk * DP * DP + r * DP + c) =
          (r < d && c < d)
              ? __ldg(reinterpret_cast<const float4*>(
                    sub_chol + (ks * d + r) * d + c))
              : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < 2 * nb * DP * DP; i += blockDim.x) {
      const int kk = i / (DP * DP), r = (i / DP) % DP, c = i % DP;
      const size_t ks = 2 * (size_t)list[kk >> 1] + (kk & 1);
      t.f[i] = (r < d && c < d) ? __ldg(sub_chol + (ks * d + r) * d + c)
                                : 0.f;
    }
  }
  for (int i = threadIdx.x; i < 2 * nb * DP; i += blockDim.x) {
    const int kk = i / DP, c = i % DP;
    const size_t ks = 2 * (size_t)list[kk >> 1] + (kk & 1);
    t.mu[i] = c < d ? __ldg(sub_mu + ks * d + c) : 0.f;
  }
  __syncthreads();
}

// Step (f)'s logit of sub-cluster slot k of a staged tile, as
// gauss_sub_narrow / gauss_sub_wide write it.
template <int DP>
__device__ __forceinline__ float sub_logit(const GaussTile<DP>& t, int k,
                                           float maha, float half_d_log2pi) {
  float v = 0.5f * (t.ld[k] - maha) - half_d_log2pi;
  v = v + t.lw[k];
  return v;
}

// ---------------------------------------------------------------------------
// Step (e) as a register-tiled product (16 < d <= 128): a launch of its own,
// over tiles of TE_BM points, before the (f) + fold kernel, which reads the
// labels it wrote. Per active slot k the whitening is Y = (X - mu_k) F_k on
// the tile's points. A block keeps its points' x resident in shared memory
// (transposed, DP rows, zero past d and np) and streams the factors of the
// active slots, SP = 128 / DP of them side by side in a 128-column tile
// (the slab row holds slot s's DP columns at s FS), in row slabs of BK rows
// through a ring of TE_STAGES buffers with cp.async. Each of the 256
// threads holds an 8 x 8 register tile of Y: rows g0 + i and g1 + i (64
// apart), and columns 4 u + q and DP / 2 + 4 u + q of one slot s (u the
// thread's place among the slot's TPS = DP / 8 threads); x - mu_k is formed
// in registers from the resident x and the slab's mean (8 subtractions a row
// for 64 FMAs), as the parent's per-point loop forms it.
//
// Bits. A column is the chain fmaf(x_r - mu_r, F_rc, y_c) over r in order
// (rows and columns past d add exact zeros), and |y|^2 follows the parent
// layout's order, carried from thread to thread by shuffles:
//  - DP = 32, 64 (gauss_assign_narrow): one chain fmaf(y_c, y_c, m) over
//    c = 0..DP-1, in blocks of 4 columns, block b held by thread b % TPS;
//  - DP = 128 (gauss_assign_wide): the chain of lane j over columns
//    4 j + 16 t + q (threads j + 4 (t % 4)), then (s0 + s1) + (s2 + s3) by
//    the same two xor shuffles.
// The logit and its Gumbel are the parent's expressions. Each thread keeps
// a strict-`>` running max over its slots (increasing k) for the rows it
// owns; the inactive slots' Gumbels are drawn by a second pass (two threads
// a point), and the partials are merged by (max, least slot), which is the
// first maximum of one walk over all slots in order, bit for bit: the
// labels depend on (x, slot, d) alone, not on the tile or the grid.
// ---------------------------------------------------------------------------
constexpr int TE_BM = 128;               // points a block
constexpr int TE_THREADS = 256;
constexpr int TE_XS = TE_BM + 4;         // row stride of the resident x
constexpr int TE_STAGES = 3;

template <int DP>
struct TiledE {
  static constexpr int SP = 128 / DP;             // slots a column tile
  static constexpr int TPS = DP / 8;              // threads a slot
  // slot stride in a slab row: at DP = 32, 48 puts the two slots a
  // quarter-warp reads on different banks
  static constexpr int FS = DP == 32 ? 48 : DP;
  static constexpr int ROW = SP * FS;             // floats a slab row
  static constexpr int BK = DP == 128 ? 16 : 32;  // rows a slab
  static constexpr int MS = BK + 1;               // mean stride a slot
  static constexpr int STAGE = (BK * ROW + SP * MS + 3) / 4 * 4;
  static constexpr int XT = DP * TE_XS;
  static constexpr int PARTS = SP + 2;            // partials a point
  static constexpr int OWN = TPS >= 8 ? 1 : 8 / TPS;   // rows a thread owns
  static_assert(SP * TPS == 16 && BK * SP <= TE_THREADS &&
                    (BK * 32) % TE_THREADS == 0 && DP % BK == 0,
                "tiled step (e)");
};

// Shared bytes of sweep_assign_tiled<DP> for K slots: the x tile, the ring,
// the partials, the scan's warp totals and two K-int lists.
template <int DP>
__host__ inline size_t te_smem_bytes(int K) {
  using T = TiledE<DP>;
  return sizeof(float) * ((size_t)T::XT + (size_t)TE_STAGES * T::STAGE +
                          2 * (size_t)T::PARTS * TE_BM + 32 + 2 * (size_t)K);
}

// Copy row slab r0 of column tile tl (the active slots order[tl SP + s],
// s < SP, those below na) of the factors and means into one stage, zero
// past d and for missing slots.
template <int DP>
__device__ __forceinline__ void te_load(const float* __restrict__ chol,
                                        const float* __restrict__ mu,
                                        const int* order, int na, int d,
                                        int tl, int r0, bool vec,
                                        float* stage) {
  using T = TiledE<DP>;
  float* fs = stage;
  float* ms = stage + T::BK * T::ROW;
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int Q = DP / 4, E = T::BK * T::SP * Q;
#pragma unroll
    for (int i = 0; i < E / TE_THREADS; ++i) {
      const int e = tid + i * TE_THREADS;
      const int r = e / (T::SP * Q), rem = e % (T::SP * Q);
      const int sp = rem / Q, c = 4 * (rem % Q);
      const int j = tl * T::SP + sp;
      const bool ok = j < na && r0 + r < d && c < d;
      cp_async16(fs + r * T::ROW + sp * T::FS + c,
                 ok ? chol + ((size_t)order[j] * d + r0 + r) * d + c : chol,
                 ok ? 16 : 0);
    }
  } else {
    constexpr int E = T::BK * T::SP * DP;
#pragma unroll 4
    for (int i = 0; i < E / TE_THREADS; ++i) {
      const int e = tid + i * TE_THREADS;
      const int r = e / (T::SP * DP), rem = e % (T::SP * DP);
      const int sp = rem / DP, c = rem % DP;
      const int j = tl * T::SP + sp;
      const bool ok = j < na && r0 + r < d && c < d;
      cp_async4(fs + r * T::ROW + sp * T::FS + c,
                ok ? chol + ((size_t)order[j] * d + r0 + r) * d + c : chol,
                ok ? 4 : 0);
    }
  }
  if (tid < T::SP * T::BK) {
    const int sp = tid / T::BK, r = tid % T::BK;
    const int j = tl * T::SP + sp;
    const bool ok = j < na && r0 + r < d;
    cp_async4(ms + sp * T::MS + r,
              ok ? mu + (size_t)order[j] * d + r0 + r : mu, ok ? 4 : 0);
  }
}

// |y|^2 of the thread's 8 rows for its slot, in the parent layout's order
// (above); every thread of the slot gets the 8 values.
template <int DP>
__device__ __forceinline__ void te_maha(const float (&acc)[8][8], int tx,
                                        float (&m)[8]) {
  using T = TiledE<DP>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 8; ++i) m[i] = 0.f;
  if constexpr (DP < 128) {
    const int u = tx % T::TPS;
#pragma unroll
    for (int b = 0; b < 2 * T::TPS; ++b) {
      const int h = b / T::TPS;
      const bool mine = u == b % T::TPS;
      const int src = (lane & ~(T::TPS - 1)) | (b % T::TPS);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float v = m[i];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v = fmaf(acc[i][4 * h + q], acc[i][4 * h + q], v);
        m[i] = __shfl_sync(0xffffffffu, mine ? v : m[i], src);
      }
    }
  } else {
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int h = t / 4;
      const bool mine = (tx >> 2) == (t & 3);
      const int src = (lane & 16) | ((t & 3) << 2) | (tx & 3);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float v = m[i];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v = fmaf(acc[i][4 * h + q], acc[i][4 * h + q], v);
        m[i] = __shfl_sync(0xffffffffu, mine ? v : m[i], src);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      m[i] += __shfl_xor_sync(0xffffffffu, m[i], 1);
      m[i] += __shfl_xor_sync(0xffffffffu, m[i], 2);
    }
  }
}

// Step (e) of TE_BM points (tile blockIdx.x) for 16 < d <= 128 (DP = 32,
// 64 or 128): labels[i] for the tile's points. smem holds te_smem_bytes<DP>.
template <int DP>
__global__ void __launch_bounds__(TE_THREADS, 2) sweep_assign_tiled(
    const float* __restrict__ x, int n, int d, const float* __restrict__ mu,
    const float* __restrict__ chol, const float* __restrict__ logdet,
    const float* __restrict__ logw, const int* __restrict__ active,
    const int* __restrict__ slots, int K, const long long* __restrict__ gidx,
    const long long* __restrict__ key_z, float half_d_log2pi, int vec,
    int* __restrict__ labels) {
  using T = TiledE<DP>;
  extern __shared__ __align__(16) float te_smem[];
  float* xt = te_smem;
  float* ring = xt + T::XT;
  float* pb = ring + TE_STAGES * T::STAGE;
  int* pl = reinterpret_cast<int*>(pb + T::PARTS * TE_BM);
  int* tmp = pl + T::PARTS * TE_BM;
  int* flag = tmp + 32;
  int* order = flag + K;
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * TE_BM;
  const int np = (int)min((long long)TE_BM, (long long)n - base);
  const uint32_t kz0 = (uint32_t)key_z[0], kz1 = (uint32_t)key_z[1];

  // the active slots in order, then the inactive ones in order
  for (int k = tid; k < K; k += TE_THREADS) flag[k] = active[k] != 0;
  __syncthreads();
  const int na = block_scan_excl(flag, K, tmp);
  for (int k = tid; k < K; k += TE_THREADS) {
    const int a = flag[k];
    order[active[k] != 0 ? a : na + k - a] = k;
  }
  // the tile's points, transposed, zero past d and np
  const float* xb = x + base * d;
  for (int e = tid; e < TE_BM * DP; e += TE_THREADS) {
    const int p = e / DP, r = e % DP;
    xt[r * TE_XS + p] =
        (p < np && r < d) ? __ldg(xb + (size_t)p * d + r) : 0.f;
  }
  __syncthreads();

  const int tx = tid % 16, ty = tid / 16;
  const int s = tx / T::TPS, u = tx % T::TPS;
  const int g0 = 4 * ty, g1 = g0 + TE_BM / 2;
  const int cA = s * T::FS + 4 * u, cB = cA + DP / 2;
  // the rows this thread owns: i = u + o TPS (i < 8), point g(i)
  float best[T::OWN];
  int lab[T::OWN];
  uint32_t gp[T::OWN];
#pragma unroll
  for (int o = 0; o < T::OWN; ++o) {
    const int i = u + o * T::TPS;
    const int p = i < 4 ? g0 + i : g1 + i - 4;
    best[o] = NEG_INF;
    lab[o] = 0;
    gp[o] = (i < 8 && p < np) ? (uint32_t)gidx[base + p] : 0u;
  }

  const int ns = (d + T::BK - 1) / T::BK;
  const int steps = (na + T::SP - 1) / T::SP * ns;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < TE_STAGES - 1; ++i) {
    if (i < steps)
      te_load<DP>(chol, mu, order, na, d, i / ns, (i % ns) * T::BK, vec != 0,
                  ring + i * T::STAGE);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<TE_STAGES - 2>();
    __syncthreads();
    const int tn = t + TE_STAGES - 1;
    if (tn < steps)
      te_load<DP>(chol, mu, order, na, d, tn / ns, (tn % ns) * T::BK,
                  vec != 0, ring + (tn % TE_STAGES) * T::STAGE);
    cp_async_commit();
    const float* fs = ring + (t % TE_STAGES) * T::STAGE;
    const float* ms = fs + T::BK * T::ROW + s * T::MS;
    const float* xr = xt + (t % ns) * T::BK * TE_XS;
#pragma unroll
    for (int r = 0; r < T::BK; ++r) {
      const float4 a0 = *reinterpret_cast<const float4*>(xr + r * TE_XS + g0);
      const float4 a1 = *reinterpret_cast<const float4*>(xr + r * TE_XS + g1);
      const float mv = ms[r];
      const float4 b0 = *reinterpret_cast<const float4*>(fs + r * T::ROW + cA);
      const float4 b1 = *reinterpret_cast<const float4*>(fs + r * T::ROW + cB);
      const float av[8] = {a0.x - mv, a0.y - mv, a0.z - mv, a0.w - mv,
                           a1.x - mv, a1.y - mv, a1.z - mv, a1.w - mv};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    if (t % ns == ns - 1) {
      // the column tile is done: each slot's |y|^2, logit and Gumbel
      float m[8];
      te_maha<DP>(acc, tx, m);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      }
      const int j = (t / ns) * T::SP + s;
      if (j < na) {
        const int k = order[j];
        const float ldk = __ldg(logdet + k), lwk = __ldg(logw + k);
        const uint32_t sk = (uint32_t)__ldg(slots + k);
#pragma unroll
        for (int o = 0; o < T::OWN; ++o) {
          const int io = u + o * T::TPS;
          float mi = m[0];
#pragma unroll
          for (int i = 1; i < 8; ++i) mi = io == i ? m[i] : mi;
          if (io < 8) {
            float v = 0.5f * (ldk - mi) - half_d_log2pi;
            v = v + lwk;
            v = v + gumbel(kz0, kz1, gp[o], sk);
            if (v > best[o]) {
              best[o] = v;
              lab[o] = k;
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int o = 0; o < T::OWN; ++o) {
    const int i = u + o * T::TPS;
    if (i < 8) {
      const int p = i < 4 ? g0 + i : g1 + i - 4;
      pb[s * TE_BM + p] = best[o];
      pl[s * TE_BM + p] = lab[o];
    }
  }
  {
    // the inactive slots: -1e30 + Gumbel, two threads a point
    const int p = tid % TE_BM, h = tid / TE_BM;
    float b = NEG_INF;
    int l = 0;
    if (p < np) {
      const uint32_t g = (uint32_t)gidx[base + p];
      for (int j = na + h; j < K; j += 2) {
        const int k = order[j];
        const float v = NEG_INF + gumbel(kz0, kz1, g, (uint32_t)__ldg(slots + k));
        if (v > b) {
          b = v;
          l = k;
        }
      }
    }
    pb[(T::SP + h) * TE_BM + p] = b;
    pl[(T::SP + h) * TE_BM + p] = l;
  }
  __syncthreads();
  if (tid < np) {
    float b = NEG_INF;
    int l = 0;
#pragma unroll
    for (int q = 0; q < T::PARTS; ++q) {
      const float v = pb[q * TE_BM + tid];
      const int lq = pl[q * TE_BM + tid];
      if (v > b || (v == b && lq < l)) {
        b = v;
        l = lq;
      }
    }
    labels[base + tid] = l;
  }
}

// (f) + fold, and step (e) too at DP <= 16 (below the tiled route), one
// block a STATS_BLOCK; two blocks an SM up to DP = 32 (128 registers), so
// that one block's sorts and barriers overlap another's arithmetic.
template <int DP>
__global__ void __launch_bounds__(SWEEP_THREADS, DP <= 32 ? 2 : 1)
    sweep_gauss_kernel(
    const float* __restrict__ x, int n, int d,
    const float* __restrict__ mu, const float* __restrict__ chol,
    const float* __restrict__ logdet, const float* __restrict__ logw,
    const int* __restrict__ active, const int* __restrict__ slots, int K,
    int bk_max, const float* __restrict__ sub_mu,
    const float* __restrict__ sub_chol, const float* __restrict__ sub_logdet,
    const float* __restrict__ sublogw, const float* __restrict__ valid,
    const long long* __restrict__ gidx, const long long* __restrict__ key_z,
    const long long* __restrict__ key_zb, float half_d_log2pi, int vec,
    int* __restrict__ labels, int* __restrict__ sublabels,
    float* __restrict__ n2, float* __restrict__ sx2,
    float* __restrict__ sxx2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = 2 * K;
  float* tile = reinterpret_cast<float*>(smem);
  const FoldSmem fs(tile + gauss_tile_floats(DP, sweep_region_slots(bk_max)),
                    S);

  const size_t base = (size_t)blockIdx.x * STATS_BLOCK;
  const long long rest = (long long)n - (long long)base;
  const int np = rest < STATS_BLOCK ? (int)rest : STATS_BLOCK;
  const float* xb = x + base * d;
  const uint32_t kb0 = (uint32_t)key_zb[0], kb1 = (uint32_t)key_zb[1];

  // ---- step (e): running first-max over the K tiles, or the labels of
  // sweep_assign_tiled (the sort's first barrier orders these writes) -----
  constexpr bool TILED = DP >= 32;
  if constexpr (TILED) {
    for (int p = threadIdx.x; p < np; p += SWEEP_THREADS)
      fs.lab[p] = labels[base + p];
  } else {
    gauss_assign_narrow<DP>(xb, np, d, gidx + base, mu, chol, logdet, logw,
                            active, slots, K, bk_max, (uint32_t)key_z[0],
                            (uint32_t)key_z[1], half_d_log2pi, tile, fs.best,
                            fs.lab);
  }

  // ---- step (f), grouped by label: each batch of present labels' two
  // sub-factors staged once, then the batch's points (contiguous in the
  // label order) against shared operands ----------------------------------
  int *list, *pos;
  const int nl = group_by_label(fs, np, K, list, pos);
  const int lb = sweep_region_slots(bk_max) / 2;       // labels a batch
  const GaussTile<DP> st(tile, 2 * lb);
  for (int b0 = 0; b0 < nl; b0 += lb) {
    const int nb = min(lb, nl - b0);
    stage_sub_labels<DP>(st, list + b0, nb, d, sub_mu, sub_chol, sub_logdet,
                         sublogw);
    const int i1 = fs.start[list[b0 + nb - 1] + 1];
    for (int i = fs.start[list[b0]] + threadIdx.x; i < i1;
         i += SWEEP_THREADS) {
      const int p = fs.idx[i];
      const int l = fs.lab[p];
      const int r = pos[l] - b0;
      float xr[DP];
      load_row<DP>(xb + (size_t)p * d, d, xr);
      const uint32_t g = (uint32_t)gidx[base + p];
      float t2[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int k = 2 * r + s;
        const float maha = maha_narrow<DP>(xr, st.f + (size_t)k * DP * DP,
                                           st.mu + k * DP);
        t2[s] = sub_logit<DP>(st, k, maha, half_d_log2pi) +
                gumbel(kb0, kb1, g, (uint32_t)s);
      }
      const int zb = t2[1] > t2[0] ? 1 : 0;
      if (!TILED) labels[base + p] = l;
      sublabels[base + p] = zb;
      const float v = valid[base + p];
      fs.seg[p] = v != 0.f ? 2 * l + zb : -1;
      fs.w[p] = v;
    }
  }
  __syncthreads();

  // ---- stat fold of this STATS_BLOCK -------------------------------------
  const size_t blk = blockIdx.x;
  sweep_fold<(DP < 8 ? 8 : DP)>(xb, d, np, S, fs, vec != 0, n2 + blk * S,
                                sx2 + blk * S * d, sxx2 + blk * S * d * d);
}

// (f) + fold for 64 < d <= 128, after sweep_assign_tiled<128>.
__global__ void __launch_bounds__(SWEEP_THREADS) sweep_gauss_wide_kernel(
    const float* __restrict__ x, int n, int d,
    const float* __restrict__ mu, const float* __restrict__ chol,
    const float* __restrict__ logdet, const float* __restrict__ logw,
    const int* __restrict__ active, const int* __restrict__ slots, int K,
    int bk_max, const float* __restrict__ sub_mu,
    const float* __restrict__ sub_chol, const float* __restrict__ sub_logdet,
    const float* __restrict__ sublogw, const float* __restrict__ valid,
    const long long* __restrict__ gidx, const long long* __restrict__ key_z,
    const long long* __restrict__ key_zb, float half_d_log2pi, int vec,
    int* __restrict__ labels, int* __restrict__ sublabels,
    float* __restrict__ n2, float* __restrict__ sx2,
    float* __restrict__ sxx2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = 2 * K;
  float* tile = reinterpret_cast<float*>(smem);
  float* xsm = tile + gauss_tile_floats(WIDE_D, sweep_region_slots(bk_max));
  const FoldSmem fs(xsm + wide_x_floats(SWEEP_THREADS), S);

  const size_t base = (size_t)blockIdx.x * STATS_BLOCK;
  const long long rest = (long long)n - (long long)base;
  const int np = rest < STATS_BLOCK ? (int)rest : STATS_BLOCK;
  const float* xb = x + base * d;
  const uint32_t kb0 = (uint32_t)key_zb[0], kb1 = (uint32_t)key_zb[1];

  // ---- the labels of step (e) (sweep_assign_tiled); the sort's first
  // barrier orders these writes -------------------------------------------
  for (int p = threadIdx.x; p < np; p += SWEEP_THREADS)
    fs.lab[p] = labels[base + p];

  // ---- step (f), grouped by label: one present label's two sub-factors
  // staged at a time, its points a lane group each, as in step (e) --------
  int *list, *pos;
  const int nl = group_by_label(fs, np, K, list, pos);
  const GaussTile<WIDE_D> st(tile, 2);
  constexpr int groups = SWEEP_THREADS / WIDE_LANES;
  const int grp = threadIdx.x / WIDE_LANES, j = threadIdx.x % WIDE_LANES;
  float* xs = xsm + grp * WIDE_XSTRIDE;
  for (int b = 0; b < nl; ++b) {
    stage_sub_labels<WIDE_D>(st, list + b, 1, d, sub_mu, sub_chol,
                             sub_logdet, sublogw);
    const int l = list[b];
    const int i1 = fs.start[l + 1];
    // every lane runs the same passes: the shuffles of maha_wide need the
    // whole warp
    for (int q0 = fs.start[l]; q0 < i1; q0 += groups) {
      const int i = q0 + grp;
      const bool live = i < i1;
      const int p = live ? fs.idx[i] : 0;
      stage_x_wide(xb, p, live, d, j, xs);
      __syncwarp();
      const uint32_t g = live ? (uint32_t)gidx[base + p] : 0u;
      float t2[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float maha = maha_wide(xs, st.f + (size_t)s * WIDE_D * WIDE_D,
                                     st.mu + s * WIDE_D, d, j);
        const float v = sub_logit<WIDE_D>(st, s, maha, half_d_log2pi);
        t2[s] = live ? v + gumbel(kb0, kb1, g, (uint32_t)s) : v;
      }
      const int zb = t2[1] > t2[0] ? 1 : 0;
      if (live && j == 0) {
        sublabels[base + p] = zb;
        const float v = valid[base + p];
        fs.seg[p] = v != 0.f ? 2 * l + zb : -1;
        fs.w[p] = v;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- stat fold of this STATS_BLOCK -------------------------------------
  const size_t blk = blockIdx.x;
  sweep_fold<128>(xb, d, np, S, fs, vec != 0, n2 + blk * S,
                  sx2 + blk * S * d, sxx2 + blk * S * d * d);
}

template <class Kernel>
int launch(Kernel kernel, int dp, size_t extra_words, const float* x, int n,
           int d, const float* mu, const float* chol, const float* logdet,
           const float* logw, const int* active, const int* slots, int K,
           const float* sub_mu, const float* sub_chol,
           const float* sub_logdet, const float* sublogw, const float* valid,
           const long long* gidx, const long long* key_z,
           const long long* key_zb, int* labels, int* sublabels, float* n2,
           float* sx2, float* sxx2, cudaStream_t stream) {
  const int bk_max = gauss_tile_slots(dp, K);
  const size_t smem =
      sizeof(float) * (gauss_tile_floats(dp, sweep_region_slots(bk_max)) +
                       extra_words + fold_smem_words(K));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nsb = (n + STATS_BLOCK - 1) / STATS_BLOCK;
  const float half_d_log2pi = (float)(0.5 * d * 1.8378770664093453);
  const int vec = (d & 3) == 0 && ((uintptr_t)x & 15) == 0 &&
                  ((uintptr_t)sxx2 & 15) == 0;
  kernel<<<nsb, SWEEP_THREADS, smem, stream>>>(
      x, n, d, mu, chol, logdet, logw, active, slots, K, bk_max, sub_mu,
      sub_chol, sub_logdet, sublogw, valid, gidx, key_z, key_zb,
      half_d_log2pi, vec, labels, sublabels, n2, sx2, sxx2);
  return (int)cudaGetLastError();
}

// Step (e) of the tiled route (sweep_assign_tiled<DP>) into labels; smem_e
// is the wrapper's plan, refused unless it is this layout's.
template <int DP>
int launch_tiled_e(const float* x, int n, int d, const float* mu,
                   const float* chol, const float* logdet, const float* logw,
                   const int* active, const int* slots, int K,
                   const long long* gidx, const long long* key_z,
                   int smem_e, int* labels, cudaStream_t stream) {
  const size_t smem = te_smem_bytes<DP>(K);
  if ((size_t)smem_e != smem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sweep_assign_tiled<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = ((long long)n + TE_BM - 1) / TE_BM;
  const float half_d_log2pi = (float)(0.5 * d * 1.8378770664093453);
  const int vec = (d & 3) == 0 && ((uintptr_t)chol & 15) == 0;
  sweep_assign_tiled<DP><<<(unsigned)grid, TE_THREADS, smem, stream>>>(
      x, n, d, mu, chol, logdet, logw, active, slots, K, gidx, key_z,
      half_d_log2pi, vec, labels);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

extern "C" int sweep_gauss_launch(
    const float* x, int n, int d, const float* mu, const float* chol,
    const float* logdet, const float* logw, const int* active,
    const int* slots, int K, const float* sub_mu, const float* sub_chol,
    const float* sub_logdet, const float* sublogw, const float* valid,
    const long long* gidx, const long long* key_z, const long long* key_zb,
    int tiled, int smem_e, int* labels, int* sublabels, float* n2,
    float* sx2, float* sxx2, void* stream) {
  using namespace repro_torch;
  if (n <= 0 || K <= 0 || K > 2048 || d <= 0 || d > WIDE_D)
    return (int)cudaErrorInvalidValue;
  // the route of the wrapper's sweep_plan: step (e) tiled (a launch of its
  // own, template DP) above d = 16, in the block at and below it
  if (tiled != (d <= 16 ? 0 : d <= 32 ? 32 : d <= 64 ? 64 : 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiled != 0) {
    const int err =
        tiled == 32 ? launch_tiled_e<32>(x, n, d, mu, chol, logdet, logw,
                                         active, slots, K, gidx, key_z,
                                         smem_e, labels, s)
        : tiled == 64 ? launch_tiled_e<64>(x, n, d, mu, chol, logdet, logw,
                                           active, slots, K, gidx, key_z,
                                           smem_e, labels, s)
                      : launch_tiled_e<128>(x, n, d, mu, chol, logdet, logw,
                                            active, slots, K, gidx, key_z,
                                            smem_e, labels, s);
    if (err != 0) return err;
  } else if (smem_e != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const auto run = [&](auto kernel, int dp, size_t extra_words) {
    return launch(kernel, dp, extra_words, x, n, d, mu, chol, logdet, logw,
                  active, slots, K, sub_mu, sub_chol, sub_logdet, sublogw,
                  valid, gidx, key_z, key_zb, labels, sublabels, n2, sx2,
                  sxx2, s);
  };
  if (d <= 4) return run(sweep_gauss_kernel<4>, 4, 0);
  if (d <= 8) return run(sweep_gauss_kernel<8>, 8, 0);
  if (d <= 16) return run(sweep_gauss_kernel<16>, 16, 0);
  if (d <= 32) return run(sweep_gauss_kernel<32>, 32, 0);
  if (d <= 64) return run(sweep_gauss_kernel<64>, 64, 0);
  return run(sweep_gauss_wide_kernel, WIDE_D, wide_x_floats(SWEEP_THREADS));
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
