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
// (sweep_assign_tiled, below): the register tile of te_tile.cuh, shared
// with assign_gauss.cu and loglik_gauss.cu, over tiles of 128 points, the
// x tile resident in shared memory and the live slots' factors streamed in
// row slabs through a cp.async ring (up to four slots side by side in a
// 128-column tile at d <= 32), |y|^2 finished in the one-thread-a-point
// order, and the first max merged by (max, least slot).
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
#include "sub_tile.cuh"
#include "te_tile.cuh"
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

// Step (e) as a register-tiled product (16 < d <= 128): a launch of its own,
// over tiles of TE_BM points, before the (f) + fold kernel, which reads the
// labels it wrote. The tile is te_tile.cuh's, the device code of
// assign_gauss.cu at these widths, on one slot group: the labels depend on
// (x, slot, d) alone, not on the tile or the grid. smem holds
// te_smem_bytes<DP>(K).
template <int DP>
__global__ void __launch_bounds__(TE_THREADS, 2) sweep_assign_tiled(
    const float* __restrict__ x, int n, int d, const float* __restrict__ mu,
    const float* __restrict__ chol, const float* __restrict__ logdet,
    const float* __restrict__ logw, const int* __restrict__ active,
    const int* __restrict__ slots, int K, const long long* __restrict__ gidx,
    const long long* __restrict__ key_z, float half_d_log2pi, int vec,
    int* __restrict__ labels) {
  extern __shared__ __align__(16) float te_smem[];
  te_tile<DP, true>(x, n, d, mu, chol, logdet, logw, active, slots, K, gidx,
                    (uint32_t)key_z[0], (uint32_t)key_z[1], half_d_log2pi,
                    vec != 0, te_smem, nullptr, nullptr, labels);
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
