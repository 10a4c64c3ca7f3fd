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
// scratch. Here one thread block owns one STATS_BLOCK of points and loops
// over the K tiles itself (step (e), assign_tile.cuh, shared with
// assign_gauss.cu): a tile of Cholesky factors is staged in shared memory,
// the block's points are folded against it with a strict `>` (first max
// wins, as in the reference), and the running best lives in shared memory
// between tiles. Step (f) reads each point's own (2, d, d) factors straight
// from global memory (they stay in L1/L2). The stats of the block are then
// folded without float atomics, so the per-STATS_BLOCK partials are
// (nsb, K, 2, ...) and never the per-(point block, K block) layout of the
// TPU kernel.
//
// Two layouts (assign_tile.cuh): for d <= 64 a thread owns a point and
// keeps its d-vectors in registers (template DP = d rounded up to a power
// of two, at least 4); for 64 < d <= 128 four lanes share a point, 32
// output columns each, with one 64 KiB factor staged per tile and the
// dynamic shared memory raised above 48 KiB.
//
// What bounds it. Step (e) is 2 N K d^2 FLOP of fp32 FMA over the K live
// slots (33 GFLOP at N = 1e6, K = 16, d = 32; inactive slots of the
// compact slab are skipped) against N d 4 B of x, so it is bound by the
// CUDA cores' fp32 rate, not by memory: about 0.5 ms at the H100 SXM's
// 67 TFLOP/s. The factor rows are broadcast from shared memory (one
// 16-byte shared load per four FMAs); tensor cores (TF32 wgmma for
// F^T diff) and TMA staging of x are left for a later version.
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

// Shared memory after the step-(e) tile: best, lab, seg, idx
// (STATS_BLOCK each) and the segment offsets start (S + 1), cursor (S).
struct FoldSmem {
  float* best;
  int* lab;
  int* seg;
  int* idx;
  int* start;
  int* cursor;
  __device__ FoldSmem(float* base, int S) {
    best = base;
    lab = reinterpret_cast<int*>(best + STATS_BLOCK);
    seg = lab + STATS_BLOCK;
    idx = seg + STATS_BLOCK;
    start = idx + STATS_BLOCK;
    cursor = start + S + 1;
  }
};

__host__ inline size_t fold_smem_words(int K) {
  return 4 * (size_t)STATS_BLOCK + 4 * (size_t)K + 1;
}

template <int DP>
__global__ void __launch_bounds__(SWEEP_THREADS) sweep_gauss_kernel(
    const float* __restrict__ x, int n, int d,
    const float* __restrict__ mu, const float* __restrict__ chol,
    const float* __restrict__ logdet, const float* __restrict__ logw,
    const int* __restrict__ active, const int* __restrict__ slots, int K,
    int bk_max, const float* __restrict__ sub_mu,
    const float* __restrict__ sub_chol, const float* __restrict__ sub_logdet,
    const float* __restrict__ sublogw, const float* __restrict__ valid,
    const long long* __restrict__ gidx, const long long* __restrict__ key_z,
    const long long* __restrict__ key_zb, float half_d_log2pi,
    int* __restrict__ labels, int* __restrict__ sublabels,
    float* __restrict__ n2, float* __restrict__ sx2,
    float* __restrict__ sxx2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = 2 * K;
  float* tile = reinterpret_cast<float*>(smem);
  const FoldSmem fs(tile + gauss_tile_floats(DP, bk_max), S);

  const size_t base = (size_t)blockIdx.x * STATS_BLOCK;
  const long long rest = (long long)n - (long long)base;
  const int np = rest < STATS_BLOCK ? (int)rest : STATS_BLOCK;
  const float* xb = x + base * d;
  const uint32_t kb0 = (uint32_t)key_zb[0], kb1 = (uint32_t)key_zb[1];

  // ---- step (e): running first-max over the K tiles ----------------------
  gauss_assign_narrow<DP>(xb, np, d, gidx + base, mu, chol, logdet, logw,
                          active, slots, K, bk_max, (uint32_t)key_z[0],
                          (uint32_t)key_z[1], half_d_log2pi, tile, fs.best,
                          fs.lab);

  // ---- step (f): own cluster's two sub-clusters (assign_tile.cuh) --------
  for (int p = threadIdx.x; p < np; p += SWEEP_THREADS) {
    const int l = fs.lab[p];
    float xr[DP];
    load_row<DP>(xb + (size_t)p * d, d, xr);
    const int zb = gauss_sub_narrow<DP>(xr, d, l, sub_mu, sub_chol,
                                        sub_logdet, sublogw,
                                        (uint32_t)gidx[base + p], kb0, kb1,
                                        half_d_log2pi);
    labels[base + p] = l;
    sublabels[base + p] = zb;
    fs.seg[p] = valid[base + p] != 0.f ? 2 * l + zb : -1;
  }
  __syncthreads();

  // ---- stat fold of this STATS_BLOCK -------------------------------------
  sort_by_segment(fs.seg, np, S, fs.start, fs.cursor, fs.idx);
  const size_t blk = blockIdx.x;
  accumulate_segments(xb, valid + base, d, S, fs.start, fs.idx,
                      n2 + blk * S, sx2 + blk * S * d, sxx2 + blk * S * d * d);
}

__global__ void __launch_bounds__(SWEEP_THREADS) sweep_gauss_wide_kernel(
    const float* __restrict__ x, int n, int d,
    const float* __restrict__ mu, const float* __restrict__ chol,
    const float* __restrict__ logdet, const float* __restrict__ logw,
    const int* __restrict__ active, const int* __restrict__ slots, int K,
    int bk_max, const float* __restrict__ sub_mu,
    const float* __restrict__ sub_chol, const float* __restrict__ sub_logdet,
    const float* __restrict__ sublogw, const float* __restrict__ valid,
    const long long* __restrict__ gidx, const long long* __restrict__ key_z,
    const long long* __restrict__ key_zb, float half_d_log2pi,
    int* __restrict__ labels, int* __restrict__ sublabels,
    float* __restrict__ n2, float* __restrict__ sx2,
    float* __restrict__ sxx2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = 2 * K;
  float* tile = reinterpret_cast<float*>(smem);
  float* xsm = tile + gauss_tile_floats(WIDE_D, bk_max);
  const FoldSmem fs(xsm + wide_x_floats(SWEEP_THREADS), S);

  const size_t base = (size_t)blockIdx.x * STATS_BLOCK;
  const long long rest = (long long)n - (long long)base;
  const int np = rest < STATS_BLOCK ? (int)rest : STATS_BLOCK;
  const float* xb = x + base * d;
  const uint32_t kb0 = (uint32_t)key_zb[0], kb1 = (uint32_t)key_zb[1];

  // ---- step (e) ----------------------------------------------------------
  gauss_assign_wide(xb, np, d, gidx + base, mu, chol, logdet, logw, active,
                    slots, K, bk_max, (uint32_t)key_z[0],
                    (uint32_t)key_z[1], half_d_log2pi, tile, xsm, fs.best,
                    fs.lab);

  // ---- step (f): a lane group per point, as in step (e) -------------------
  constexpr int groups = SWEEP_THREADS / WIDE_LANES;
  const int grp = threadIdx.x / WIDE_LANES, j = threadIdx.x % WIDE_LANES;
  float* xs = xsm + grp * WIDE_XSTRIDE;
  for (int p0 = 0; p0 < np; p0 += groups) {
    const int p = p0 + grp;
    const bool live = p < np;
    stage_x_wide(xb, p, live, d, j, xs);
    __syncwarp();
    const int l = live ? fs.lab[p] : 0;
    const int zb = gauss_sub_wide(
        xs, d, j, l, sub_mu, sub_chol, sub_logdet, sublogw, live,
        live ? (uint32_t)gidx[base + p] : 0u, kb0, kb1, half_d_log2pi);
    if (live && j == 0) {
      labels[base + p] = l;
      sublabels[base + p] = zb;
      fs.seg[p] = valid[base + p] != 0.f ? 2 * l + zb : -1;
    }
    __syncwarp();
  }
  __syncthreads();

  // ---- stat fold of this STATS_BLOCK -------------------------------------
  sort_by_segment(fs.seg, np, S, fs.start, fs.cursor, fs.idx);
  const size_t blk = blockIdx.x;
  accumulate_segments(xb, valid + base, d, S, fs.start, fs.idx,
                      n2 + blk * S, sx2 + blk * S * d, sxx2 + blk * S * d * d);
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
  const size_t smem = sizeof(float) * (gauss_tile_floats(dp, bk_max) +
                                       extra_words + fold_smem_words(K));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nsb = (n + STATS_BLOCK - 1) / STATS_BLOCK;
  const float half_d_log2pi = (float)(0.5 * d * 1.8378770664093453);
  kernel<<<nsb, SWEEP_THREADS, smem, stream>>>(
      x, n, d, mu, chol, logdet, logw, active, slots, K, bk_max, sub_mu,
      sub_chol, sub_logdet, sublogw, valid, gidx, key_z, key_zb,
      half_d_log2pi, labels, sublabels, n2, sx2, sxx2);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

extern "C" int sweep_gauss_launch(
    const float* x, int n, int d, const float* mu, const float* chol,
    const float* logdet, const float* logw, const int* active,
    const int* slots, int K, const float* sub_mu, const float* sub_chol,
    const float* sub_logdet, const float* sublogw, const float* valid,
    const long long* gidx, const long long* key_z, const long long* key_zb,
    int* labels, int* sublabels, float* n2, float* sx2, float* sxx2,
    void* stream) {
  using namespace repro_torch;
  if (n <= 0 || K <= 0 || K > 2048 || d <= 0 || d > WIDE_D)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_SWEEP_CASE(KERNEL, DP, EXTRA)                                 \
  return launch(KERNEL, DP, EXTRA, x, n, d, mu, chol, logdet, logw, active, \
                slots, K, sub_mu, sub_chol, sub_logdet, sublogw, valid,     \
                gidx, key_z, key_zb, labels, sublabels, n2, sx2, sxx2, s)
  if (d <= 4) REPRO_SWEEP_CASE(sweep_gauss_kernel<4>, 4, 0);
  if (d <= 8) REPRO_SWEEP_CASE(sweep_gauss_kernel<8>, 8, 0);
  if (d <= 16) REPRO_SWEEP_CASE(sweep_gauss_kernel<16>, 16, 0);
  if (d <= 32) REPRO_SWEEP_CASE(sweep_gauss_kernel<32>, 32, 0);
  if (d <= 64) REPRO_SWEEP_CASE(sweep_gauss_kernel<64>, 64, 0);
  REPRO_SWEEP_CASE(sweep_gauss_wide_kernel, WIDE_D,
                   wide_x_floats(SWEEP_THREADS));
#undef REPRO_SWEEP_CASE
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
