// One-read fused Gibbs sweep for the linear-likelihood families
// (multinomial, Poisson, diagonal Gaussian): steps (e) + (f) of the
// restricted sampler and the sub-cluster first-moment fold, on an NVIDIA
// Hopper card (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sweep.py:sweep_linear
// (_sweep_linear_kernel). Each family packs its log-likelihood as a linear
// form of per-point features f (x, or [x, x^2]): loglik_k(x) = f . w_k +
// const_k. What it computes, per point i with global index gidx[i]:
//   (e) z_i  = first argmax_k [ (f_i . w_k + const_k) + logw_k  (-1e30 if
//              the slot is inactive) + Gumbel(key_z, gidx_i, slots_k) ]
//   (f) zb_i = first argmax_s [ (f_i . subw_{z_i,s} + subconst_{z_i,s})
//              + sublogw_{z_i,s} + Gumbel(key_zb, gidx_i, s) ],  s in {0, 1}
//   and, per STATS_BLOCK of points, the (K, 2) partials n and sf = sum f
//   over segments 2 z + zb (block_stats.cuh).
//
// Design. The TPU grid (point blocks, phase, K tiles) ran in order and
// carried the running (max, argmax) across K tiles in scratch. Here one
// thread block owns one STATS_BLOCK of points and loops over K tiles of up
// to 64 slots itself (step (e) is assign_tile.cuh's linear_assign, shared
// with assign_linear.cu). d' runs to 20,000 (a vocabulary), so nothing of a
// point is kept whole in registers: for each sub-tile of 256 points and
// each K tile, chunks of 32 features of the points and of the tile's
// active weight rows are copied to shared memory with cp.async, two
// chunks in flight, and every thread accumulates an 8 points x 8 slots
// block of dot products in registers across the chunks, in feature order. Only the active slots are multiplied (a compact slab
// has inactive pad slots); an inactive slot's logit is -1e30 + its Gumbel,
// which the Threefry top bin can still make +inf, so its noise is drawn
// all the same. After the last chunk each thread folds its 8 x 8 logits
// into (max, smallest slot) pairs, eight lanes combine theirs with warp
// shuffles, and the result replaces the point's running best only when it
// is strictly larger: the first maximum wins, as in the reference.
// Step (f) takes one warp per point (assign_tile.cuh's linear_sub_assign,
// shared with sub_assign_linear.cu): lanes stride the point's feature row
// and its own cluster's two sub-weight rows (coalesced), and a shuffle-down
// tree sums them, so the sum is the same on every launch; the Gumbel draws
// and the choice then run for 32 points at once, one per lane. The fold sorts
// the block's point ids by segment and sums each output entry in point
// order, without float atomics, so a repeat launch gives identical bits.
//
// What bounds it. Step (e) does 2 N K_live d' FLOP on the CUDA cores (fp32,
// no tensor cores, no TF32) and N K Threefry draws; it reads N d' 4 bytes of
// features and writes nsb 2K (1 + d') 4 bytes of partials. At the
// multinomial fit's shapes (N = 1e6, d' = 128, 16 live slots) that is
// about 4 GFLOP against 0.5 GB, so both bounds are near 0.1-0.2 ms.
//
// Limits: 1 <= d' <= 65536, 1 <= K <= 2048 (segment offsets live in shared
// memory).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "assign_tile.cuh"
#include "block_stats.cuh"
#include "threefry.cuh"

namespace repro_torch {

// linear_sub_assign's output step in the sweep: the point's label and
// sub-label, and its fold segment (-1 for an invalid point).
struct PutSweep {
  const int* lab;
  const float* valid;
  int* labels;
  int* sublabels;
  int* seg;
  __device__ void operator()(int p, int zb) const {
    const int l = lab[p];
    labels[p] = l;
    sublabels[p] = zb;
    seg[p] = valid[p] != 0.f ? 2 * l + zb : -1;
  }
};

// Two blocks per SM (at most 128 registers a thread): the latency-bound
// step (f) and fold need the warps of both to hide their loads.
__global__ void __launch_bounds__(LIN_THREADS, 2) sweep_linear_kernel(
    const float* __restrict__ feats, int n, int dp,
    const float* __restrict__ w, const float* __restrict__ cst,
    const float* __restrict__ logw, const int* __restrict__ active,
    const int* __restrict__ slots, int K, const float* __restrict__ subw,
    const float* __restrict__ subconst, const float* __restrict__ sublogw,
    const float* __restrict__ valid, const long long* __restrict__ gidx,
    const long long* __restrict__ key_z, const long long* __restrict__ key_zb,
    int* __restrict__ labels, int* __restrict__ sublabels,
    float* __restrict__ n2, float* __restrict__ sf2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = 2 * K;
  float* words = reinterpret_cast<float*>(smem);       // linear_assign
  float* best = words + linear_assign_words();         // STATS_BLOCK
  int* lab = reinterpret_cast<int*>(best + STATS_BLOCK);  // STATS_BLOCK
  int* seg = lab + STATS_BLOCK;                        // STATS_BLOCK
  int* idx = seg + STATS_BLOCK;                        // STATS_BLOCK
  int* start = idx + STATS_BLOCK;                      // S + 1
  int* cursor = start + S + 1;                         // S

  const size_t base = (size_t)blockIdx.x * STATS_BLOCK;
  const long long rest = (long long)n - (long long)base;
  const int np = rest < STATS_BLOCK ? (int)rest : STATS_BLOCK;
  const float* fb = feats + base * dp;
  const uint32_t kb0 = (uint32_t)key_zb[0], kb1 = (uint32_t)key_zb[1];
  const bool vec = (dp & 3) == 0 &&
                   (((uintptr_t)feats | (uintptr_t)w | (uintptr_t)subw) &
                    15) == 0;

  // ---- step (e): running first-max over the K tiles (assign_tile.cuh) ----
  linear_assign(fb, np, dp, gidx + base, w, cst, logw, active, slots, K,
                (uint32_t)key_z[0], (uint32_t)key_z[1], vec, words, best,
                lab);

  // ---- step (f): one warp per point (assign_tile.cuh), which writes the
  // labels, sub-labels and fold segments as it picks each sub-label ------
  linear_sub_assign<false>(fb, np, dp, gidx + base, lab, K, subw, subconst,
                           sublogw, kb0, kb1, vec,
                           PutSweep{lab, valid + base, labels + base,
                                    sublabels + base, seg});
  __syncthreads();

  // ---- first-moment fold of this STATS_BLOCK -----------------------------
  sort_by_segment(seg, np, S, start, cursor, idx);
  const size_t blk = blockIdx.x;
  accumulate_moments(fb, valid + base, dp, S, start, idx, 0, dp,
                     n2 + blk * S, sf2 + blk * S * (size_t)dp);
}

}  // namespace repro_torch

extern "C" int sweep_linear_launch(
    const float* feats, int n, int dp, const float* w, const float* cst,
    const float* logw, const int* active, const int* slots, int K,
    const float* subw, const float* subconst, const float* sublogw,
    const float* valid, const long long* gidx, const long long* key_z,
    const long long* key_zb, int* labels, int* sublabels, float* n2,
    float* sf2, void* stream) {
  using namespace repro_torch;
  if (n <= 0 || dp <= 0 || dp > 65536 || K <= 0 || K > 2048)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (linear_assign_words() + 4 * (size_t)STATS_BLOCK +
                       4 * (size_t)K + 1);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_linear_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nsb = (n + STATS_BLOCK - 1) / STATS_BLOCK;
  sweep_linear_kernel<<<nsb, LIN_THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      feats, n, dp, w, cst, logw, active, slots, K, subw, subconst, sublogw,
      valid, gidx, key_z, key_zb, labels, sublabels, n2, sf2);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
