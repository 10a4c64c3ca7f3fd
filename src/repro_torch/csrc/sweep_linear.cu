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
// carried the running (max, argmax) across K tiles in scratch. Here two
// launches a call, on grids that fill the card at any N and d' (the
// wrapper's linear_plan chooses them from the shape; the launcher refuses
// any other plan):
//  1. sweep_linear_ef, one block a tile of BM = 128 points (64 where that
//     would not give two blocks an SM), steps (e) and (f): the device
//     function linear_tile.cuh runs (the active slots listed by a
//     block-wide scan and multiplied through a cp.async ring of feature
//     chunks, each thread 8 slots x BM / 32 points in registers; the draws
//     a loop over (point, slot) pairs merged by a shared atomic max of
//     packed (max, least slot) keys, an inactive slot's draw only its
//     Threefry word; step (f) a thread a (point, sub-cluster) up to d' =
//     64, above by windows of 8 points sorted by label), the same code
//     assign_linear.cu and sub_assign_linear.cu run alone;
//  2. sweep_linear_fold, one block a (STATS_BLOCK, chunk of FOLD_FC
//     features): the block's points are sorted by segment (block-wide
//     counts, stable placement; block_stats.cuh sort_segments_block) while
//     the other warps write the zeros of the empty segments; then each
//     (non-empty segment, feature quad) entry is one thread's chain over
//     the segment's points in point order (a warp reads a point's row
//     chunk in one sweep).
//
// Bits. Every output has the first version's chain (one block a
// STATS_BLOCK): a logit is fmaf over features in order (four a float4),
// then + const, + logw, + Gumbel, and the label the first maximum, which is
// (max, least slot) over the slots and the initial (-1e30, 0); a step-(f)
// sum one chain a lane and the shuffle-down tree (linear_tile.cuh); n =
// acc + w and sf = fmaf(w, f, acc) over a segment's points in point
// order. None of it depends on the grid.
//
// What bounds it. Step (e) does 2 N K_live d' FLOP on the CUDA cores (fp32,
// no tensor cores, no TF32) and N K Threefry draws (logarithms only for the
// live slots); it reads N d' 4 bytes of features (twice: the fold reads
// them again) and writes nsb 2K (1 + d') 4 bytes of partials. At the
// multinomial fit's shapes (N = 1e6, d' = 128, 16 live of 32 slots) that
// is 4 GFLOP against 0.5 GB (1 GB with the fold's second read): bytes
// bound it, near 0.15-0.3 ms, with the draws' issue about as long.
//
// Limits: 1 <= d' <= 65536, 1 <= K <= 2048 (the fold's segment offsets
// live in shared memory; larger slabs run the three-pass sweep).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "block_stats.cuh"
#include "linear_tile.cuh"

namespace repro_torch {

constexpr int LIN_MAX_K = 2048;
constexpr int FOLD_THREADS = 256;
constexpr int FOLD_FC = 128;       // features a fold block

// Shared ints (or floats) of sweep_linear_fold for S = 2K segments: seg,
// idx and the weights (STATS_BLOCK each), start (S + 1), the sort's
// scratch and the non-empty segments (S).
__host__ __device__ inline size_t fold_smem_ints(int S) {
  return 3 * (size_t)STATS_BLOCK + (S + 1) + sort_scratch_ints(S) + S;
}

// Steps (e) + (f) on BM points a block, a ring of STAGES feature chunks,
// MINB blocks an SM.
template <int BM, int STAGES, int MINB>
__global__ void __launch_bounds__(LE_THREADS, MINB)
    sweep_linear_ef(LinearTileArgs a) {
  extern __shared__ __align__(16) float ef_smem[];
  linear_tile<BM, STAGES, true, true, LE_FW>(a, ef_smem);
}

// The first-moment fold of STATS_BLOCK blockIdx.x, features
// [blockIdx.y FOLD_FC, + FOLD_FC): n (chunk 0 only) and the sf slice.
__global__ void __launch_bounds__(FOLD_THREADS) sweep_linear_fold(
    const float* __restrict__ feats, int n, int dp,
    const int* __restrict__ labels, const int* __restrict__ sublabels,
    const float* __restrict__ valid, int K, float* __restrict__ n2,
    float* __restrict__ sf2) {
  extern __shared__ int fold_smem[];
  const int S = 2 * K;
  int* seg = fold_smem;                 // STATS_BLOCK
  int* idx = seg + STATS_BLOCK;         // STATS_BLOCK
  int* start = idx + STATS_BLOCK;       // S + 1
  int* scratch = start + S + 1;         // sort_scratch_ints(S)
  int* live = scratch + sort_scratch_ints(S);   // S: non-empty segments
  float* w = reinterpret_cast<float*>(live + S);  // STATS_BLOCK: weights
  const size_t base = (size_t)blockIdx.x * STATS_BLOCK;
  const long long rest = (long long)n - (long long)base;
  const int np = rest < STATS_BLOCK ? (int)rest : STATS_BLOCK;
  const int c0 = blockIdx.y * FOLD_FC, dc = min(FOLD_FC, dp - c0);
  const float* f = feats + base * dp;
  float* n_out = blockIdx.y == 0 ? n2 + blockIdx.x * (size_t)S : nullptr;
  float* sf_out = sf2 + blockIdx.x * (size_t)S * dp;
  const bool vec = ((dp | dc | c0) & 3) == 0 &&
                   (((uintptr_t)feats | (uintptr_t)sf2) & 15) == 0;
  for (int p = threadIdx.x; p < np; p += FOLD_THREADS) {
    const float v = valid[base + p];
    w[p] = v;
    seg[p] = v != 0.f ? 2 * labels[base + p] + sublabels[base + p] : -1;
  }
  __syncthreads();
  sort_segments_block(seg, np, S, start, idx, scratch, [&](const int* st) {
    // warps 1..: the zeros of the empty segments, 16-byte stores
    const int t = threadIdx.x - 32, nt = FOLD_THREADS - 32;
    for (int s = 0; s < S; ++s) {
      if (st[s + 1] != st[s]) continue;                // uniform
      if (t == 0 && n_out != nullptr) n_out[s] = 0.f;
      float* z = sf_out + (size_t)s * dp + c0;
      if (vec) {
        for (int a = t; a < dc / 4; a += nt)
          reinterpret_cast<float4*>(z)[a] = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        for (int a = t; a < dc; a += nt) z[a] = 0.f;
      }
    }
  });
  // the non-empty segments, in order (the sort's scratch is free)
  for (int s = threadIdx.x; s < S; s += FOLD_THREADS)
    scratch[s] = start[s + 1] != start[s];
  __syncthreads();
  const int nl = block_scan_excl(scratch, S, scratch + S);
  for (int s = threadIdx.x; s < S; s += FOLD_THREADS)
    if (start[s + 1] != start[s]) live[scratch[s]] = s;
  __syncthreads();
  if (n_out != nullptr) {
    for (int e = threadIdx.x; e < nl; e += FOLD_THREADS) {
      const int s = live[e];
      float acc = 0.f;
      for (int i = start[s]; i < start[s + 1]; ++i) acc += w[idx[i]];
      n_out[s] = acc;
    }
  }
  if (vec) {
    // (segment, four features) entries, consecutive threads on
    // consecutive quads of one segment
    const int dq = dc >> 2;
    for (int e = threadIdx.x; e < nl * dq; e += FOLD_THREADS) {
      const int s = live[e / dq], a = c0 + 4 * (e % dq);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int i = start[s]; i < start[s + 1]; ++i) {
        const int p = idx[i];
        const float wp = w[p];
        const float4 v =
            *reinterpret_cast<const float4*>(f + (size_t)p * dp + a);
        acc.x = fmaf(wp, v.x, acc.x);
        acc.y = fmaf(wp, v.y, acc.y);
        acc.z = fmaf(wp, v.z, acc.z);
        acc.w = fmaf(wp, v.w, acc.w);
      }
      *reinterpret_cast<float4*>(sf_out + (size_t)s * dp + a) = acc;
    }
  } else {
    for (int e = threadIdx.x; e < nl * dc; e += FOLD_THREADS) {
      const int s = live[e / dc], a = c0 + e % dc;
      float acc = 0.f;
#pragma unroll 4
      for (int i = start[s]; i < start[s + 1]; ++i) {
        const int p = idx[i];
        acc = fmaf(w[p], f[(size_t)p * dp + a], acc);
      }
      sf_out[(size_t)s * dp + a] = acc;
    }
  }
}

// The tile of the wrapper's plan: 128 points where that gives at least
// LE_BLOCKS blocks, else 64.
__host__ inline int ef_tile(int n) {
  return ((long long)n + 127) / 128 >= LE_BLOCKS ? 128 : 64;
}

template <int BM, int MINB>
int launch_ef(int smem, const LinearTileArgs& a, cudaStream_t stream) {
  const auto kernel = sweep_linear_ef<BM, le_stages(BM), MINB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = ((long long)a.n + BM - 1) / BM;
  kernel<<<(unsigned)grid, LE_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// bm, smem_e, f_thread, fc and smem_f are the wrapper's linear_plan.
extern "C" int sweep_linear_launch(
    const float* feats, int n, int dp, const float* w, const float* cst,
    const float* logw, const int* active, const int* slots, int K,
    const float* subw, const float* subconst, const float* sublogw,
    const float* valid, const long long* gidx, const long long* key_z,
    const long long* key_zb, int bm, int smem_e, int f_thread, int fc,
    int smem_f, int* labels, int* sublabels, float* n2, float* sf2,
    void* stream) {
  using namespace repro_torch;
  if (n <= 0 || dp <= 0 || dp > 65536 || K <= 0 || K > LIN_MAX_K)
    return (int)cudaErrorInvalidValue;
  if (bm != ef_tile(n) || f_thread != (dp <= LE_F_THREAD_DP ? 1 : 0) ||
      (size_t)smem_e !=
          sizeof(float) * lt_smem_words(true, true, bm, le_stages(bm), K) ||
      fc != FOLD_FC || (size_t)smem_f != sizeof(int) * fold_smem_ints(2 * K))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  LinearTileArgs a{};
  a.feats = feats;
  a.n = n;
  a.dp = dp;
  a.w = w;
  a.cst = cst;
  a.logw = logw;
  a.active = active;
  a.slots = slots;
  a.K = K;
  a.subw = subw;
  a.subconst = subconst;
  a.sublogw = sublogw;
  a.gidx = gidx;
  a.key_z = key_z;
  a.key_zb = key_zb;
  // the chunk copies and step (f)'s lane layout: 16-byte rows
  a.vec = (dp & 3) == 0 &&
          (((uintptr_t)feats | (uintptr_t)w | (uintptr_t)subw) & 15) == 0;
  a.f_thread = f_thread;
  a.labels = labels;
  a.sublabels = sublabels;
  // 128 points: a two-chunk ring, three blocks an SM (at most 85
  // registers, for the draws' latency); 64 (small N, the 20newsgroups
  // width): a four-chunk ring, two
  const int err = bm == 128 ? launch_ef<128, 3>(smem_e, a, s)
                            : launch_ef<64, 2>(smem_e, a, s);
  if (err != 0) return err;
  cudaError_t e2 = cudaFuncSetAttribute(
      sweep_linear_fold, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_f);
  if (e2 != cudaSuccess) return (int)e2;
  const dim3 grid((n + STATS_BLOCK - 1) / STATS_BLOCK,
                  (dp + FOLD_FC - 1) / FOLD_FC);
  sweep_linear_fold<<<grid, FOLD_THREADS, smem_f, s>>>(
      feats, n, dp, labels, sublabels, valid, K, n2, sf2);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
