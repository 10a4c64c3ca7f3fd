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
//     would not give two blocks an SM), steps (e) and (f):
//     - the active slots are listed by a block-wide scan, and only they
//       are multiplied: chunks of 32 features of the tile's points and of
//       up to 64 active weight rows go to shared memory with cp.async
//       through a ring (two chunks at 128 points, three blocks an SM; four
//       at 64, so a wide d' keeps enough bytes in flight on few blocks),
//       and each thread sums BM / 32 points x 8 slots of dot products in
//       registers, in feature order; the chunk's logits go to shared
//       memory, and the draws run as a loop over (point, slot) pairs cut
//       evenly over the block's threads (unrolled over the register tile,
//       the draws' code would not fit the instruction cache, and a thread
//       a point would idle half the block); each point's (max, least
//       slot) is one 64-bit key, merged by a shared atomic max;
//     - an inactive slot's logit is -1e30 but in the Threefry top bin,
//       where it is +inf (threefry.cuh top_bin): its draw needs the
//       Threefry word and no logarithm, and only a top-bin draw can change
//       the label (the running best starts at (-1e30, slot 0), as the
//       parent's did);
//     - step (f): each point's two sums keep the parent's lane chains
//       (lane l: features 4 l .. 4 l + 3 + 128 t with 16-byte rows, else
//       l + 32 t) and its shuffle-down tree (16, 8, 4, 2, 1). Up to
//       d' = 64 a thread a (point, sub-cluster) runs the 32 chains and the
//       tree itself (lane_tree_sum); above, the tile's points are sorted
//       by label and each warp takes windows of 8 of them, reading a
//       label's two sub-weight rows once for the window's points of that
//       label. The two logits and their Gumbels then run a thread a
//       (point, sub-cluster);
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
// sum the parent's lane chains and tree; n = acc + w and sf = fmaf(w, f,
// acc) over a segment's points in point order. None of it depends on the
// grid.
//
// What bounds it. Step (e) does 2 N K_live d' FLOP on the CUDA cores (fp32,
// no tensor cores, no TF32) and N K Threefry draws (logarithms only for the
// live slots); it reads N d' 4 bytes of features (twice: the fold reads
// them again) and writes nsb 2K (1 + d') 4 bytes of partials. At the
// multinomial fit's shapes (N = 1e6, d' = 128, 16 live of 32 slots) that
// is 4 GFLOP against 0.5 GB (1 GB with the fold's second read): bytes
// bound it, near 0.15-0.3 ms, with the draws' issue about as long.
//
// Limits: 1 <= d' <= 65536, 1 <= K <= 2048 (slot lists and segment
// offsets live in shared memory).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "assign_tile.cuh"
#include "block_stats.cuh"
#include "threefry.cuh"

namespace repro_torch {

constexpr int LE_THREADS = 256;
constexpr int LE_BK = 64;          // active slots a chunk
constexpr int LIN_MAX_K = 2048;
constexpr int FOLD_THREADS = 256;
constexpr int FOLD_FC = 128;       // features a fold block
constexpr int LG_S = LE_BK + 1;    // row stride of a chunk's staged logits

// Shared memory of sweep_linear_ef<BM, STAGES> for K slots (floats or
// ints): a ring of STAGES chunk buffers of BM + LE_BK rows, per point the
// packed running best (two words), the slot order (K), the scan's flags
// (K + 1, then the label counts) and warp totals (32), and per point the
// label, the sorted order, the Gumbel counter and step (f)'s two sums.
__host__ __device__ inline size_t ef_smem_words(int bm, int stages, int K) {
  return (size_t)stages * (bm + LE_BK) * FSTR + 2 * (size_t)K + 1 + 32 +
         7 * (size_t)bm;
}

// Shared ints (or floats) of sweep_linear_fold for S = 2K segments: seg,
// idx and the weights (STATS_BLOCK each), start (S + 1), the sort's
// scratch and the non-empty segments (S).
__host__ __device__ inline size_t fold_smem_ints(int S) {
  return 3 * (size_t)STATS_BLOCK + (S + 1) + sort_scratch_ints(S) + S;
}

// Stage feature chunk [c0, c0 + DC) of the tile's np points (BM rows) and
// of the active weight rows act[0..na) into fsb (BM rows) and wsb (the
// next LE_BK rows) of one ring stage, zero past the edges; 16-byte copies
// when every row starts 16-byte aligned (``vec``). The caller commits.
template <int BM>
__device__ __forceinline__ void ef_stage(const float* __restrict__ fb,
                                         const float* __restrict__ w, int dp,
                                         int np, int c0, const int* act,
                                         int na, bool vec, float* fsb,
                                         float* wsb) {
  if (vec) {
    constexpr int Q = DC / 4;
    for (int e = threadIdx.x; e < (BM + na) * Q; e += LE_THREADS) {
      const int r = e / Q, col = c0 + 4 * (e - r * Q);
      const bool pt = r < BM;
      const int row = pt ? r : act[r - BM];
      const bool in = col < dp && (!pt || row < np);
      const float* src = pt ? fb + (size_t)row * dp : w + (size_t)row * dp;
      float* dst = (pt ? fsb + r * FSTR : wsb + (r - BM) * FSTR) + col - c0;
      cp_async16(dst, in ? src + col : fb, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < (BM + na) * DC; e += LE_THREADS) {
      const int r = e / DC, col = c0 + (e - r * DC);
      const bool pt = r < BM;
      const int row = pt ? r : act[r - BM];
      const bool in = col < dp && (!pt || row < np);
      const float* src = pt ? fb + (size_t)row * dp : w + (size_t)row * dp;
      float* dst = (pt ? fsb + r * FSTR : wsb + (r - BM) * FSTR) + col - c0;
      cp_async4(dst, in ? src + col : fb, in ? 4 : 0);
    }
  }
}

// A point's running first maximum as one 64-bit key: the logit's bits in
// an order-preserving form (-0 as +0, so the two tie as `==` has them),
// then the slot inverted, so that the larger key is the larger logit and,
// among equal logits, the smaller slot: the order take_best keeps.
__device__ __forceinline__ unsigned long long best_key(float v, int slot) {
  uint32_t u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (0xFFFFFFFFu - (uint32_t)slot);
}
__device__ __forceinline__ int best_slot(unsigned long long key) {
  return (int)(0xFFFFFFFFu - (uint32_t)key);
}

// The block's pairs e = (point e / per, item e % per), e < total, cut into
// one run a thread: f(p, item, bv, bl) folds an item into the point's
// local (max, least slot) (take_best: NaN never wins); each point's
// result is merged into best[p] by a shared-memory atomic max, so the
// merge order does not matter.
template <class F>
__device__ __forceinline__ void pair_walk(int total, int per, F f,
                                          unsigned long long* best) {
  const int run = (total + blockDim.x - 1) / blockDim.x;
  const int e0 = threadIdx.x * run, e1 = min(e0 + run, total);
  int p = -1;
  float bv = NEG_INF;
  int bl = INT_MAX;
#pragma unroll 2
  for (int e = e0; e < e1; ++e) {
    const int q = e / per;
    if (q != p) {
      if (bl != INT_MAX) atomicMax(best + p, best_key(bv, bl));
      p = q;
      bv = NEG_INF;
      bl = INT_MAX;
    }
    f(q, e - q * per, bv, bl);
  }
  if (bl != INT_MAX) atomicMax(best + p, best_key(bv, bl));
}

// One point's step-(f) sum against sub-weight row wr as the first
// version's warp computed it (linear_sub_assign): lane l's chain over
// features 4 l .. 4 l + 3 + 128 t (VEC, 16-byte rows) or l + 32 t, in
// order, then the shuffle-down tree (16, 8, 4, 2, 1) that leaves lane 0
// ((v0 + v16) + (v8 + v24)) + ... . Here one thread walks the 32 chains in
// the tree's leaf order (five bits of the leaf index reversed) and folds
// each finished pair on a five-deep stack, so every add has the operands
// of the tree's.
template <bool VEC>
__device__ __forceinline__ float lane_tree_sum(const float* __restrict__ xp,
                                               const float* __restrict__ wr,
                                               int dp) {
  float stk[5];
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int l = (int)(__brev((unsigned)i) >> 27);
    v = 0.f;
    if (VEC) {
      for (int c = 4 * l; c < dp; c += 128) {
        const float4 x4 = *reinterpret_cast<const float4*>(xp + c);
        const float4 w4 = __ldg(reinterpret_cast<const float4*>(wr + c));
        v = fmaf(x4.x, w4.x, v);
        v = fmaf(x4.y, w4.y, v);
        v = fmaf(x4.z, w4.z, v);
        v = fmaf(x4.w, w4.w, v);
      }
    } else {
      for (int c = l; c < dp; c += 32) v = fmaf(xp[c], __ldg(wr + c), v);
    }
    // leaf i closes the pairs of its trailing one bits
#pragma unroll
    for (int lvl = 0; lvl < 5; ++lvl) {
      if (((i >> lvl) & 1) == 0) {
        stk[lvl] = v;
        break;
      }
      v = stk[lvl] + v;
    }
  }
  return v;
}

// BM points a block, a ring of STAGES feature chunks, MINB blocks an SM.
template <int BM, int STAGES, int MINB>
__global__ void __launch_bounds__(LE_THREADS, MINB) sweep_linear_ef(
    const float* __restrict__ feats, int n, int dp,
    const float* __restrict__ w, const float* __restrict__ cst,
    const float* __restrict__ logw, const int* __restrict__ active,
    const int* __restrict__ slots, int K, const float* __restrict__ subw,
    const float* __restrict__ subconst, const float* __restrict__ sublogw,
    const long long* __restrict__ gidx, const long long* __restrict__ key_z,
    const long long* __restrict__ key_zb, int vec_i, int f_thread,
    int* __restrict__ labels, int* __restrict__ sublabels) {
  constexpr int TI = BM / 32;          // points a thread: ty + 32 i
  extern __shared__ __align__(16) float ef_smem[];
  constexpr int SROWS = (BM + LE_BK) * FSTR;          // floats a stage
  float* ring = ef_smem;                               // STAGES SROWS
  // each point's running (max, least slot), packed (best_key)
  unsigned long long* best =
      reinterpret_cast<unsigned long long*>(ring + STAGES * SROWS);   // BM
  int* order = reinterpret_cast<int*>(best + BM);      // K
  int* flag = order + K;                               // K + 1
  int* tmp = flag + K + 1;                             // 32
  int* lab = tmp + 32;                                 // BM
  int* sidx = lab + BM;                                // BM
  uint32_t* gs = reinterpret_cast<uint32_t*>(sidx + BM);   // BM
  float* sum2 = reinterpret_cast<float*>(gs + BM);     // 2 BM: step (f)

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const long long base = (long long)blockIdx.x * BM;
  const int np = (int)min((long long)BM, (long long)n - base);
  const float* fb = feats + base * dp;
  const uint32_t kz0 = (uint32_t)key_z[0], kz1 = (uint32_t)key_z[1];
  const bool vec = vec_i != 0;

  // the active slots in order, then the inactive ones in order
  for (int k = tid; k < K; k += LE_THREADS) flag[k] = active[k] != 0;
  for (int p = tid; p < BM; p += LE_THREADS) {
    best[p] = best_key(NEG_INF, 0);
    gs[p] = p < np ? (uint32_t)gidx[base + p] : 0u;
  }
  __syncthreads();
  const int na = block_scan_excl(flag, K, tmp);
  for (int k = tid; k < K; k += LE_THREADS) {
    const int a = flag[k];
    order[active[k] != 0 ? a : na + k - a] = k;
  }
  __syncthreads();

  // ---- step (e), the live slots: chunks of LE_BK of them ----------------
  const int nch = (dp + DC - 1) / DC;
  for (int a0 = 0; a0 < na; a0 += LE_BK) {
    const int nac = min(LE_BK, na - a0);
    const int* act = order + a0;
    const int jmax = (nac + 7) / 8;
    float acc[TI][8];
#pragma unroll
    for (int i = 0; i < TI; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    // a ring of STAGES chunk buffers, STAGES - 1 copies in flight: the
    // products of chunk ci are summed, in feature order, while chunks
    // ci + 1 .. ci + STAGES - 1 are copied
    __syncthreads();                 // the ring is free (logits read)
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < nch) {
        float* st = ring + i * SROWS;
        ef_stage<BM>(fb, w, dp, np, i * DC, act, nac, vec, st,
                     st + BM * FSTR);
      }
      cp_async_commit();
    }
    for (int ci = 0; ci < nch; ++ci) {
      cp_async_wait<STAGES - 2>();   // chunk ci has landed (this thread)
      __syncthreads();               // ... every thread's; ci - 1 is done
      const int cn = ci + STAGES - 1;
      if (cn < nch) {
        float* st = ring + (cn % STAGES) * SROWS;
        ef_stage<BM>(fb, w, dp, np, cn * DC, act, nac, vec, st,
                     st + BM * FSTR);
      }
      cp_async_commit();
      const float* fsb = ring + (ci % STAGES) * SROWS;
      const float* wsb = fsb + BM * FSTR;
#pragma unroll 1
      for (int c = 0; c < DC; c += 4) {
        float4 av[TI];
#pragma unroll
        for (int i = 0; i < TI; ++i)
          av[i] = *reinterpret_cast<const float4*>(fsb + (ty + 32 * i) * FSTR
                                                   + c);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j < jmax) {
            const float4 b = *reinterpret_cast<const float4*>(
                wsb + (tx + 8 * j) * FSTR + c);
#pragma unroll
            for (int i = 0; i < TI; ++i) {
              float v = fmaf(av[i].x, b.x, acc[i][j]);
              v = fmaf(av[i].y, b.y, v);
              v = fmaf(av[i].z, b.z, v);
              acc[i][j] = fmaf(av[i].w, b.w, v);
            }
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();                 // every product is summed: the ring
                                     // takes the logits
    // the chunk's logits before their noise, acc + const + logw, into the
    // ring ...
    float* lg = ring;                                  // BM x LG_S
#pragma unroll
    for (int i = 0; i < TI; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int pos = tx + 8 * j;
        if (pos < nac) {
          const int c = act[pos];
          float t = acc[i][j] + __ldg(cst + c);
          t = t + __ldg(logw + c);
          lg[(ty + 32 * i) * LG_S + pos] = t;
        }
      }
    }
    __syncthreads();
    // ... then every thread takes a run of (point, slot) pairs, adds the
    // Gumbels and keeps each point's (max, least slot), merged into the
    // point's packed best by an atomic max (order-free: the same result
    // as one walk in slot order)
    pair_walk(np * nac, nac, [&](int p, int pos, float& bv, int& bl) {
      const int c = act[pos];
      take_best(lg[p * LG_S + pos] +
                    gumbel(kz0, kz1, gs[p], (uint32_t)__ldg(slots + c)),
                c, bv, bl);
    }, best);
  }

  // ---- step (e), the inactive slots: -1e30, which never beats the initial
  // (-1e30, slot 0), but +inf in the Threefry top bin -----------------------
  const int ni = K - na;
  pair_walk(np * ni, ni, [&](int p, int q, float& bv, int& bl) {
    const int c = order[na + q];
    if (top_bin(kz0, kz1, gs[p], (uint32_t)__ldg(slots + c)))
      take_best(__int_as_float(0x7f800000), c, bv, bl);       // +inf
  }, best);
  __syncthreads();
  for (int p = tid; p < np; p += LE_THREADS) {
    const int l = best_slot(best[p]);
    lab[p] = l;
    labels[base + p] = l;
  }

  // ---- step (f): each point's two sums into sum2 --------------------------
  const uint32_t kb0 = (uint32_t)key_zb[0], kb1 = (uint32_t)key_zb[1];
  if (f_thread) {
    // narrow d': a thread a (point, sub-cluster) runs all 32 lane chains
    // and the tree itself; the rows come from L2, just read by step (e)
    __syncthreads();
    for (int e = tid; e < 2 * np; e += LE_THREADS) {
      const int q = e % np, sb = e / np;
      const float* wr = subw + (size_t)(2 * lab[q] + sb) * dp;
      const float* xq = fb + (size_t)q * dp;
      sum2[sb * BM + q] = vec ? lane_tree_sum<true>(xq, wr, dp)
                              : lane_tree_sum<false>(xq, wr, dp);
    }
  } else {
    // wide d': the tile's points sorted by label
    for (int k = tid; k <= K; k += LE_THREADS) flag[k] = 0;
    __syncthreads();
    for (int p = tid; p < np; p += LE_THREADS) atomicAdd(flag + lab[p], 1);
    __syncthreads();
    block_scan_excl(flag, K + 1, tmp);
    for (int p = tid; p < np; p += LE_THREADS)
      sidx[atomicAdd(flag + lab[p], 1)] = p;
    __syncthreads();

    // each warp takes windows of 8 sorted points; a window's run of one
    // label reads the label's two sub-weight rows once for all its points
    const int warp = tid >> 5, lane = tid & 31;
    for (int e0 = 8 * warp; e0 < np; e0 += 8 * (LE_THREADS / 32)) {
      const int e1 = min(e0 + 8, np);
      for (int r0 = e0; r0 < e1;) {
        const int l = lab[sidx[r0]];
        int m = 1;
        while (r0 + m < e1 && lab[sidx[r0 + m]] == l) ++m;
        const float* w0 = subw + (size_t)(2 * l) * dp;
        const float* w1 = w0 + dp;
        const float* fp[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          fp[q] = fb + (size_t)sidx[r0 + (q < m ? q : 0)] * dp;
        float s0[8], s1[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          s0[q] = 0.f;
          s1[q] = 0.f;
        }
        if (vec) {
          for (int c = 4 * lane; c < dp; c += 128) {
            const float4 a = __ldg(reinterpret_cast<const float4*>(w0 + c));
            const float4 b = __ldg(reinterpret_cast<const float4*>(w1 + c));
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              if (q < m) {
                const float4 v = *reinterpret_cast<const float4*>(fp[q] + c);
                s0[q] = fmaf(v.x, a.x, s0[q]);
                s0[q] = fmaf(v.y, a.y, s0[q]);
                s0[q] = fmaf(v.z, a.z, s0[q]);
                s0[q] = fmaf(v.w, a.w, s0[q]);
                s1[q] = fmaf(v.x, b.x, s1[q]);
                s1[q] = fmaf(v.y, b.y, s1[q]);
                s1[q] = fmaf(v.z, b.z, s1[q]);
                s1[q] = fmaf(v.w, b.w, s1[q]);
              }
            }
          }
        } else {
          for (int c = lane; c < dp; c += 32) {
            const float a = __ldg(w0 + c), b = __ldg(w1 + c);
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              if (q < m) {
                const float v = fp[q][c];
                s0[q] = fmaf(v, a, s0[q]);
                s1[q] = fmaf(v, b, s1[q]);
              }
            }
          }
        }
        // the parent's tree for each point; lane 0 holds the two sums
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (q < m) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
              s0[q] += __shfl_down_sync(0xffffffffu, s0[q], off);
              s1[q] += __shfl_down_sync(0xffffffffu, s1[q], off);
            }
            if (lane == 0) {
              const int pq = sidx[r0 + q];
              sum2[pq] = s0[q];
              sum2[BM + pq] = s1[q];
            }
          }
        }
        r0 += m;
      }
    }
  }
  __syncthreads();
  // the logits of both sub-clusters, a thread a (point, s), in the parent's
  // order: + subconst, + sublogw, + Gumbel; then the choice, strict `>`
  for (int e = tid; e < 2 * np; e += LE_THREADS) {
    const int p = e % np, s = e / np;
    const int ks = 2 * lab[p] + s;
    float t = sum2[s * BM + p] + subconst[ks];
    t = t + sublogw[ks];
    sum2[s * BM + p] = t + gumbel(kb0, kb1, gs[p], (uint32_t)s);
  }
  __syncthreads();
  for (int p = tid; p < np; p += LE_THREADS)
    sublabels[base + p] = sum2[BM + p] > sum2[p] ? 1 : 0;
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
// 2 x 132 blocks (two an SM of the H100), else 64; and its ring depth.
__host__ inline int ef_tile(int n) {
  return ((long long)n + 127) / 128 >= 2 * 132 ? 128 : 64;
}
__host__ inline int ef_stages(int bm) { return bm == 128 ? 2 : 4; }
// Step (f) a thread a (point, sub-cluster) up to d' = LE_F_THREAD_DP, a
// warp a run of one label's points above (wider rows, read 32 rows a load
// by the thread route, cost more than the warp route's shuffles save).
constexpr int LE_F_THREAD_DP = 64;

template <int BM, int STAGES, int MINB>
int launch_ef(int smem, const float* feats, int n, int dp, const float* w,
              const float* cst, const float* logw, const int* active,
              const int* slots, int K, const float* subw,
              const float* subconst, const float* sublogw,
              const long long* gidx, const long long* key_z,
              const long long* key_zb, int f_thread, int* labels,
              int* sublabels, cudaStream_t stream) {
  const auto kernel = sweep_linear_ef<BM, STAGES, MINB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // step (f)'s lane layout and the chunk copies: 16-byte rows
  const int vec = (dp & 3) == 0 &&
                  (((uintptr_t)feats | (uintptr_t)w | (uintptr_t)subw) &
                   15) == 0;
  const long long grid = ((long long)n + BM - 1) / BM;
  kernel<<<(unsigned)grid, LE_THREADS, smem, stream>>>(
      feats, n, dp, w, cst, logw, active, slots, K, subw, subconst, sublogw,
      gidx, key_z, key_zb, vec, f_thread, labels, sublabels);
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
      (size_t)smem_e != sizeof(float) * ef_smem_words(bm, ef_stages(bm), K) ||
      fc != FOLD_FC || (size_t)smem_f != sizeof(int) * fold_smem_ints(2 * K))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 128 points: a two-chunk ring, three blocks an SM (at most 85
  // registers, for the draws' latency); 64 (small N, the 20newsgroups
  // width): a four-chunk ring, two
  const int err =
      bm == 128 ? launch_ef<128, 2, 3>(smem_e, feats, n, dp, w, cst, logw,
                                       active, slots, K, subw, subconst,
                                       sublogw, gidx, key_z, key_zb, f_thread,
                                       labels, sublabels, s)
                : launch_ef<64, 4, 2>(smem_e, feats, n, dp, w, cst, logw,
                                      active, slots, K, subw, subconst,
                                      sublogw, gidx, key_z, key_zb, f_thread,
                                      labels, sublabels, s);
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
