// Steps (e) and (f) of the restricted sampler for the linear-likelihood
// families (multinomial, Poisson, diagonal Gaussian) on one tile of BM
// points: one device function, linear_tile<BM, STAGES, E, F, FW, ROUTE>,
// with two compile-time switches (E, F), run by the three kernels of
// these families:
//  - sweep_linear.cu: (e) + (f), then the sub-cluster first-moment fold;
//  - assign_linear.cu: (e) alone (DPMMEngine.sample; the three-pass
//    sweep's first pass);
//  - sub_assign_linear.cu: (f) alone under the caller's labels (the
//    three-pass sweep's second pass); a label outside [0, K) gets
//    sub-label 0.
// So the three-pass path draws the one-read sweep's labels and sub-labels
// bit for bit: there is one copy of the chains.
//
// Each family packs its log-likelihood as a linear form of per-point
// features f (x, or [x, x^2]): loglik_k(x) = f . w_k + const_k. Per point
// i with Gumbel counter gidx[i]:
//   (e) z_i  = first argmax_k [ (f_i . w_k + const_k) + logw_k  (-1e30 if
//              the slot is inactive) + Gumbel(key_z, gidx_i, slots_k) ]
//   (f) zb_i = first argmax_s [ (f_i . subw_{z_i,s} + subconst_{z_i,s})
//              + sublogw_{z_i,s} + Gumbel(key_zb, gidx_i, s) ],  s in {0, 1}
//
// Step (e). The slots run in windows of at most LE_WIN, so no shared
// array grows past that whatever K is. In a window the active slots are
// listed by a block-wide scan, and only they are multiplied: chunks of 32
// features of the tile's points and of up to 64 active weight rows go to
// shared memory with cp.async through a ring of STAGES chunks, and each
// thread sums BM / 32 points x 8 slots of dot products in registers, in
// feature order; the chunk's logits go to shared memory, and the draws
// run as a loop over (point, slot) pairs cut evenly over the block's
// threads. Each point's (max, least slot) is one 64-bit key, merged by a
// shared atomic max: the first maximum does not depend on the merge
// order, so windows and chunks give the bits of one walk in slot order.
// An inactive slot's logit is -1e30 but +inf in
// the Threefry top bin (threefry.cuh top_bin): its draw needs the
// Threefry word and no logarithm, and only a top-bin draw can change the
// label (the running best starts at (-1e30, slot 0)).
//
// Step (f). Each point's two sums keep one chain a lane (lane l: features
// 4 l .. 4 l + 3 + 128 t with 16-byte rows, else l + 32 t) and the
// shuffle-down tree (16, 8, 4, 2, 1) of the first linear kernels. Up to
// d' = LE_F_THREAD_DP (LF_THREAD_DP in step (f) alone) a thread a (point,
// sub-cluster) runs the 32 chains and the tree itself (lane_tree_sum).
// Above, beside step (e), the tile's points are sorted by label (each
// point's rank among the (label, point) pairs: no K-sized array) and each
// warp takes windows of FW of them, whose loads are in flight together (a
// label's two sub-weight rows, read by its sorted neighbours, come from
// L1 after the first). In step (f) alone there is no sort: each warp
// takes a run of up to 32 consecutive points in windows of FW
// (window_sums), lane q of the run keeps point q's two sums, and then
// every lane of the run finishes its own point, with no barrier (on the
// warp route, a kernel of its own, with nothing staged: f_direct). A logit
// is the sum + subconst, + sublogw, + Gumbel (sub_logit), and the choice
// strict `>`.
//
// Blocks of LE_THREADS threads; the launchers take their tile and shared
// bytes from the wrappers' plans (kernels/sweep.py linear_plan,
// kernels/assign.py linear_assign_plan and linear_sub_plan) and refuse any
// other.
#pragma once

#include <limits.h>
#include <stdint.h>

#include "assign_tile.cuh"
#include "block_stats.cuh"
#include "threefry.cuh"

namespace repro_torch {

constexpr int LE_THREADS = 256;
constexpr int LE_BK = 64;          // active slots a chunk
constexpr int LE_WIN = 2048;       // slots a window of step (e)
constexpr int DC = 32;             // features a staged chunk
constexpr int FSTR = DC + 4;       // padded row stride (16-byte rows)
constexpr int LG_S = LE_BK + 1;    // row stride of a chunk's staged logits
constexpr int LE_BLOCKS = 2 * 132; // blocks that fill the H100 (two an SM)
// Step (f) a thread a (point, sub-cluster) up to this d', a warp a window
// of points above: beside step (e) (the rows just read) and alone.
constexpr int LE_F_THREAD_DP = 64;
constexpr int LF_THREAD_DP = 32;
constexpr int LE_FW = 8;           // step (f)'s window beside step (e)
// Step (f)'s route: chosen at run time by LinearTileArgs::f_thread, or
// fixed at compile time (one kernel a route, each with the registers of
// its own code).
constexpr int F_BY_ARGS = 0, F_THREAD = 1, F_WARP = 2;

// Step (f) alone on the warp route reads each point's label and Gumbel
// counter from global memory where it needs them: no staging, no barrier.
__host__ __device__ constexpr bool f_direct(bool e, int route) {
  return !e && route == F_WARP;
}

// The operands of a tile; the mode's unused pointers may be null.
struct LinearTileArgs {
  const float* feats;
  int n, dp;
  const float* w;
  const float* cst;
  const float* logw;
  const int* active;
  const int* slots;
  int K;
  const float* subw;
  const float* subconst;
  const float* sublogw;
  const long long* gidx;
  const long long* key_z;
  const long long* key_zb;
  int vec;        // 16-byte rows: the chunk copies and step (f)'s lanes
  int f_thread;   // step (f) a thread a (point, sub-cluster)
  const int* labels_in;          // step (f) alone: the caller's labels
  int* labels;
  int* sublabels;
};

// The ring depth of a tile of bm points (four chunks keep enough bytes of
// a wide d' in flight on the few blocks of a small N).
__host__ __device__ constexpr int le_stages(int bm) {
  return bm == 128 ? 2 : 4;
}

// Shared words (floats or ints) of linear_tile for K slots: with step (e)
// the chunk ring, each point's packed best (two words), the window's slot
// order and scan flags and the scan's warp totals; each point's Gumbel
// counter; with step (f) its label, sorted place and two sums.
__host__ __device__ inline size_t lt_smem_words(bool e, bool f, int bm,
                                                int stages, int K) {
  const size_t win = (size_t)(K < LE_WIN ? K : LE_WIN);
  size_t words = (size_t)bm * (f ? 5 : 1);
  if (e)
    words += (size_t)stages * (bm + LE_BK) * FSTR + 2 * (size_t)bm +
             2 * win + 1 + 32;
  return words;
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

// One point's step-(f) sum against sub-weight row wr as the warp route
// computes it: lane l's chain over features 4 l .. 4 l + 3 + 128 t (VEC,
// 16-byte rows) or l + 32 t, in order, then the shuffle-down tree (16, 8,
// 4, 2, 1) that leaves lane 0 ((v0 + v16) + (v8 + v24)) + ... . Here one
// thread walks the 32 chains in the tree's leaf order (five bits of the
// leaf index reversed) and folds each finished pair on a five-deep stack,
// so every add has the operands of the tree's.
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

// Step (e) over the tile's np points fb: each point's (max, least slot)
// merged into best[p].
template <int BM, int STAGES>
__device__ __forceinline__ void tile_step_e(
    const LinearTileArgs& a, const float* __restrict__ fb, int np,
    const uint32_t* gs, float* ring, unsigned long long* best, int* order,
    int* flag, int* tmp) {
  constexpr int TI = BM / 32;          // points a thread: ty + 32 i
  constexpr int SROWS = (BM + LE_BK) * FSTR;          // floats a stage
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int dp = a.dp, K = a.K;
  const bool vec = a.vec != 0;
  const uint32_t kz0 = (uint32_t)a.key_z[0], kz1 = (uint32_t)a.key_z[1];
  const int nch = (dp + DC - 1) / DC;
  for (int k0 = 0; k0 < K; k0 += LE_WIN) {
    const int wn = min(LE_WIN, K - k0);
    __syncthreads();                 // the last window's lists are read
    // the window's active slots in order, then its inactive ones
    for (int k = tid; k < wn; k += LE_THREADS)
      flag[k] = a.active[k0 + k] != 0;
    __syncthreads();
    const int na = block_scan_excl(flag, wn, tmp);
    for (int k = tid; k < wn; k += LE_THREADS) {
      const int c = flag[k];
      order[a.active[k0 + k] != 0 ? c : na + k - c] = k0 + k;
    }
    __syncthreads();

    // ---- the live slots: chunks of LE_BK of them -------------------------
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
      __syncthreads();               // the ring is free (logits read)
#pragma unroll
      for (int i = 0; i < STAGES - 1; ++i) {
        if (i < nch) {
          float* st = ring + i * SROWS;
          ef_stage<BM>(fb, a.w, dp, np, i * DC, act, nac, vec, st,
                       st + BM * FSTR);
        }
        cp_async_commit();
      }
      for (int ci = 0; ci < nch; ++ci) {
        cp_async_wait<STAGES - 2>(); // chunk ci has landed (this thread)
        __syncthreads();             // ... every thread's; ci - 1 is done
        const int cn = ci + STAGES - 1;
        if (cn < nch) {
          float* st = ring + (cn % STAGES) * SROWS;
          ef_stage<BM>(fb, a.w, dp, np, cn * DC, act, nac, vec, st,
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
            av[i] = *reinterpret_cast<const float4*>(
                fsb + (ty + 32 * i) * FSTR + c);
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
      __syncthreads();               // every product is summed: the ring
                                     // takes the logits
      // the chunk's logits before their noise, acc + const + logw, into
      // the ring ...
      float* lg = ring;                                // BM x LG_S
#pragma unroll
      for (int i = 0; i < TI; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int pos = tx + 8 * j;
          if (pos < nac) {
            const int c = act[pos];
            float t = acc[i][j] + __ldg(a.cst + c);
            t = t + __ldg(a.logw + c);
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
                      gumbel(kz0, kz1, gs[p], (uint32_t)__ldg(a.slots + c)),
                  c, bv, bl);
      }, best);
    }

    // ---- the inactive slots: -1e30, which never beats the initial
    // (-1e30, slot 0), but +inf in the Threefry top bin ---------------------
    const int ni = wn - na;
    const int* inact = order + na;
    pair_walk(np * ni, ni, [&](int p, int q, float& bv, int& bl) {
      const int c = inact[q];
      if (top_bin(kz0, kz1, gs[p], (uint32_t)__ldg(a.slots + c)))
        take_best(__int_as_float(0x7f800000), c, bv, bl);     // +inf
    }, best);
  }
  __syncthreads();                   // every window is merged
}

// The two sums of each of a window's FW points q (pq[q], a row of fb;
// lq[q] its label, < 0: no sums) against its label's two sub-weight rows:
// lane l's chain over features 4 l .. 4 l + 3 + 128 t (vec: 16-byte rows)
// or l + 32 t, in order, with the loads of every point in flight
// together, then the shuffle-down tree (16, 8, 4, 2, 1): lane 0 holds
// every point's two sums. All 32 lanes of the warp call it. HOIST reads
// every point's feature chunk (pq[q] is a point of the tile for every q)
// before any sum, so that those loads are in flight together.
template <int FW, bool HOIST>
__device__ __forceinline__ void window_sums(
    const float* __restrict__ subw, const float* __restrict__ fb, int dp,
    bool vec, const int (&pq)[FW], const int (&lq)[FW], int lane,
    float (&s0)[FW], float (&s1)[FW]) {
#pragma unroll
  for (int q = 0; q < FW; ++q) {
    s0[q] = 0.f;
    s1[q] = 0.f;
  }
  if (vec) {
    for (int c = 4 * lane; c < dp; c += 128) {
      float4 xv[FW];
      if (HOIST) {
#pragma unroll
        for (int q = 0; q < FW; ++q)
          xv[q] = *reinterpret_cast<const float4*>(
              fb + (size_t)pq[q] * dp + c);
      }
#pragma unroll
      for (int q = 0; q < FW; ++q) {
        if (lq[q] >= 0) {            // uniform over the warp
          const float* w0 = subw + (size_t)(2 * lq[q]) * dp + c;
          const float4 u = __ldg(reinterpret_cast<const float4*>(w0));
          const float4 b = __ldg(reinterpret_cast<const float4*>(w0 + dp));
          const float4 v = HOIST ? xv[q] : *reinterpret_cast<const float4*>(
              fb + (size_t)pq[q] * dp + c);
          s0[q] = fmaf(v.x, u.x, s0[q]);
          s0[q] = fmaf(v.y, u.y, s0[q]);
          s0[q] = fmaf(v.z, u.z, s0[q]);
          s0[q] = fmaf(v.w, u.w, s0[q]);
          s1[q] = fmaf(v.x, b.x, s1[q]);
          s1[q] = fmaf(v.y, b.y, s1[q]);
          s1[q] = fmaf(v.z, b.z, s1[q]);
          s1[q] = fmaf(v.w, b.w, s1[q]);
        }
      }
    }
  } else {
    for (int c = lane; c < dp; c += 32) {
      float xs[FW];
      if (HOIST) {
#pragma unroll
        for (int q = 0; q < FW; ++q) xs[q] = fb[(size_t)pq[q] * dp + c];
      }
#pragma unroll
      for (int q = 0; q < FW; ++q) {
        if (lq[q] >= 0) {
          const float* w0 = subw + (size_t)(2 * lq[q]) * dp + c;
          const float v = HOIST ? xs[q] : fb[(size_t)pq[q] * dp + c];
          s0[q] = fmaf(v, __ldg(w0), s0[q]);
          s1[q] = fmaf(v, __ldg(w0 + dp), s1[q]);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < FW; ++q) {
    if (lq[q] >= 0) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s0[q] += __shfl_down_sync(0xffffffffu, s0[q], off);
        s1[q] += __shfl_down_sync(0xffffffffu, s1[q], off);
      }
    }
  }
}

// Sub-cluster s's logit from its sum under label slot ks = 2 l + s:
// + subconst, + sublogw, + Gumbel(key_zb, g, s), in that order.
__device__ __forceinline__ float sub_logit(const LinearTileArgs& a,
                                           float sum, int ks, uint32_t kb0,
                                           uint32_t kb1, uint32_t g, int s) {
  float t = sum + a.subconst[ks];
  t = t + a.sublogw[ks];
  return t + gumbel(kb0, kb1, g, (uint32_t)s);
}

// Step (f) over the tile's np points fb, under lab[p]; sub-labels to
// a.sublabels. With a.f_thread a thread a (point, sub-cluster) runs the
// 32 lane chains and the tree itself, into sum2[s BM + p]. Else beside
// step (e) each warp takes windows of FW points sorted by label (a
// label's rows, read by its neighbours, come from L1 after the first)
// into sum2; alone (CHECKED) each warp takes a run of PB = min(32, BM / 8)
// consecutive points in windows of FW, lane q of the run keeps point q's
// two sums, and each lane of the run finishes its point (the logits and
// the choice), with no barrier. The logits and the choice otherwise run
// a thread a (point, s). Without step (e) a label outside [0, K) gets
// sub-label 0 and reads no row.
template <int BM, int FW, bool CHECKED, int ROUTE>
__device__ __forceinline__ void tile_step_f(
    const LinearTileArgs& a, const float* __restrict__ fb, int np,
    long long base, const uint32_t* gs, const int* lab, int* sidx,
    float* sum2) {
  const int tid = threadIdx.x, dp = a.dp, K = a.K;
  const int warp = tid >> 5, lane = tid & 31;
  const bool vec = a.vec != 0;
  const uint32_t kb0 = (uint32_t)a.key_zb[0], kb1 = (uint32_t)a.key_zb[1];
  auto valid = [&](int l) { return !CHECKED || (l >= 0 && l < K); };
  constexpr bool DIRECT = f_direct(!CHECKED, ROUTE);
  if constexpr (!DIRECT) __syncthreads();   // every label is in lab
  if (ROUTE == F_BY_ARGS ? a.f_thread != 0 : ROUTE == F_THREAD) {
    // narrow d': a thread a (point, sub-cluster) runs all 32 lane chains
    // and the tree itself
    for (int e = tid; e < 2 * np; e += LE_THREADS) {
      const int q = e % np, sb = e / np;
      const int l = lab[q];
      float s = 0.f;
      if (valid(l)) {
        const float* wr = a.subw + (size_t)(2 * l + sb) * dp;
        const float* xq = fb + (size_t)q * dp;
        s = vec ? lane_tree_sum<true>(xq, wr, dp)
                : lane_tree_sum<false>(xq, wr, dp);
      }
      sum2[sb * BM + q] = s;
    }
  } else if constexpr (CHECKED) {
    // alone: each warp a run of PB consecutive points, in windows of FW
    constexpr int PB = BM / (LE_THREADS / 32) < 32 ? BM / (LE_THREADS / 32)
                                                   : 32;
    const int* lb = DIRECT ? a.labels_in + base : lab;
    for (int b0 = PB * warp; b0 < np; b0 += PB * (LE_THREADS / 32)) {
      const int nb = min(PB, np - b0);
      float t0 = 0.f, t1 = 0.f;      // lane q: point b0 + q's two sums
      for (int w0 = 0; w0 < nb; w0 += FW) {
        const int m = min(FW, nb - w0);
        int pq[FW], lq[FW];
#pragma unroll
        for (int q = 0; q < FW; ++q) {
          pq[q] = b0 + w0 + (q < m ? q : 0);
          lq[q] = q < m && valid(lb[pq[q]]) ? lb[pq[q]] : -1;
        }
        float s0[FW], s1[FW];
        window_sums<FW, true>(a.subw, fb, dp, vec, pq, lq, lane, s0, s1);
        // lane w0 + q takes point q's two sums from lane 0
#pragma unroll
        for (int q = 0; q < FW; ++q) {
          const float v0 = __shfl_sync(0xffffffffu, s0[q], 0);
          const float v1 = __shfl_sync(0xffffffffu, s1[q], 0);
          if (lane == w0 + q) {
            t0 = v0;
            t1 = v1;
          }
        }
      }
      if (lane < nb) {
        const int p = b0 + lane, l = lb[p];
        int zb = 0;
        if (valid(l)) {
          const uint32_t g = DIRECT ? (uint32_t)a.gidx[base + p] : gs[p];
          t0 = sub_logit(a, t0, 2 * l, kb0, kb1, g, 0);
          t1 = sub_logit(a, t1, 2 * l + 1, kb0, kb1, g, 1);
          zb = t1 > t0 ? 1 : 0;
        }
        a.sublabels[base + p] = zb;
      }
    }
    return;                          // every thread of the block
  } else {
    // beside step (e): the tile's points sorted by label, each point
    // placed at its rank among the (label, point) pairs, counted by
    // LE_THREADS / BM threads a point (sum2 holds the ranks until the sums)
    constexpr int PARTS = LE_THREADS / BM;
    int* rk = reinterpret_cast<int*>(sum2);
    for (int p = tid; p < BM; p += LE_THREADS) rk[p] = 0;
    __syncthreads();
    {
      const int p = tid % BM, part = tid / BM;
      if (p < np) {
        const int l = lab[p];
        int r = 0;
        for (int q = part; q < np; q += PARTS) {
          const int m = lab[q];
          r += (m < l || (m == l && q < p)) ? 1 : 0;
        }
        atomicAdd(rk + p, r);
      }
    }
    __syncthreads();
    for (int p = tid; p < np; p += LE_THREADS) sidx[rk[p]] = p;
    __syncthreads();
    for (int e0 = FW * warp; e0 < np; e0 += FW * (LE_THREADS / 32)) {
      const int m = min(FW, np - e0);
      int pq[FW], lq[FW];            // the window's points and labels
#pragma unroll
      for (int q = 0; q < FW; ++q) {
        pq[q] = sidx[e0 + (q < m ? q : 0)];
        lq[q] = q < m ? lab[pq[q]] : -1;
      }
      float s0[FW], s1[FW];
      window_sums<FW, false>(a.subw, fb, dp, vec, pq, lq, lane, s0, s1);
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < FW; ++q) {
          if (lq[q] >= 0) {
            sum2[pq[q]] = s0[q];
            sum2[BM + pq[q]] = s1[q];
          }
        }
      }
    }
  }
  __syncthreads();
  // the logits of both sub-clusters, a thread a (point, s); then the
  // choice, strict `>`
  for (int e = tid; e < 2 * np; e += LE_THREADS) {
    const int p = e % np, s = e / np;
    const int l = lab[p];
    if (!valid(l)) continue;
    sum2[s * BM + p] = sub_logit(a, sum2[s * BM + p], 2 * l + s, kb0, kb1,
                                 gs[p], s);
  }
  __syncthreads();
  for (int p = tid; p < np; p += LE_THREADS)
    a.sublabels[base + p] =
        valid(lab[p]) && sum2[BM + p] > sum2[p] ? 1 : 0;
}

// The tile of blockIdx.x: step (e) if E (labels to a.labels), step (f) if
// F (under step (e)'s labels, else under a.labels_in) in windows of FW
// points, on step (f)'s ROUTE. smem holds lt_smem_words(E, F, BM, STAGES,
// K) words.
template <int BM, int STAGES, bool E, bool F, int FW, int ROUTE = F_BY_ARGS>
__device__ __forceinline__ void linear_tile(const LinearTileArgs& a,
                                            float* smem) {
  static_assert(E || F, "a tile runs step (e), step (f) or both");
  const long long base = (long long)blockIdx.x * BM;
  const int np = (int)min((long long)BM, (long long)a.n - base);
  const float* fb = a.feats + base * a.dp;
  const int win = a.K < LE_WIN ? a.K : LE_WIN;
  float* ring = smem;
  unsigned long long* best = reinterpret_cast<unsigned long long*>(
      ring + (E ? STAGES * (BM + LE_BK) * FSTR : 0));   // BM (E)
  int* order = reinterpret_cast<int*>(best + (E ? BM : 0));   // win (E)
  int* flag = order + (E ? win : 0);                  // win + 1 (E)
  int* tmp = flag + (E ? win + 1 : 0);                // 32 (E)
  uint32_t* gs = reinterpret_cast<uint32_t*>(tmp + (E ? 32 : 0));   // BM
  int* lab = reinterpret_cast<int*>(gs + BM);         // BM (F)
  int* sidx = lab + BM;                               // BM (F)
  float* sum2 = reinterpret_cast<float*>(sidx + BM);  // 2 BM (F)
  const int tid = threadIdx.x;

  if constexpr (!f_direct(E, ROUTE))
    for (int p = tid; p < BM; p += LE_THREADS)
      gs[p] = p < np ? (uint32_t)a.gidx[base + p] : 0u;
  if constexpr (E) {
    for (int p = tid; p < BM; p += LE_THREADS) best[p] = best_key(NEG_INF, 0);
    tile_step_e<BM, STAGES>(a, fb, np, gs, ring, best, order, flag, tmp);
    for (int p = tid; p < np; p += LE_THREADS) {
      const int l = best_slot(best[p]);
      if constexpr (F) lab[p] = l;
      a.labels[base + p] = l;
    }
  } else if constexpr (!f_direct(E, ROUTE)) {
    for (int p = tid; p < np; p += LE_THREADS)
      lab[p] = a.labels_in[base + p];
  }
  if constexpr (F)
    tile_step_f<BM, FW, !E, ROUTE>(a, fb, np, base, gs, lab, sidx, sum2);
}

}  // namespace repro_torch
