// Step (e) of the restricted sampler on one thread block's points: the
// running first-max over streamed K tiles of
//
//   t_ik = loglik_k(x_i) + logw_k  (-1e30 if slot k is inactive)
//          + Gumbel(key_z, gidx_i, slots_k)
//
// shared by the one-read sweeps (sweep_gauss.cu at d <= 16, sweep_linear.cu)
// and the standalone assignment kernels (assign_gauss.cu, assign_linear.cu);
// the Gaussian whitening product is also the body of loglik_gauss.cu. It is
// the device half of the TPU kernels src/repro/kernels/assign.py:
// assign_gauss / assign_linear and of step (e) of
// src/repro/kernels/sweep.py. Above d = 16 sweep_gauss.cu runs step (e) as
// a register-tiled product of its own that keeps these functions' chains
// and order. Step (f) (the own cluster's two sub-components) is here too,
// shared by sweep_linear.cu and the standalone sub_assign_gauss.cu /
// sub_assign_linear.cu; sweep_gauss.cu runs the same arithmetic on staged
// operands (maha_narrow / maha_wide), so the three-pass path draws the
// one-read sweep's sub-labels bit for bit.
//
// The narrow, wide and linear step-(e) functions are called by all threads
// of the block (they hold __syncthreads) and leave, for the block's np
// points, best[p] (the running maximum) and lab[p] (its slot) in shared
// memory. A slot replaces the best
// only when its value is strictly larger, so the first maximum wins, as
// argmax and the reference's _fold_best do. An inactive slot's value is
// -1e30 + its Gumbel, which the Threefry top bin can make +inf, so its
// noise is drawn all the same (ROADMAP.md, faults).
//
// Gaussian: loglik_k(x) = 0.5 (logdet_k - |F_k^T (x - mu_k)|^2)
//                         - 0.5 d log(2 pi),
// with F_k the factor of the precision. Three layouts:
//  - narrow (d <= 64, template DP = d rounded up to a power of two): one
//    thread per point keeps x and the whitened vector y in registers; a tile
//    of TILE_FLOATS of factors is staged in shared memory and its rows are
//    broadcast to all threads (one 16-byte load per four FMAs);
//  - wide (64 < d <= 128): a point's 128 output columns are spread over the
//    four lanes of a lane group (32 each, in 16-byte chunks 4j + 16t), its
//    x row is staged in shared memory, one 64 KiB factor is staged per tile,
//    and |y|^2 is reduced over the four lanes with two xor shuffles (the
//    same bits in every lane: float addition is commutative);
//  - panel (d > 128, step (e) and loglik only; gauss_panel below): a
//    register-tiled product of a block's points and the factor, streamed in
//    row slabs, |y|^2 summed over 128-column tiles in order.
// Only the factors of active slots are staged and multiplied.
//
// Linear families: loglik_k(x) = f . w_k + const_k over per-point features
// f of any width d'. Chunks of DC features of PT points and of the tile's
// active weight rows are copied to shared memory with cp.async (two in
// flight) and each thread keeps an 8 points x 8 slots block of dot products
// in registers, in feature order (blockDim.x must be LIN_THREADS).
#pragma once

#include <limits.h>
#include <stdint.h>

#include "threefry.cuh"

namespace repro_torch {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// Gaussian
// ---------------------------------------------------------------------------
// Shared-memory budget of one staged tile of narrow factors (32 KiB).
constexpr int TILE_FLOATS = 8192;
// The wide layout: padded width, lanes per point, columns per lane.
constexpr int WIDE_D = 128;
constexpr int WIDE_LANES = 4;
constexpr int WIDE_COLS = WIDE_D / WIDE_LANES;
constexpr int WIDE_XSTRIDE = WIDE_D + 1;   // staged x rows, bank-skewed

// Slots per staged tile for padded width DP.
__host__ __device__ inline int gauss_tile_slots(int dp, int K) {
  const int budget = dp > 64 ? 1 : TILE_FLOATS / (dp * dp);
  return max(1, min(K, budget));
}

// Floats of one staged tile of bk slots at padded width DP.
__host__ __device__ inline size_t gauss_tile_floats(int dp, int bk) {
  return (size_t)bk * dp * dp + (size_t)bk * dp + 4 * (size_t)bk;
}

// Floats of the staged x rows of the wide layout (one per lane group).
__host__ __device__ inline size_t wide_x_floats(int threads) {
  return (size_t)(threads / WIDE_LANES) * WIDE_XSTRIDE;
}

template <int DP>
struct GaussTile {
  float* f;    // bk * DP * DP factors, rows and columns zero past d
  float* mu;   // bk * DP
  float* ld;   // bk
  float* lw;   // bk
  int* act;    // bk
  int* slot;   // bk
  __device__ GaussTile(float* base, int bk) {
    f = base;
    mu = f + (size_t)bk * DP * DP;
    ld = mu + (size_t)bk * DP;
    lw = ld + bk;
    act = reinterpret_cast<int*>(lw + bk);
    slot = act + bk;
  }
};

// Stage slots [kt, kt + bk) into the tile. logw, active and slots may be
// nullptr (loglik_gauss: every slot live, weight 0).
template <int DP>
__device__ void stage_gauss_tile(const GaussTile<DP>& t, int kt, int bk,
                                 int d, const float* __restrict__ mu,
                                 const float* __restrict__ chol,
                                 const float* __restrict__ logdet,
                                 const float* __restrict__ logw,
                                 const int* __restrict__ active,
                                 const int* __restrict__ slots) {
  __syncthreads();
  for (int i = threadIdx.x; i < bk; i += blockDim.x) {
    t.ld[i] = logdet[kt + i];
    t.lw[i] = logw != nullptr ? logw[kt + i] : 0.f;
    t.act[i] = active != nullptr ? active[kt + i] : 1;
    t.slot[i] = slots != nullptr ? slots[kt + i] : kt + i;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < bk * DP * DP; i += blockDim.x) {
    const int kk = i / (DP * DP), r = (i / DP) % DP, c = i % DP;
    if (t.act[kk] == 0) continue;
    t.f[i] = (r < d && c < d)
                 ? chol[((size_t)(kt + kk) * d + r) * d + c] : 0.f;
  }
  for (int i = threadIdx.x; i < bk * DP; i += blockDim.x) {
    const int kk = i / DP, c = i % DP;
    t.mu[i] = c < d ? mu[(size_t)(kt + kk) * d + c] : 0.f;
  }
  __syncthreads();
}

template <int DP>
__device__ __forceinline__ void load_row(const float* __restrict__ src, int d,
                                         float (&r)[DP]) {
#pragma unroll
  for (int a = 0; a < DP; ++a) r[a] = a < d ? __ldg(src + a) : 0.f;
}

// |F^T (x - m)|^2 from a staged factor f (DP x DP, zero-padded) and mean m.
template <int DP>
__device__ __forceinline__ float maha_narrow(const float (&xr)[DP],
                                             const float* f, const float* m) {
  float y[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) y[c] = 0.f;
#pragma unroll
  for (int r = 0; r < DP; ++r) {
    const float dv = xr[r] - m[r];
#pragma unroll
    for (int c = 0; c < DP; c += 4) {
      const float4 fr = *reinterpret_cast<const float4*>(f + r * DP + c);
      y[c] = fmaf(dv, fr.x, y[c]);
      y[c + 1] = fmaf(dv, fr.y, y[c + 1]);
      y[c + 2] = fmaf(dv, fr.z, y[c + 2]);
      y[c + 3] = fmaf(dv, fr.w, y[c + 3]);
    }
  }
  float maha = 0.f;
#pragma unroll
  for (int c = 0; c < DP; ++c) maha = fmaf(y[c], y[c], maha);
  return maha;
}

// The wide layout's |F^T (x - m)|^2 for the point whose row xs (stride 1,
// zero past d) this lane group staged; j is the lane within the group, f a
// WIDE_D x WIDE_D factor (shared or global, zero-padded) with row stride
// ``ld``, m its mean. All 32 lanes of the warp must call it together.
__device__ __forceinline__ float maha_wide(const float* xs, const float* f,
                                           const float* m, int d, int j) {
  float y[WIDE_COLS];
#pragma unroll
  for (int c = 0; c < WIDE_COLS; ++c) y[c] = 0.f;
#pragma unroll 2
  for (int r = 0; r < d; ++r) {
    const float dv = xs[r] - m[r];
    const float* fr = f + r * WIDE_D + 4 * j;
#pragma unroll
    for (int t = 0; t < WIDE_COLS / 4; ++t) {
      const float4 v = *reinterpret_cast<const float4*>(fr + 16 * t);
      y[4 * t] = fmaf(dv, v.x, y[4 * t]);
      y[4 * t + 1] = fmaf(dv, v.y, y[4 * t + 1]);
      y[4 * t + 2] = fmaf(dv, v.z, y[4 * t + 2]);
      y[4 * t + 3] = fmaf(dv, v.w, y[4 * t + 3]);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < WIDE_COLS; ++c) s = fmaf(y[c], y[c], s);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s;
}

// Stage the x row of point p (or zeros when !live) into this lane group's
// shared row xs, zero past d; callers __syncwarp after it.
__device__ __forceinline__ void stage_x_wide(const float* __restrict__ xb,
                                             int p, bool live, int d, int j,
                                             float* xs) {
  for (int c = j; c < WIDE_D; c += WIDE_LANES)
    xs[c] = (live && c < d) ? __ldg(xb + (size_t)p * d + c) : 0.f;
}

// Step (e) for the block's np points xb (np x d) with global indices
// gidx_b, narrow layout. tile_smem holds gauss_tile_floats(DP, bk_max).
template <int DP>
__device__ void gauss_assign_narrow(
    const float* __restrict__ xb, int np, int d,
    const long long* __restrict__ gidx_b, const float* __restrict__ mu,
    const float* __restrict__ chol, const float* __restrict__ logdet,
    const float* __restrict__ logw, const int* __restrict__ active,
    const int* __restrict__ slots, int K, int bk_max, uint32_t kz0,
    uint32_t kz1, float half_d_log2pi, float* tile_smem, float* best,
    int* lab) {
  for (int p = threadIdx.x; p < np; p += blockDim.x) {
    best[p] = NEG_INF;
    lab[p] = 0;
  }
  const GaussTile<DP> t(tile_smem, bk_max);
  for (int kt = 0; kt < K; kt += bk_max) {
    const int bk = min(bk_max, K - kt);
    stage_gauss_tile<DP>(t, kt, bk, d, mu, chol, logdet, logw, active,
                         slots);
    for (int p = threadIdx.x; p < np; p += blockDim.x) {
      float xr[DP];
      load_row<DP>(xb + (size_t)p * d, d, xr);
      const uint32_t g = (uint32_t)gidx_b[p];
      float b = best[p];
      int l = lab[p];
      for (int kk = 0; kk < bk; ++kk) {
        // an inactive slot's logit is the mask whatever its likelihood,
        // so its whitening product is skipped (a branch uniform over the
        // block: every thread is at the same slot)
        float v = NEG_INF;
        if (t.act[kk] != 0) {
          const float maha = maha_narrow<DP>(xr, t.f + kk * DP * DP,
                                             t.mu + kk * DP);
          v = 0.5f * (t.ld[kk] - maha) - half_d_log2pi;
          v = v + t.lw[kk];
        }
        v = v + gumbel(kz0, kz1, g, (uint32_t)t.slot[kk]);
        if (v > b) {
          b = v;
          l = kt + kk;
        }
      }
      best[p] = b;
      lab[p] = l;
    }
  }
  __syncthreads();
}

// Step (e), wide layout (64 < d <= 128). blockDim.x is a multiple of 32;
// tile_smem holds gauss_tile_floats(WIDE_D, bk_max) and xsm
// wide_x_floats(blockDim.x).
__device__ void gauss_assign_wide(
    const float* __restrict__ xb, int np, int d,
    const long long* __restrict__ gidx_b, const float* __restrict__ mu,
    const float* __restrict__ chol, const float* __restrict__ logdet,
    const float* __restrict__ logw, const int* __restrict__ active,
    const int* __restrict__ slots, int K, int bk_max, uint32_t kz0,
    uint32_t kz1, float half_d_log2pi, float* tile_smem, float* xsm,
    float* best, int* lab) {
  for (int p = threadIdx.x; p < np; p += blockDim.x) {
    best[p] = NEG_INF;
    lab[p] = 0;
  }
  const int groups = blockDim.x / WIDE_LANES;
  const int grp = threadIdx.x / WIDE_LANES, j = threadIdx.x % WIDE_LANES;
  float* xs = xsm + grp * WIDE_XSTRIDE;
  const GaussTile<WIDE_D> t(tile_smem, bk_max);
  for (int kt = 0; kt < K; kt += bk_max) {
    const int bk = min(bk_max, K - kt);
    stage_gauss_tile<WIDE_D>(t, kt, bk, d, mu, chol, logdet, logw, active,
                             slots);
    // every lane runs the same number of passes: the shuffles of
    // maha_wide need the whole warp
    for (int p0 = 0; p0 < np; p0 += groups) {
      const int p = p0 + grp;
      const bool live = p < np;
      stage_x_wide(xb, p, live, d, j, xs);
      __syncwarp();
      const uint32_t g = live ? (uint32_t)gidx_b[p] : 0u;
      float b = live ? best[p] : NEG_INF;
      int l = live ? lab[p] : 0;
      for (int kk = 0; kk < bk; ++kk) {
        float v = NEG_INF;
        if (t.act[kk] != 0) {
          const float maha = maha_wide(xs, t.f + (size_t)kk * WIDE_D * WIDE_D,
                                       t.mu + kk * WIDE_D, d, j);
          v = 0.5f * (t.ld[kk] - maha) - half_d_log2pi;
          v = v + t.lw[kk];
        }
        v = v + gumbel(kz0, kz1, g, (uint32_t)t.slot[kk]);
        if (v > b) {
          b = v;
          l = kt + kk;
        }
      }
      if (live && j == 0) {
        best[p] = b;
        lab[p] = l;
      }
      __syncwarp();
    }
  }
  __syncthreads();
}

// The step-(f) warp layout's widest d (sub_assign_gauss.cu): one warp a
// point, its x row staged in shared memory (PANEL_D floats a warp).
constexpr int PANEL_D = 256;

// ---------------------------------------------------------------------------
// Step (f), Gaussian: first max over s in {0, 1} of
//   t_s = 0.5 (sub_logdet_ls - |F_ls^T (x - mu_ls)|^2) - 0.5 d log(2 pi)
//         + sublogw_ls + Gumbel(key_zb, gidx, s)
// under the point's own cluster l, whose two factors are read from global
// memory (a point needs two; all of them stay in L2: 16 MiB at K = 32 and
// d = 256). The standalone sub_assign_gauss.cu calls these; the one-read
// sweep (sweep_gauss.cu, d <= 128) stages each label's two factors in
// shared memory and runs the same chains (maha_narrow / maha_wide, whose
// zero padding adds exact zeros), so their sub-labels agree bit for bit.
// ---------------------------------------------------------------------------

// Narrow layout (d <= 64): one thread, its x row in registers (zero past d).
template <int DP>
__device__ __forceinline__ int gauss_sub_narrow(
    const float (&xr)[DP], int d, int l, const float* __restrict__ sub_mu,
    const float* __restrict__ sub_chol, const float* __restrict__ sub_logdet,
    const float* __restrict__ sublogw, uint32_t g, uint32_t kb0,
    uint32_t kb1, float half_d_log2pi) {
  float t2[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const size_t ks = (size_t)l * 2 + s;
    const float* f = sub_chol + ks * d * d;
    const float* m = sub_mu + ks * d;
    float y[DP];
#pragma unroll
    for (int c = 0; c < DP; ++c) y[c] = 0.f;
#pragma unroll
    for (int r = 0; r < DP; ++r) {
      if (r < d) {
        const float dv = xr[r] - __ldg(m + r);
#pragma unroll
        for (int c = 0; c < DP; ++c)
          if (c < d) y[c] = fmaf(dv, __ldg(f + r * d + c), y[c]);
      }
    }
    float maha = 0.f;
#pragma unroll
    for (int c = 0; c < DP; ++c) maha = fmaf(y[c], y[c], maha);
    float t = 0.5f * (__ldg(sub_logdet + ks) - maha) - half_d_log2pi;
    t = t + __ldg(sublogw + ks);
    t2[s] = t + gumbel(kb0, kb1, g, (uint32_t)s);
  }
  return t2[1] > t2[0] ? 1 : 0;
}

// |F^T (x - m)|^2 of the wide layout for a factor in global memory (row
// stride d, not padded): the lane's 32 columns 4j + 16t + q below d.
__device__ __forceinline__ float maha_wide_global(const float* xs,
                                                  const float* f,
                                                  const float* m, int d,
                                                  int j) {
  float y[WIDE_COLS];
#pragma unroll
  for (int c = 0; c < WIDE_COLS; ++c) y[c] = 0.f;
  for (int r = 0; r < d; ++r) {
    const float dv = xs[r] - __ldg(m + r);
    const float* fr = f + (size_t)r * d;
#pragma unroll
    for (int t = 0; t < WIDE_COLS / 4; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = 4 * j + 16 * t + q;
        if (c < d) y[4 * t + q] = fmaf(dv, __ldg(fr + c), y[4 * t + q]);
      }
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < WIDE_COLS; ++c) s = fmaf(y[c], y[c], s);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s;
}

// Wide layout (64 < d <= 128): lane j of the lane group whose staged x row
// is xs. All 32 lanes of the warp call it (the shuffles) and get the same
// sub-label; ``live`` false marks a pad group, which draws no noise.
__device__ __forceinline__ int gauss_sub_wide(
    const float* xs, int d, int j, int l, const float* __restrict__ sub_mu,
    const float* __restrict__ sub_chol, const float* __restrict__ sub_logdet,
    const float* __restrict__ sublogw, bool live, uint32_t g, uint32_t kb0,
    uint32_t kb1, float half_d_log2pi) {
  float t2[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const size_t ks = (size_t)l * 2 + s;
    const float maha = maha_wide_global(xs, sub_chol + ks * d * d,
                                        sub_mu + ks * d, d, j);
    float t = 0.5f * (__ldg(sub_logdet + ks) - maha) - half_d_log2pi;
    t = t + __ldg(sublogw + ks);
    t2[s] = live ? t + gumbel(kb0, kb1, g, (uint32_t)s) : t;
  }
  return t2[1] > t2[0] ? 1 : 0;
}

// ---------------------------------------------------------------------------
// Linear families
// ---------------------------------------------------------------------------
constexpr int LIN_THREADS = 256;
constexpr int PT = 256;        // points per sub-tile
constexpr int BK = 64;         // slots per K tile
constexpr int DC = 32;         // features per staged chunk
constexpr int FSTR = DC + 4;   // padded row stride (16-byte rows) of a chunk
constexpr int TI = PT / 32;    // points per thread: ty + 32 i
constexpr int TJ = BK / 8;     // slots per thread: tx + 8 j

// Floats (and ints) of the shared memory linear_assign uses besides best
// and lab: two chunk buffers of PT + BK rows, the active and inactive slot
// lists of a tile and their two counts.
__host__ __device__ inline size_t linear_assign_words() {
  return 2 * ((size_t)PT * FSTR + (size_t)BK * FSTR) + 2 * (size_t)BK + 2;
}

// Asynchronous copies global -> shared (sm_80+): ``bytes`` of ``size`` are
// read and the rest of the destination is zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage feature chunk [c0, c0 + DC) of points p0.. (PT rows) and of the
// active weight rows ``act`` (na rows) into fsb / wsb, zero past the edges;
// 16-byte copies when every row starts 16-byte aligned (``vec``).
__device__ __forceinline__ void stage_chunk(
    const float* __restrict__ fb, const float* __restrict__ w, int dp,
    int np, int p0, int c0, const int* act, int na, bool vec, float* fsb,
    float* wsb) {
  if (vec) {
    constexpr int Q = DC / 4;
    for (int e = threadIdx.x; e < (PT + na) * Q; e += LIN_THREADS) {
      const int r = e / Q, col = c0 + 4 * (e - r * Q);
      const bool pt = r < PT;
      const int row = pt ? p0 + r : act[r - PT];
      const bool in = col < dp && (!pt || row < np);
      const float* src = pt ? fb + (size_t)row * dp : w + (size_t)row * dp;
      float* dst = (pt ? fsb + r * FSTR : wsb + (r - PT) * FSTR) + col - c0;
      cp_async16(dst, in ? src + col : fb, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < (PT + na) * DC; e += LIN_THREADS) {
      const int r = e / DC, col = c0 + (e - r * DC);
      const bool pt = r < PT;
      const int row = pt ? p0 + r : act[r - PT];
      const bool in = col < dp && (!pt || row < np);
      const float* src = pt ? fb + (size_t)row * dp : w + (size_t)row * dp;
      float* dst = (pt ? fsb + r * FSTR : wsb + (r - PT) * FSTR) + col - c0;
      cp_async4(dst, in ? src + col : fb, in ? 4 : 0);
    }
  }
  cp_async_commit();
}

// (value, slot) pair order of the argmax: larger value, then smaller slot.
__device__ __forceinline__ void take_best(float t, int c, float& bv,
                                          int& bl) {
  if (t > bv || (t == bv && c < bl)) {
    bv = t;
    bl = c;
  }
}

// Step (e) for the block's np points fb (np x dp), linear families.
// ``words`` points at linear_assign_words() floats of shared memory.
__device__ void linear_assign(
    const float* __restrict__ fb, int np, int dp,
    const long long* __restrict__ gidx_b, const float* __restrict__ w,
    const float* __restrict__ cst, const float* __restrict__ logw,
    const int* __restrict__ active, const int* __restrict__ slots, int K,
    uint32_t kz0, uint32_t kz1, bool vec, float* words, float* best,
    int* lab) {
  float* fs = words;                                   // 2 * PT * FSTR
  float* ws = fs + 2 * PT * FSTR;                      // 2 * BK * FSTR
  int* act = reinterpret_cast<int*>(ws + 2 * BK * FSTR);  // BK
  int* inact = act + BK;                               // BK
  int* cnt = inact + BK;                               // 2
  const int tid = threadIdx.x;
  const int tx = tid & 7, ty = tid >> 3;

  for (int p = tid; p < np; p += LIN_THREADS) {
    best[p] = NEG_INF;
    lab[p] = 0;
  }

  for (int kt = 0; kt < K; kt += BK) {
    const int bk = min(BK, K - kt);
    __syncthreads();
    if (tid == 0) {
      int na = 0, ni = 0;
      for (int kk = 0; kk < bk; ++kk) {
        if (active[kt + kk] != 0)
          act[na++] = kt + kk;
        else
          inact[ni++] = kt + kk;
      }
      cnt[0] = na;
      cnt[1] = ni;
    }
    __syncthreads();
    const int na = cnt[0], ni = cnt[1];
    const int jmax = (na + 7) / 8;
    for (int p0 = 0; p0 < np; p0 += PT) {
      float acc[TI][TJ];
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TJ; ++j) acc[i][j] = 0.f;
      // double-buffered chunks: the copy of chunk ci + 1 runs while the
      // products of chunk ci are summed, in feature order
      const int nch = na > 0 ? (dp + DC - 1) / DC : 0;
      if (nch > 0) {
        __syncthreads();
        stage_chunk(fb, w, dp, np, p0, 0, act, na, vec, fs, ws);
      }
      for (int ci = 0; ci < nch; ++ci) {
        const int buf = ci & 1;
        if (ci + 1 < nch) {
          stage_chunk(fb, w, dp, np, p0, (ci + 1) * DC, act, na, vec,
                      fs + (buf ^ 1) * PT * FSTR, ws + (buf ^ 1) * BK * FSTR);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const float* fsb = fs + buf * PT * FSTR;
        const float* wsb = ws + buf * BK * FSTR;
#pragma unroll 1
        for (int c = 0; c < DC; c += 4) {
          float4 a[TI];
#pragma unroll
          for (int i = 0; i < TI; ++i)
            a[i] = *reinterpret_cast<const float4*>(fsb + (ty + 32 * i) * FSTR
                                                    + c);
#pragma unroll
          for (int j = 0; j < TJ; ++j) {
            if (j < jmax) {
              const float4 b =
                  *reinterpret_cast<const float4*>(wsb + (tx + 8 * j) * FSTR
                                                   + c);
#pragma unroll
              for (int i = 0; i < TI; ++i) {
                float v = fmaf(a[i].x, b.x, acc[i][j]);
                v = fmaf(a[i].y, b.y, v);
                v = fmaf(a[i].z, b.z, v);
                acc[i][j] = fmaf(a[i].w, b.w, v);
              }
            }
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < TI; ++i) {
        const int p = p0 + ty + 32 * i;
        float bv = NEG_INF;
        int bl = INT_MAX;
        if (p < np) {
          const uint32_t g = (uint32_t)gidx_b[p];
#pragma unroll
          for (int j = 0; j < TJ; ++j) {
            const int pos = tx + 8 * j;
            if (pos < na) {
              const int c = act[pos];
              float t = acc[i][j] + cst[c];
              t = t + logw[c];
              t = t + gumbel(kz0, kz1, g, (uint32_t)slots[c]);
              take_best(t, c, bv, bl);
            }
          }
          for (int pos = tx; pos < ni; pos += 8) {
            const int c = inact[pos];
            take_best(NEG_INF + gumbel(kz0, kz1, g, (uint32_t)slots[c]), c,
                      bv, bl);
          }
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
          const int ol = __shfl_xor_sync(0xffffffffu, bl, off);
          take_best(ov, ol, bv, bl);
        }
        if (tx == 0 && p < np && bv > best[p]) {
          best[p] = bv;
          lab[p] = bl;
        }
      }
    }
  }
  __syncthreads();
}

// Step (f) for the block's np points fb (np x dp), linear families: first
// max over s in {0, 1} of f . subw_ls + subconst_ls + sublogw_ls +
// Gumbel(key_zb, gidx, s) under the point's own cluster l = lab[p]. One warp
// per point: a warp takes its points 32 at a time; for each, the lanes
// stride the row and its cluster's two sub-weight rows (coalesced) and a
// shuffle-down tree leaves the two sums in lane 0, which hands them to lane
// q of the batch; then every lane draws the Gumbel noise and picks the
// sub-label of its own point, all 32 at once. The sums run in a fixed
// order, so a repeat launch gives the same bits. Hands each point's
// sub-label to put(p, zb), from the lane that chose it, so the caller
// writes its outputs in the same step. With CHECKED a label outside
// [0, K) gets sub-label 0 (labels from the caller); the sweep's own labels
// need no check. Blocks of LIN_THREADS threads. Shared by sweep_linear.cu
// and sub_assign_linear.cu.
template <bool CHECKED, class Put>
__device__ void linear_sub_assign(
    const float* __restrict__ fb, int np, int dp,
    const long long* __restrict__ gidx_b, const int* lab, int K,
    const float* __restrict__ subw, const float* __restrict__ subconst,
    const float* __restrict__ sublogw, uint32_t kb0, uint32_t kb1, bool vec,
    Put put) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int NWARPS = LIN_THREADS / 32;
  for (int b0 = warp * 32; b0 < np; b0 += NWARPS * 32) {
    float my0 = 0.f, my1 = 0.f;
    const int nb = min(32, np - b0);
    for (int q = 0; q < nb; ++q) {
      const int p = b0 + q;
      const int l = lab[p];
      if (CHECKED && (l < 0 || l >= K)) continue;   // uniform over the warp
      const float* fp = fb + (size_t)p * dp;
      const float* w0 = subw + (size_t)(2 * l) * dp;
      const float* w1 = w0 + dp;
      float s0 = 0.f, s1 = 0.f;
      if (vec) {
#pragma unroll 2
        for (int c = 4 * lane; c < dp; c += 128) {
          const float4 v = *reinterpret_cast<const float4*>(fp + c);
          const float4 a = __ldg(reinterpret_cast<const float4*>(w0 + c));
          const float4 b = __ldg(reinterpret_cast<const float4*>(w1 + c));
          s0 = fmaf(v.x, a.x, s0);
          s0 = fmaf(v.y, a.y, s0);
          s0 = fmaf(v.z, a.z, s0);
          s0 = fmaf(v.w, a.w, s0);
          s1 = fmaf(v.x, b.x, s1);
          s1 = fmaf(v.y, b.y, s1);
          s1 = fmaf(v.z, b.z, s1);
          s1 = fmaf(v.w, b.w, s1);
        }
      } else {
#pragma unroll 4
        for (int c = lane; c < dp; c += 32) {
          const float v = fp[c];
          s0 = fmaf(v, __ldg(w0 + c), s0);
          s1 = fmaf(v, __ldg(w1 + c), s1);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s0 += __shfl_down_sync(0xffffffffu, s0, off);
        s1 += __shfl_down_sync(0xffffffffu, s1, off);
      }
      s0 = __shfl_sync(0xffffffffu, s0, 0);
      s1 = __shfl_sync(0xffffffffu, s1, 0);
      if (lane == q) {
        my0 = s0;
        my1 = s1;
      }
    }
    if (lane < nb) {
      const int p = b0 + lane;
      const int l = lab[p];
      int zb = 0;
      if (!CHECKED || (l >= 0 && l < K)) {
        const uint32_t g = (uint32_t)gidx_b[p];
        float t0 = my0 + subconst[2 * l];
        t0 = t0 + sublogw[2 * l];
        t0 = t0 + gumbel(kb0, kb1, g, 0u);
        float t1 = my1 + subconst[2 * l + 1];
        t1 = t1 + sublogw[2 * l + 1];
        t1 = t1 + gumbel(kb0, kb1, g, 1u);
        zb = t1 > t0 ? 1 : 0;
      }
      put(p, zb);
    }
  }
}

// ---------------------------------------------------------------------------
// Panel layout (d > 128; assign_gauss.cu and loglik_gauss.cu, no sweep): per
// slot k the whitening is a product, Y = (X - mu_k) F_k, of the block's BM
// points (BM x d) and the factor (d x d), then |y_i|^2 row by row. A block
// computes it as an output-stationary tile of BM points x PANEL_BN columns
// of Y: each of its (BM / 8) x 16 threads holds an 8 x 8 register tile
// (rows g0 + i and g1 + i, BM / 2 apart; columns c0 + j and c1 + j,
// PANEL_BN / 2 apart, so a warp's float4 reads of shared memory do not
// conflict) and adds fmaf((x - mu)_ir, F_rc, y_ic) in row order r. Row slabs
// of BK rows of F (BK x PANEL_BN), of the points' x (transposed: BK x BM)
// and of mu_k (BK) stream through a ring of PANEL_STAGES shared
// buffers with cp.async, so slab t + 1 and t + 2 are copied while slab t is
// multiplied; the copy runs on over column tiles and slots without a gap.
// x - mu_k is formed once a slab in shared memory. The factor is streamed,
// never held whole, so no shared-memory budget grows with d: rows past d
// and columns past d are zero-filled by the copies (they add exact zeros).
//
// Order. After the last slab of a column tile, each thread sums y^2 over
// its 8 columns of each of its rows (in column order), the 16 lanes of a
// row group add their sums with four xor shuffles (the same bits in every
// lane: float addition is commutative), and lane i of the group adds row
// i's sum to that row's |y|^2, column tiles in order. So a point's value
// for a slot depends on (x_i, slot, d) alone: not on N, BM, the block, the
// slot group or the grid, and a served row gets the same bits in any
// request.
//
// Slots. A block walks the slots [k_lo, k_hi) of its slot group in order.
// Step (e) skips the product of an inactive slot (a branch uniform over the
// block) but still draws its Gumbel (the Threefry top bin, ROADMAP.md §3),
// with the same counters and strict-`>` first max as gauss_assign_narrow /
// _wide; each group leaves its running (max, first argmax) per point, and
// panel_fold_groups takes the groups in slot order with strict `>`, which
// is the label of one walk over all slots. The wrapper
// (kernels/assign.py panel_plan, a function of the shape) chooses BM and the
// groups; the launchers hold each BM's layout once (PanelTile) and refuse
// any other.
// ---------------------------------------------------------------------------
constexpr int PANEL_BN = 128;     // columns of Y a column tile
constexpr int PANEL_STAGES = 3;   // slabs in the shared ring
constexpr int PANEL_TXN = PANEL_BN / 8;   // threads along a row group
constexpr int PANEL_FOLD_THREADS = 256;

template <int BM>
struct PanelTile {
  static constexpr int THREADS = (BM / 8) * PANEL_TXN;    // 256 or 64
  // rows of F (and of x - mu) a slab: 32 for the 128-point tile (half the
  // barriers and copy issue a row of F), 16 for the 32-point tile (whose
  // registers 32 rows would raise); the sums run over r in order either way
  static constexpr int BK = BM >= 128 ? 32 : 16;
  static constexpr int XS = BM + 4;        // row stride of the x slab
  // floats a stage: the x slab, the F slab, the slab's BK means
  static constexpr int STAGE = BK * (XS + PANEL_BN + 1);
  static constexpr int ROWS = THREADS / BK;     // x rows a copy round
  static constexpr int SMEM = (int)sizeof(float) * PANEL_STAGES * STAGE;
  static_assert(BM % 32 == 0 && SMEM <= 232448, "panel tile");
  // every copy and the x - mu pass are whole rounds of the block
  static_assert(THREADS % BK == 0 && BM % ROWS == 0 && BK <= THREADS &&
                    (BK * PANEL_BN / 4) % THREADS == 0 &&
                    (BK * PANEL_BN) % THREADS == 0 &&
                    (BK * BM / 4) % THREADS == 0,
                "panel rounds");
};

// Where the block's walk stands: slot k (k_hi when done), column tile ct,
// row slab s.
struct PanelStep {
  int k, ct, s;
};

// The first slot at or after k that has a product: every slot without
// ``active`` (loglik), else the next active one.
__device__ __forceinline__ int panel_next_slot(const int* __restrict__ active,
                                               int k, int k_hi) {
  if (active != nullptr)
    while (k < k_hi && __ldg(active + k) == 0) ++k;
  return k;
}

__device__ __forceinline__ void panel_advance(PanelStep& st, int ns, int nct,
                                              const int* __restrict__ active,
                                              int k_hi) {
  if (++st.s < ns) return;
  st.s = 0;
  if (++st.ct < nct) return;
  st.ct = 0;
  st.k = panel_next_slot(active, st.k + 1, k_hi);
}

// Copy row slab s of column tile ct of factor f, the same rows of the
// block's np points (transposed, zero past np and d; xsrc is this thread's
// first element of slab 0, xstep its stride to the next) and of the mean
// m, into one stage.
template <int BM>
__device__ __forceinline__ void panel_load(const float* __restrict__ xsrc,
                                           size_t xstep, int np, int d,
                                           const float* __restrict__ f,
                                           const float* __restrict__ m,
                                           int ct, int s, bool vec,
                                           float* stage) {
  using T = PanelTile<BM>;
  constexpr int BK = T::BK;
  float* xt = stage;                         // BK x XS
  float* fs = stage + BK * T::XS;            // BK x PANEL_BN
  float* ms = fs + BK * PANEL_BN;            // BK
  const int tid = threadIdx.x;
  const int r0 = s * BK;
  // x: this thread's element i is point tid / BK + ROWS i, row tid % BK of
  // the slab; xsrc points at its element 0 of slab 0
  const int p0 = tid / BK, rr = tid % BK;
  const bool rok = r0 + rr < d;
#pragma unroll
  for (int i = 0; i < BM / T::ROWS; ++i) {
    const bool ok = rok && p0 + i * T::ROWS < np;
    cp_async4(xt + rr * T::XS + p0 + i * T::ROWS,
              ok ? xsrc + i * xstep + r0 : m, ok ? 4 : 0);
  }
  if (tid < BK)
    cp_async4(ms + tid, rok ? m + r0 + tid : m, rok ? 4 : 0);
  const int col0 = ct * PANEL_BN;
  if (vec) {
    constexpr int Q = PANEL_BN / 4, EF = BK * Q;
#pragma unroll
    for (int i = 0; i < EF / T::THREADS; ++i) {
      const int e = tid + i * T::THREADS;
      const int r = e / Q, c = 4 * (e % Q);
      const bool ok = r0 + r < d && col0 + c < d;
      cp_async16(fs + r * PANEL_BN + c,
                 ok ? f + (size_t)(r0 + r) * d + col0 + c : f, ok ? 16 : 0);
    }
  } else {
    constexpr int EF = BK * PANEL_BN;
#pragma unroll 8
    for (int i = 0; i < EF / T::THREADS; ++i) {
      const int e = tid + i * T::THREADS;
      const int r = e / PANEL_BN, c = e % PANEL_BN;
      const bool ok = r0 + r < d && col0 + c < d;
      cp_async4(fs + r * PANEL_BN + c,
                ok ? f + (size_t)(r0 + r) * d + col0 + c : f, ok ? 4 : 0);
    }
  }
}

// The panel walk of one block: point tile blockIdx.x (BM points from
// blockIdx.x * BM), slot group blockIdx.y (slots [blockIdx.y * per, + per)
// of K). Called by all PanelTile<BM>::THREADS threads; smem holds
// PanelTile<BM>::SMEM bytes.
//  - ASSIGN: step (e) over the group's slots; the group's running (max,
//    first argmax) of point i goes to best_out / lab_out[blockIdx.y * n + i]
//    (best_out may be nullptr: one group, lab_out the labels).
//  - else: out[i * K + k] = 0.5 (logdet_k - |y|^2) - 0.5 d log(2 pi) for
//    every slot of the group (logw, active, slots, gidx unused).
template <int BM, bool ASSIGN>
__device__ __forceinline__ void gauss_panel(
    const float* __restrict__ x, int n, int d, const float* __restrict__ mu,
    const float* __restrict__ chol, const float* __restrict__ logdet,
    const float* __restrict__ logw, const int* __restrict__ active,
    const int* __restrict__ slots, int K, int per,
    const long long* __restrict__ gidx, uint32_t kz0, uint32_t kz1,
    float half_d_log2pi, bool vec, float* smem, float* __restrict__ out,
    float* __restrict__ best_out, int* __restrict__ lab_out) {
  using T = PanelTile<BM>;
  constexpr int THREADS = T::THREADS, XS = T::XS;
  const int tid = threadIdx.x;
  const int tx = tid % PANEL_TXN, ty = tid / PANEL_TXN;
  const int g0 = 4 * ty, g1 = g0 + BM / 2;
  const int c0 = 4 * tx, c1 = c0 + PANEL_BN / 2;
  const long long base = (long long)blockIdx.x * BM;
  const int np = (int)min((long long)BM, (long long)n - base);
  const float* xb = x + base * d;
  // this thread's first x element of each slab copy (panel_load)
  const float* xsrc = xb + (size_t)(threadIdx.x / T::BK) * d +
                      threadIdx.x % T::BK;
  const size_t xstep = (size_t)T::ROWS * d;
  const int k_lo = blockIdx.y * per;
  const int k_hi = min(K, k_lo + per);
  const int ns = (d + T::BK - 1) / T::BK;
  const int nct = (d + PANEL_BN - 1) / PANEL_BN;
  const int* act = ASSIGN ? active : nullptr;
  // lane i < 8 of a row group finishes row i of the thread's 8
  const int own = tx < 4 ? g0 + tx : g1 + tx - 4;
  const bool owner = tx < 8 && own < np;
  const uint32_t g = ASSIGN && owner ? (uint32_t)gidx[base + own] : 0u;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  float maha = 0.f;          // the owned row's |y|^2 over column tiles
  float best = NEG_INF;      // step (e): the owned row's running first max
  int lab = 0;
  int walked = k_lo;         // step (e): slots [k_lo, walked) compared

  PanelStep ld{panel_next_slot(act, k_lo, k_hi), 0, 0};
  PanelStep cur = ld;
#pragma unroll
  for (int i = 0; i < PANEL_STAGES - 1; ++i) {
    if (ld.k < k_hi) {
      panel_load<BM>(xsrc, xstep, np, d, chol + (size_t)ld.k * d * d,
                     mu + (size_t)ld.k * d, ld.ct, ld.s, vec,
                     smem + i * T::STAGE);
      panel_advance(ld, ns, nct, act, k_hi);
    }
    cp_async_commit();
  }
  for (int t = 0; cur.k < k_hi; ++t) {
    cp_async_wait<PANEL_STAGES - 2>();   // slab t has landed (this thread)
    __syncthreads();                     // ... and every thread's; slab
                                         // t - 1's buffer is free
    if (ld.k < k_hi) {
      panel_load<BM>(xsrc, xstep, np, d, chol + (size_t)ld.k * d * d,
                     mu + (size_t)ld.k * d, ld.ct, ld.s, vec,
                     smem + ((t + PANEL_STAGES - 1) % PANEL_STAGES) *
                                T::STAGE);
      panel_advance(ld, ns, nct, act, k_hi);
    }
    cp_async_commit();
    float* xt = smem + (t % PANEL_STAGES) * T::STAGE;
    const float* fs = xt + T::BK * XS;
    // x - mu_k of the slab's rows, once, in place
    {
      const float* ms = fs + T::BK * PANEL_BN;
      constexpr int Q = BM / 4, E4 = T::BK * Q;
#pragma unroll
      for (int i = 0; i < E4 / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int r = e / Q, p = 4 * (e % Q);
        const float mv = ms[r];
        float4* q = reinterpret_cast<float4*>(xt + r * XS + p);
        float4 v = *q;
        v.x -= mv;
        v.y -= mv;
        v.z -= mv;
        v.w -= mv;
        *q = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < T::BK; ++r) {
      const float4 a0 = *reinterpret_cast<const float4*>(xt + r * XS + g0);
      const float4 a1 = *reinterpret_cast<const float4*>(xt + r * XS + g1);
      const float4 b0 =
          *reinterpret_cast<const float4*>(fs + r * PANEL_BN + c0);
      const float4 b1 =
          *reinterpret_cast<const float4*>(fs + r * PANEL_BN + c1);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    if (cur.s == ns - 1) {
      // the column tile is done: its |y|^2 of each row, in a fixed order
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float sq = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sq = fmaf(acc[i][j], acc[i][j], sq);
          acc[i][j] = 0.f;
        }
        sq += __shfl_xor_sync(0xffffffffu, sq, 1);
        sq += __shfl_xor_sync(0xffffffffu, sq, 2);
        sq += __shfl_xor_sync(0xffffffffu, sq, 4);
        sq += __shfl_xor_sync(0xffffffffu, sq, 8);
        if (tx == i) maha += sq;
      }
      if (cur.ct == nct - 1 && owner) {
        // the slot is done
        const int k = cur.k;
        if (ASSIGN) {
          for (; walked < k; ++walked) {
            const float v =
                NEG_INF + gumbel(kz0, kz1, g, (uint32_t)__ldg(slots + walked));
            if (v > best) {
              best = v;
              lab = walked;
            }
          }
          float v = 0.5f * (__ldg(logdet + k) - maha) - half_d_log2pi;
          v = v + __ldg(logw + k);
          v = v + gumbel(kz0, kz1, g, (uint32_t)__ldg(slots + k));
          if (v > best) {
            best = v;
            lab = k;
          }
          walked = k + 1;
        } else {
          out[(base + own) * (size_t)K + k] =
              0.5f * (__ldg(logdet + k) - maha) - half_d_log2pi;
        }
      }
      if (cur.ct == nct - 1) maha = 0.f;
    }
    panel_advance(cur, ns, nct, act, k_hi);
  }
  cp_async_wait<0>();
  if (ASSIGN && owner) {
    for (; walked < k_hi; ++walked) {
      const float v =
          NEG_INF + gumbel(kz0, kz1, g, (uint32_t)__ldg(slots + walked));
      if (v > best) {
        best = v;
        lab = walked;
      }
    }
    const size_t o = (size_t)blockIdx.y * n + base + own;
    if (best_out != nullptr) best_out[o] = best;
    lab_out[o] = lab;
  }
}

// The labels from the slot groups' (max, first argmax) rows, groups in slot
// order, strict `>`: the first maximum over all slots, as one walk gives.
__global__ void __launch_bounds__(PANEL_FOLD_THREADS) panel_fold_groups(
    const float* __restrict__ best, const int* __restrict__ lab, int n,
    int groups, int* __restrict__ labels) {
  const long long i = (long long)blockIdx.x * PANEL_FOLD_THREADS + threadIdx.x;
  if (i >= n) return;
  float b = NEG_INF;
  int l = 0;
  for (int gr = 0; gr < groups; ++gr) {
    const float v = best[(size_t)gr * n + i];
    if (v > b) {
      b = v;
      l = lab[(size_t)gr * n + i];
    }
  }
  labels[i] = l;
}

}  // namespace repro_torch
