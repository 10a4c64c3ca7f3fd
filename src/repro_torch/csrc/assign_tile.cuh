// Step (e) of the restricted sampler on one thread block's points: the
// running first-max over streamed K tiles of
//
//   t_ik = loglik_k(x_i) + logw_k  (-1e30 if slot k is inactive)
//          + Gumbel(key_z, gidx_i, slots_k)
//
// shared by the one-read sweeps (sweep_gauss.cu, sweep_linear.cu) and the
// standalone assignment kernels (assign_gauss.cu, assign_linear.cu); the
// Gaussian whitening product is also the body of loglik_gauss.cu. It is the
// device half of the TPU kernels src/repro/kernels/assign.py:assign_gauss /
// assign_linear and of step (e) of src/repro/kernels/sweep.py.
//
// Every function here is called by all threads of the block (it holds
// __syncthreads) and leaves, for the block's np points, best[p] (the running
// maximum) and lab[p] (its slot) in shared memory. A slot replaces the best
// only when its value is strictly larger, so the first maximum wins, as
// argmax and the reference's _fold_best do. An inactive slot's value is
// -1e30 + its Gumbel, which the Threefry top bin can make +inf, so its
// noise is drawn all the same (ROADMAP.md, faults).
//
// Gaussian: loglik_k(x) = 0.5 (logdet_k - |F_k^T (x - mu_k)|^2)
//                         - 0.5 d log(2 pi),
// with F_k the factor of the precision. Two layouts:
//  - narrow (d <= 64, template DP = d rounded up to a power of two): one
//    thread per point keeps x and the whitened vector y in registers; a tile
//    of TILE_FLOATS of factors is staged in shared memory and its rows are
//    broadcast to all threads (one 16-byte load per four FMAs);
//  - wide (64 < d <= 128): a point's 128 output columns are spread over the
//    four lanes of a lane group (32 each, in 16-byte chunks 4j + 16t), its
//    x row is staged in shared memory, one 64 KiB factor is staged per tile,
//    and |y|^2 is reduced over the four lanes with two xor shuffles (the
//    same bits in every lane: float addition is commutative).
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

}  // namespace repro_torch
