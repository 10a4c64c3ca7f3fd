// Step (e) of the restricted sampler on one thread block's points: the
// running first-max over streamed K tiles of
//
//   t_ik = loglik_k(x_i) + logw_k  (-1e30 if slot k is inactive)
//          + Gumbel(key_z, gidx_i, slots_k)
//
// for the Gaussian family, shared by the one-read sweep_gauss.cu at
// d <= 16 and assign_gauss.cu at d <= 16; the narrow Gaussian whitening is
// also the body of loglik_gauss.cu at d <= 16. It is the device half of
// the TPU kernel src/repro/kernels/assign.py: assign_gauss and of step (e)
// of src/repro/kernels/sweep.py:sweep_gauss. Above d = 16 the three
// Gaussian kernels run the register tile of te_tile.cuh, which keeps these
// functions' chains and order. The Gaussian step (f) of the sweep and of
// sub_assign_gauss.cu runs maha_narrow / maha_wide on staged operands
// (sub_tile.cuh), so the three-pass path draws the one-read sweep's
// sub-labels bit for bit. The linear families' steps (e) and (f) are one
// device function of their own, linear_tile.cuh.
//
// The narrow step-(e) function is called by all threads of
// the block (they hold __syncthreads) and leave, for the block's np
// points, best[p] (the running maximum) and lab[p] (its slot) in shared
// memory. A slot replaces the best
// only when its value is strictly larger, so the first maximum wins, as
// argmax and the reference's _fold_best do. An inactive slot's value is
// -1e30 + its Gumbel, which the Threefry top bin can make +inf, so its
// noise is drawn all the same (ROADMAP.md, faults).
//
// Gaussian: loglik_k(x) = 0.5 (logdet_k - |F_k^T (x - mu_k)|^2)
//                         - 0.5 d log(2 pi),
// with F_k the factor of the precision. Layouts:
//  - narrow (d <= 64, template DP = d rounded up to a power of two): one
//    thread per point keeps x and the whitened vector y in registers; a tile
//    of TILE_FLOATS of factors is staged in shared memory and its rows are
//    broadcast to all threads (one 16-byte load per four FMAs); step (e)
//    and the log-likelihood at d <= 16, and step (f) (sub_tile.cuh);
//  - wide (64 < d <= 128, maha_wide): a point's 128 output columns are
//    spread over the four lanes of a lane group (32 each, in 16-byte chunks
//    4j + 16t), its x row staged in shared memory, and |y|^2 is reduced
//    over the four lanes with two xor shuffles (the same bits in every
//    lane: float addition is commutative); the sweep's step (f) at d > 64,
//    and the order te_tile.cuh keeps at DP = 128;
//  - panel (d > 128, step (e) and loglik only; gauss_panel below): a
//    register-tiled product of a block's points and the factor, streamed in
//    row slabs, |y|^2 summed over 128-column tiles in order.
// Only the factors of active slots are staged and multiplied.
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

// ---------------------------------------------------------------------------
// Shared helpers (the linear families' tile is linear_tile.cuh)
// ---------------------------------------------------------------------------
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

// (value, slot) pair order of the argmax: larger value, then smaller slot.
__device__ __forceinline__ void take_best(float t, int c, float& bv,
                                          int& bl) {
  if (t > bv || (t == bv && c < bl)) {
    bv = t;
    bl = c;
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
// with the same counters and strict-`>` first max as gauss_assign_narrow;
// each group leaves its running (max, first argmax) per point, and
// fold_groups merges the groups by (max, least slot), which is the label
// of one walk over all slots. The wrapper
// (kernels/assign.py panel_plan, a function of the shape) chooses BM and the
// groups; the launchers hold each BM's layout once (PanelTile) and refuse
// any other.
// ---------------------------------------------------------------------------
constexpr int PANEL_BN = 128;     // columns of Y a column tile
constexpr int PANEL_STAGES = 3;   // slabs in the shared ring
constexpr int PANEL_TXN = PANEL_BN / 8;   // threads along a row group

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

// The labels from the slot groups' (max, label) rows (the panel layout's
// and te_tile.cuh's) merged by (max, least slot): the first maximum over
// all slots, as one walk in slot order gives. Panel groups hold slots in
// order, so this is also strict `>` over the groups in order.
constexpr int FOLD_GROUPS_THREADS = 256;

__global__ void __launch_bounds__(FOLD_GROUPS_THREADS) fold_groups(
    const float* __restrict__ best, const int* __restrict__ lab, int n,
    int groups, int* __restrict__ labels) {
  const long long i =
      (long long)blockIdx.x * FOLD_GROUPS_THREADS + threadIdx.x;
  if (i >= n) return;
  float b = NEG_INF;
  int l = 0;
  for (int gr = 0; gr < groups; ++gr)
    take_best(best[(size_t)gr * n + i], lab[(size_t)gr * n + i], b, l);
  labels[i] = l;
}

// fold_groups over n points and `groups` rows on `stream`.
inline cudaError_t launch_fold_groups(const float* best, const int* lab,
                                      int n, int groups, int* labels,
                                      cudaStream_t stream) {
  fold_groups<<<(unsigned)(((long long)n + FOLD_GROUPS_THREADS - 1) /
                           FOLD_GROUPS_THREADS),
                FOLD_GROUPS_THREADS, 0, stream>>>(best, lab, n, groups,
                                                  labels);
  return cudaGetLastError();
}

}  // namespace repro_torch
