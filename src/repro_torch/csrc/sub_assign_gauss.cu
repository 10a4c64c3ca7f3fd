// Step (f) alone for the full-covariance Gaussian family, on an NVIDIA
// Hopper card (sm_90a): the sub-label of every point under its own
// cluster, the second pass of the three-pass sweep (gibbs.sweep_tile with
// fused=False, ComponentFamily.sweep_ref, which the fit runs past the
// one-read sweep's d <= 128).
//
// Replaces the TPU kernel src/repro/kernels/assign.py:sub_assign_gauss
// (_sub_assign_gauss_kernel). Per point i with label l = labels[i] and
// Gumbel counter gidx[i]:
//   zb_i = first argmax_s [ 0.5 (sub_logdet_ls - |F_ls^T (x_i - mu_ls)|^2)
//                           - 0.5 d log(2 pi) + sublogw_ls
//                           + Gumbel(key_zb, gidx_i, s) ],  s in {0, 1}
// A label outside [0, K) gets sub-label 0.
//
// Slot windows. One call of the launcher takes the labels of one window
// [k0, k0 + W) of the K slots (W <= 8192: its label counts and offsets
// live in shared memory) and writes the sub-labels of exactly those
// points; the window at k0 = 0 also writes the 0 of the points whose label
// lies outside [0, K). The wrapper runs the windows of
// kernels/suffstats.py slot_windows in turn, so every point has one
// writer, and a point's sub-label depends on its own operands only.
//
// Design. The TPU kernel kept all (K, 2, d, d) factors resident in VMEM and
// gathered each point's own two. Here the points are grouped by label
// across the whole batch, so that a label's two factors are read from L2
// once for a run of its points and not once a point. Three launches a call
// (kernels/assign.py sub_plan holds the layout; the launcher refuses any
// other):
//  1. sub_count: the label histogram (block-aggregated integer atomics);
//     points whose label is outside [0, K) get sub-label 0 here;
//  2. sub_place: every block scans the counts into label offsets, and
//     writes the point ids grouped by label (the order within a label is
//     free: each point's result depends on its own operands only); block 0
//     also writes the offsets and the items, runs of at most ``per``
//     points of one label, ceil(count / per) a label;
//  3. the product, one block an item:
//     - narrow (d <= 64, template DP = d rounded up to a power of two):
//       the label's two factors staged in shared memory (sub_tile.cuh),
//       one thread a point running maha_narrow on them, as the one-read
//       sweep's step (f) does: the same device code, so the same bits;
//     - tiled (d > 64, DP = 128 or 256): Y = (X - mu_s) F_s as a
//       register-tiled product of the item's 64 points against 256
//       columns (both sub-factors at DP = 128; at DP = 256 one sub-factor
//       a pass, in column panels of 256, ceil(d / 256) panels a
//       sub-factor): row slabs of the factors (as in device memory), of
//       the points' x (transposed) and of the means stream through a ring
//       of cp.async stages; x - mu is formed once a slab in shared memory;
//       each thread holds 8 points x 8 columns, the columns of one lane of
//       the warp layout (sub_col). The shared bytes do not grow with d.
//
// Bits. The parent's chains, whatever the grouping:
//  - narrow: sub_tile.cuh's maha_narrow, the first version's one thread a
//    point (its d-vector in registers, one chain over the padded width);
//  - a column of y is fmaf(x_r - mu_r, F_rc, y_c) over r in order (rows and
//    columns past d add exact zeros);
//  - |y|^2 at 64 < d <= 128 (the parent's four-lane layout): lane j's
//    chain fmaf(y, y, s) over columns 4 j + 16 t + q (t = 0..7, q = 0..3),
//    in order, then s + s^1, then + (s^2's sum): the chain runs through
//    the four threads that hold its columns (two values of t each, carried
//    by shuffles), then two xor shuffles;
//  - |y|^2 past d = 128 (the warp layout): lane l's chain over
//    columns l + 32 t, t = 0, 1, .. in order (t < 8 a panel, the chain
//    carried from panel to panel past d = 256), then the xor butterfly over
//    offsets 1, 2, 4, 8, 16: here a thread holds exactly lane l's columns
//    and lane l of the warp, so the butterfly is the parent's;
//  - then 0.5 (ld - maha) - half_d_log2pi, + sublogw, + Gumbel, strict `>`.
//
// What bounds it. 2 N 2 d^2 FLOP of fp32 FMA (no tensor cores: TF32 would
// change the bits) against N d 4 bytes of x and N 16 bytes of labels,
// indices and output: at the d = 256 fit's state (N = 4e5) 105 GFLOP, 1.6
// ms at 67 TFLOP/s, so the CUDA cores' fp32 rate bounds it. Each factor
// element is read from L2 once an item (64 points past d = 64, 256 below)
// and feeds 64 FMAs a thread for every 8 (DP = 256) or 2 (DP = 128)
// shared loads of a factor row.
//
// Limits: any d and K; a launch takes W <= 8192 slots (label counts in
// shared memory).
#include <cuda_runtime.h>
#include <stdint.h>

#include "assign_tile.cuh"
#include "block_stats.cuh"
#include "sub_tile.cuh"

namespace repro_torch {

constexpr int SUB_THREADS = 256;
constexpr int SUB_SORT_PB = 1024;     // points a block of sub_count / place
constexpr int SUB_MAX_K = 8192;       // slots a window
constexpr int SUB_NARROW_PER = SUB_THREADS;   // points a narrow item
constexpr int ST_PTS = 64;            // points a tiled item, 8 a warp
constexpr int ST_BK = 16;             // factor rows a slab
constexpr int ST_COLS = 256;          // columns a tile
constexpr int ST_XS = ST_PTS + 4;     // row stride of a staged x slab
constexpr int ST_STAGES = 3;

// The tiled layout at padded width DP (128: both sub-factors in one column
// tile, an x slab for each; 256: one sub-factor a tile, two passes of
// ceil(d / 256) column panels each).
template <int DP>
struct SubTiled {
  static constexpr int NX = DP == 128 ? 2 : 1;       // x slabs a stage
  static constexpr int PASSES = DP == 128 ? 1 : 2;   // sub-factors a pass
  static constexpr int XOFF = ST_BK * ST_COLS;       // x slabs in a stage
  static constexpr int MOFF = XOFF + NX * ST_BK * ST_XS;   // means
  static constexpr int STAGE = MOFF + NX * ST_BK;
  static_assert(DP == 128 || DP == 256, "tiled step (f)");
  static_assert(STAGE % 4 == 0 && XOFF % 4 == 0 && ST_XS % 4 == 0,
                "16-byte rows");
};

// Shared bytes of the product kernel for padded width dp (the wrapper's
// sub_plan computes the same; the launcher checks it).
__host__ inline int sub_smem_bytes(int dp) {
  if (dp <= 64) return (int)(sizeof(float) * gauss_tile_floats(dp, 2));
  const int stage = dp == 128 ? SubTiled<128>::STAGE : SubTiled<256>::STAGE;
  return (int)(sizeof(float) * ST_STAGES * stage);
}

// The columns of thread (lane) ln, in its chain order k = 0..7: at
// DP = 256 lane ln's columns ln + 32 k of the pass's sub-factor (the
// parent warp layout's lane ln); at DP = 128, lane 16 s + 4 j + h holds
// columns 4 j + 16 t + q of sub-factor s for t = 2 h + k / 4, q = k % 4 (a
// quarter of the parent's lane j's chain), two 16-byte runs of the slab
// row [F_0 row | F_1 row].
template <int DP>
__device__ __forceinline__ int sub_col(int ln, int k) {
  if constexpr (DP == 256) {
    return ln + 32 * k;
  } else {
    const int t = 2 * (ln & 3) + (k >> 2);
    return (ln >> 4) * 128 + ((ln >> 2) & 3) * 4 + 16 * t + (k & 3);
  }
}

// The window-local label of label l: l - k0 in [0, K), else -1.
__device__ __forceinline__ int sub_local(int l, int k0, int K) {
  return l >= k0 && l - k0 < K ? l - k0 : -1;
}

// ---- 1. the label histogram; sub-label 0 outside [0, k_all) ---------------
// K: the window's slots (labels k0 .. k0 + K - 1) of k_all.
__global__ void __launch_bounds__(SUB_THREADS) sub_count_kernel(
    const int* __restrict__ labels, int n, int K, int k0, int k_all,
    int* __restrict__ counts, int* __restrict__ sublabels) {
  extern __shared__ int hist[];                        // K
  for (int l = threadIdx.x; l < K; l += SUB_THREADS) hist[l] = 0;
  __syncthreads();
  const long long b0 = (long long)blockIdx.x * SUB_SORT_PB;
  const int np = (int)min((long long)SUB_SORT_PB, (long long)n - b0);
  for (int p = threadIdx.x; p < np; p += SUB_THREADS) {
    const int l = labels[b0 + p];
    const int lw = sub_local(l, k0, K);
    if (lw >= 0)
      atomicAdd(hist + lw, 1);
    else if (k0 == 0 && (l < 0 || l >= k_all))
      sublabels[b0 + p] = 0;
  }
  __syncthreads();
  for (int l = threadIdx.x; l < K; l += SUB_THREADS)
    if (hist[l] != 0) atomicAdd(counts + l, hist[l]);
}

// ---- 2. point ids grouped by label; the offsets and items ----------------
__global__ void __launch_bounds__(SUB_THREADS) sub_place_kernel(
    const int* __restrict__ labels, int n, int K, int k0, int per,
    const int* __restrict__ counts, int* __restrict__ cursor,
    int* __restrict__ start_out, int* __restrict__ items_out,
    int* __restrict__ order) {
  extern __shared__ int sp[];
  int* start = sp;                  // K + 1: label offsets
  int* local = start + K + 1;       // K + 1: items, then this block's counts
  int* base = local + K + 1;        // K: this block's first slot a label
  int* tmp = base + K;              // 32: the scan's warp totals
  const int tid = threadIdx.x;
  for (int l = tid; l <= K; l += SUB_THREADS) {
    const int c = l < K ? counts[l] : 0;
    start[l] = c;
    local[l] = (c + per - 1) / per;
  }
  __syncthreads();
  block_scan_excl(start, K + 1, tmp);
  block_scan_excl(local, K + 1, tmp);
  if (blockIdx.x == 0) {
    for (int l = tid; l <= K; l += SUB_THREADS) {
      start_out[l] = start[l];
      items_out[l] = local[l];
    }
  }
  __syncthreads();
  for (int l = tid; l < K; l += SUB_THREADS) local[l] = 0;
  __syncthreads();
  const long long b0 = (long long)blockIdx.x * SUB_SORT_PB;
  const int np = (int)min((long long)SUB_SORT_PB, (long long)n - b0);
  for (int p = tid; p < np; p += SUB_THREADS) {
    const int l = sub_local(labels[b0 + p], k0, K);
    if (l >= 0) atomicAdd(local + l, 1);
  }
  __syncthreads();
  for (int l = tid; l < K; l += SUB_THREADS) {
    const int c = local[l];
    base[l] = c != 0 ? start[l] + atomicAdd(cursor + l, c) : 0;
    local[l] = 0;
  }
  __syncthreads();
  for (int p = tid; p < np; p += SUB_THREADS) {
    const int l = sub_local(labels[b0 + p], k0, K);
    if (l >= 0) order[base[l] + atomicAdd(local + l, 1)] = (int)(b0 + p);
  }
}

// This block's item: label info[0], its points order[info[1] .. info[2]);
// false (for every thread) past the last item.
__device__ __forceinline__ bool sub_item(const int* __restrict__ start,
                                         const int* __restrict__ items,
                                         int K, int per, int* info) {
  if (threadIdx.x == 0) {
    const int b = blockIdx.x;
    int lo = -1;
    if (b < items[K]) {
      // items[lo] <= b < items[hi]: the label whose run holds item b
      int hi = K;
      lo = 0;
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (items[mid] <= b)
          lo = mid;
        else
          hi = mid;
      }
      info[1] = start[lo] + (b - items[lo]) * per;
      info[2] = min(info[1] + per, start[lo + 1]);
    }
    info[0] = lo;
  }
  __syncthreads();
  return info[0] >= 0;
}

// ---- 3a. narrow (d <= 64): the label's factors staged, a thread a point --
template <int DP>
__global__ void __launch_bounds__(SUB_THREADS) sub_narrow_kernel(
    const float* __restrict__ x, int d, int K, const float* __restrict__ sub_mu,
    const float* __restrict__ sub_chol, const float* __restrict__ sub_logdet,
    const float* __restrict__ sublogw, const long long* __restrict__ gidx,
    const long long* __restrict__ key_zb, float half_d_log2pi,
    const int* __restrict__ start, const int* __restrict__ items,
    const int* __restrict__ order, int* __restrict__ sublabels) {
  extern __shared__ __align__(16) float narrow_smem[];
  __shared__ int info[3];
  if (!sub_item(start, items, K, SUB_NARROW_PER, info)) return;
  const GaussTile<DP> st(narrow_smem, 2);
  stage_sub_labels<DP>(st, info, 1, d, sub_mu, sub_chol, sub_logdet,
                       sublogw);
  const int i = info[1] + threadIdx.x;
  if (i >= info[2]) return;
  const int p = order[i];
  float xr[DP];
  load_row<DP>(x + (size_t)p * d, d, xr);
  const uint32_t g = (uint32_t)gidx[p];
  const uint32_t kb0 = (uint32_t)key_zb[0], kb1 = (uint32_t)key_zb[1];
  float t2[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const float maha = maha_narrow<DP>(xr, st.f + (size_t)s * DP * DP,
                                       st.mu + s * DP);
    t2[s] = sub_logit<DP>(st, s, maha, half_d_log2pi) +
            gumbel(kb0, kb1, g, (uint32_t)s);
  }
  sublabels[p] = t2[1] > t2[0] ? 1 : 0;
}

// ---- 3b. tiled (d > 64) ---------------------------------------------------
// Copy row slab `slab` (rows r0 = slab ST_BK ..) of column tile `pass` into
// one stage: the factor rows (16-byte copies when ``vec``), the item's
// points' rows of x (transposed, zero past d and the item), and the means.
// At DP = 256 pass q is sub-factor q / npan's column panel q % npan
// (columns 256 (q % npan) ..). xrow[i] is this thread's point row of copy
// round i (point tid / ST_BK + 16 i).
template <int DP>
__device__ __forceinline__ void sub_load(const float* const* xrow,
                                         const float* __restrict__ f0,
                                         const float* __restrict__ m0, int d,
                                         int slab, int pass, int npan,
                                         bool vec, float* stage) {
  using T = SubTiled<DP>;
  const int tid = threadIdx.x, r0 = slab * ST_BK;
  const int ps = DP == 128 ? 0 : pass / npan;             // sub-factor
  const int c0 = DP == 128 ? 0 : ST_COLS * (pass % npan);  // panel column
  // factors: row r of the slab is [F_0 row | F_1 row] at DP = 128, the
  // pass's F_s panel row at 256, as in device memory (a copy round of a
  // warp is one run of a row: coalesced reads, conflict-free shared
  // writes)
  if (vec) {
#pragma unroll
    for (int i = 0; i < ST_BK * ST_COLS / 4 / SUB_THREADS; ++i) {
      const int e = tid + i * SUB_THREADS;
      const int r = e / (ST_COLS / 4), cc = 4 * (e % (ST_COLS / 4));
      const int s = DP == 128 ? cc >> 7 : ps;
      const int c = DP == 128 ? cc & 127 : c0 + cc;
      const bool ok = r0 + r < d && c < d;
      cp_async16(stage + r * ST_COLS + cc,
                 ok ? f0 + ((size_t)s * d + r0 + r) * d + c : f0,
                 ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < ST_BK; ++i) {
      const int e = tid + i * SUB_THREADS;
      const int r = e / ST_COLS, cc = e % ST_COLS;
      const int s = DP == 128 ? cc >> 7 : ps;
      const int c = DP == 128 ? cc & 127 : c0 + cc;
      const bool ok = r0 + r < d && c < d;
      cp_async4(stage + r * ST_COLS + cc,
                ok ? f0 + ((size_t)s * d + r0 + r) * d + c : f0, ok ? 4 : 0);
    }
  }
  // x: point tid / ST_BK + 16 i, row tid % ST_BK of the slab
  const int rr = tid % ST_BK, p0 = tid / ST_BK;
  const bool rok = r0 + rr < d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool ok = rok && xrow[i] != nullptr;
    cp_async4(stage + T::XOFF + rr * ST_XS + p0 + 16 * i,
              ok ? xrow[i] + r0 + rr : m0, ok ? 4 : 0);
  }
  if (tid < T::NX * ST_BK) {
    const int s = T::NX == 2 ? tid / ST_BK : ps, r = tid % ST_BK;
    const bool ok = r0 + r < d;
    cp_async4(stage + T::MOFF + tid, ok ? m0 + (size_t)s * d + r0 + r : m0,
              ok ? 4 : 0);
  }
}

template <int DP>
__global__ void __launch_bounds__(SUB_THREADS, 2) sub_tiled_kernel(
    const float* __restrict__ x, int d, int K, const float* __restrict__ sub_mu,
    const float* __restrict__ sub_chol, const float* __restrict__ sub_logdet,
    const float* __restrict__ sublogw, const long long* __restrict__ gidx,
    const long long* __restrict__ key_zb, float half_d_log2pi,
    const int* __restrict__ start, const int* __restrict__ items,
    const int* __restrict__ order, int* __restrict__ sublabels) {
  using T = SubTiled<DP>;
  extern __shared__ __align__(16) float ring[];
  __shared__ int info[3];
  __shared__ int pts[ST_PTS];
  if (!sub_item(start, items, K, ST_PTS, info)) return;
  const int l = info[0], np = info[2] - info[1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < ST_PTS) pts[tid] = tid < np ? order[info[1] + tid] : -1;
  __syncthreads();
  const float* xrow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = pts[tid / ST_BK + 16 * i];
    xrow[i] = q >= 0 ? x + (size_t)q * d : nullptr;
  }
  const float* f0 = sub_chol + (size_t)l * 2 * d * d;
  const float* m0 = sub_mu + (size_t)l * 2 * d;
  // lane i < 8 of warp w finishes point 8 w + i
  const int own = 8 * warp + lane;
  const bool owner = lane < 8 && own < np;
  const uint32_t g = owner ? (uint32_t)gidx[pts[own]] : 0u;
  const uint32_t kb0 = (uint32_t)key_zb[0], kb1 = (uint32_t)key_zb[1];
  float t2[2] = {0.f, 0.f};
  // 16-byte factor rows
  const bool vec = (d & 3) == 0 && ((uintptr_t)sub_chol & 15) == 0;

  const int ns = (d + ST_BK - 1) / ST_BK;
  // column panels a sub-factor (DP = 256): ceil(d / 256)
  const int npan = DP == 128 ? 1 : (d + ST_COLS - 1) / ST_COLS;
  const int steps = T::PASSES * npan * ns;
  float acc[8][8], carry[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    carry[i] = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[i][k] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < ST_STAGES - 1; ++i) {
    if (i < steps)
      sub_load<DP>(xrow, f0, m0, d, i % ns, i / ns, npan, vec,
                   ring + i * T::STAGE);
    cp_async_commit();
  }
  // this thread's x slab: the sub-factor of its columns (lanes 16.. hold
  // sub-factor 1 at DP = 128)
  const int xsel = T::NX == 2 ? (lane >> 4) * ST_BK * ST_XS : 0;
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<ST_STAGES - 2>();
    __syncthreads();
    const int tn = t + ST_STAGES - 1;
    if (tn < steps)
      sub_load<DP>(xrow, f0, m0, d, tn % ns, tn / ns, npan, vec,
                   ring + (tn % ST_STAGES) * T::STAGE);
    cp_async_commit();
    float* stage = ring + (t % ST_STAGES) * T::STAGE;
    {
      // x - mu_s of the slab's rows, once: one float4 of points a thread
      float* xs = stage + T::XOFF;
      const float* ms = stage + T::MOFF;
      const int r = tid / (ST_PTS / 4), p = 4 * (tid % (ST_PTS / 4));
      float4* q0 = reinterpret_cast<float4*>(xs + r * ST_XS + p);
      const float4 v = *q0;
      const float mv = ms[r];
      *q0 = make_float4(v.x - mv, v.y - mv, v.z - mv, v.w - mv);
      if constexpr (T::NX == 2) {
        const float mw = ms[ST_BK + r];
        *reinterpret_cast<float4*>(xs + ST_BK * ST_XS + r * ST_XS + p) =
            make_float4(v.x - mw, v.y - mw, v.z - mw, v.w - mw);
      }
    }
    __syncthreads();
    const float* xs = stage + T::XOFF + xsel + 8 * warp;
#pragma unroll
    for (int r = 0; r < ST_BK; ++r) {
      const float4 a0 = *reinterpret_cast<const float4*>(xs + r * ST_XS);
      const float4 a1 = *reinterpret_cast<const float4*>(xs + r * ST_XS + 4);
      const float* fr = stage + r * ST_COLS;
      float bv[8];
      if constexpr (DP == 256) {
        // lane l's columns l + 32 k: one conflict-free scalar load each
#pragma unroll
        for (int k = 0; k < 8; ++k) bv[k] = fr[sub_col<DP>(lane, k)];
      } else {
        const float4 b0 =
            *reinterpret_cast<const float4*>(fr + sub_col<DP>(lane, 0));
        const float4 b1 =
            *reinterpret_cast<const float4*>(fr + sub_col<DP>(lane, 4));
        bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
        bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
      }
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[i][k] = fmaf(av[i], bv[k], acc[i][k]);
      }
    }
    if (t % ns != ns - 1) continue;
    // the column tile is done: |y|^2 of the 8 points in the parent's order
    float m[8];
    if constexpr (DP == 256) {
      // lane l's chain over its columns of this panel, carried on from the
      // sub-factor's earlier panels (carry is 0 at a sub-factor's first)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float v = carry[i];
#pragma unroll
        for (int k = 0; k < 8; ++k) v = fmaf(acc[i][k], acc[i][k], v);
        carry[i] = v;
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
        acc[i][4] = acc[i][5] = acc[i][6] = acc[i][7] = 0.f;
      }
      if ((t / ns) % npan != npan - 1) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        m[i] = carry[i];
        carry[i] = 0.f;
      }
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          m[i] += __shfl_xor_sync(0xffffffffu, m[i], off);
      }
    } else {
      // lane s 16 + 4 j + h holds columns t = 2 h, 2 h + 1 of lane j's
      // chain: the chain runs h = 0..3, carried by shuffles
#pragma unroll
      for (int i = 0; i < 8; ++i) m[i] = 0.f;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const bool mine = (lane & 3) == h;
        const int src = (lane & ~3) | h;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float v = m[i];
#pragma unroll
          for (int k = 0; k < 8; ++k) v = fmaf(acc[i][k], acc[i][k], v);
          m[i] = __shfl_sync(0xffffffffu, mine ? v : m[i], src);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        m[i] += __shfl_xor_sync(0xffffffffu, m[i], 4);
        m[i] += __shfl_xor_sync(0xffffffffu, m[i], 8);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[i][k] = 0.f;
    }
    // point lane & 7's value: sub-factor `pass` (DP = 256), or lane >> 4's
    float mi = m[0];
#pragma unroll
    for (int i = 1; i < 8; ++i) mi = (lane & 7) == i ? m[i] : mi;
    if constexpr (DP == 128) {
      const float m1 = __shfl_sync(0xffffffffu, mi, (lane + 16) & 31);
      if (owner) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const size_t ks = 2 * (size_t)l + s;
          float v = 0.5f * (__ldg(sub_logdet + ks) - (s == 0 ? mi : m1)) -
                    half_d_log2pi;
          v = v + __ldg(sublogw + ks);
          t2[s] = v + gumbel(kb0, kb1, g, (uint32_t)s);
        }
      }
    } else if (owner) {
      const int s = t / ns / npan;
      const size_t ks = 2 * (size_t)l + s;
      float v = 0.5f * (__ldg(sub_logdet + ks) - mi) - half_d_log2pi;
      v = v + __ldg(sublogw + ks);
      t2[s] = v + gumbel(kb0, kb1, g, (uint32_t)s);
    }
  }
  cp_async_wait<0>();
  if (owner) sublabels[pts[own]] = t2[1] > t2[0] ? 1 : 0;
}

template <class Kernel>
int launch_product(Kernel kernel, int smem, int grid, const float* x, int d,
                   int K, const float* sub_mu, const float* sub_chol,
                   const float* sub_logdet, const float* sublogw,
                   const long long* gidx, const long long* key_zb,
                   const int* start, const int* items, const int* order,
                   int* sublabels, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const float half_d_log2pi = (float)(0.5 * d * 1.8378770664093453);
  kernel<<<grid, SUB_THREADS, smem, stream>>>(
      x, d, K, sub_mu, sub_chol, sub_logdet, sublogw, gidx, key_zb,
      half_d_log2pi, start, items, order, sublabels);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// One slot window [k0, k0 + W) of K slots: sub_mu .. sublogw are the whole
// (K, 2, ...) sub-components, of which it reads the window's. scratch:
// 4 W + 2 + n ints, which the launcher zeroes where it must (the counts
// and the placement cursors: a memset on the stream, no kernel of the
// caller's). dp, per, grid, smem and sort_smem are the wrapper's sub_plan
// for the window.
extern "C" int sub_assign_gauss_launch(
    const float* x, int n, int d, const int* labels, int K, int k0, int W,
    const float* sub_mu, const float* sub_chol, const float* sub_logdet,
    const float* sublogw, const long long* gidx, const long long* key_zb,
    int dp, int per, int grid, int smem, int sort_smem, int* scratch,
    int* sublabels, void* stream) {
  using namespace repro_torch;
  if (n <= 0 || K <= 0 || W <= 0 || W > SUB_MAX_K || k0 < 0 || k0 > K - W ||
      d <= 0)
    return (int)cudaErrorInvalidValue;
  const int want = d <= 4 ? 4 : d <= 8 ? 8 : d <= 16 ? 16 : d <= 32 ? 32
                 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
  const int want_per = want <= 64 ? SUB_NARROW_PER : ST_PTS;
  const long long want_grid =
      ((long long)n + want_per - 1) / want_per + (W < n ? W : n);
  if (dp != want || per != want_per || (long long)grid != want_grid ||
      smem != sub_smem_bytes(want))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* counts = scratch;
  int* cursor = counts + W;
  int* start = cursor + W;
  int* items = start + W + 1;
  int* order = items + W + 1;
  const int sort_grid = (n + SUB_SORT_PB - 1) / SUB_SORT_PB;
  const int count_smem = (int)sizeof(int) * W;
  const int place_smem = (int)sizeof(int) * (3 * W + 2 + 32);
  if (sort_smem != place_smem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sub_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      count_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sub_place_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               place_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(counts, 0, sizeof(int) * 2 * (size_t)W, s);
  if (err != cudaSuccess) return (int)err;
  sub_count_kernel<<<sort_grid, SUB_THREADS, count_smem, s>>>(
      labels, n, W, k0, K, counts, sublabels);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sub_place_kernel<<<sort_grid, SUB_THREADS, place_smem, s>>>(
      labels, n, W, k0, per, counts, cursor, start, items, order);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the window's sub-components: labels are window-local from here
  const size_t w0 = 2 * (size_t)k0;
  sub_mu += w0 * d;
  sub_chol += w0 * d * d;
  sub_logdet += w0;
  sublogw += w0;
#define REPRO_SUB_PRODUCT(KERNEL)                                           \
  return launch_product(KERNEL, smem, grid, x, d, W, sub_mu, sub_chol,     \
                        sub_logdet, sublogw, gidx, key_zb, start, items,   \
                        order, sublabels, s)
  switch (dp) {
    case 4: REPRO_SUB_PRODUCT(sub_narrow_kernel<4>);
    case 8: REPRO_SUB_PRODUCT(sub_narrow_kernel<8>);
    case 16: REPRO_SUB_PRODUCT(sub_narrow_kernel<16>);
    case 32: REPRO_SUB_PRODUCT(sub_narrow_kernel<32>);
    case 64: REPRO_SUB_PRODUCT(sub_narrow_kernel<64>);
    case 128: REPRO_SUB_PRODUCT(sub_tiled_kernel<128>);
    default: REPRO_SUB_PRODUCT(sub_tiled_kernel<256>);
  }
#undef REPRO_SUB_PRODUCT
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
