// The register-tiled Gaussian whitening of 16 < d <= 128 (and of any
// d <= 32 padded to 32), shared by three kernels: step (e) of the one-read
// sweep (sweep_gauss.cu sweep_assign_tiled), the labels of assign_gauss.cu
// and the log-likelihood rows of loglik_gauss.cu. It is the device half of
// the TPU kernels src/repro/kernels/assign.py:assign_gauss, loglik.py:loglik
// and step (e) of src/repro/kernels/sweep.py:sweep_gauss at these widths.
//
// Per live slot k the whitening is Y = (X - mu_k) F_k on a tile of TE_BM
// points. A block keeps its points' x resident in shared memory
// (transposed, DP rows, zero past d and np) and streams the factors of the
// live slots, SP = 128 / DP of them side by side in a 128-column tile (the
// slab row holds slot s's DP columns at s FS), in row slabs of BK rows
// through a ring of TE_STAGES buffers with cp.async. Each of the 256
// threads holds an 8 x 8 register tile of Y: rows g0 + i and g1 + i (64
// apart), and columns 4 u + q and DP / 2 + 4 u + q of one slot s (u the
// thread's place among the slot's TPS = DP / 8 threads); x - mu_k is formed
// in registers from the resident x and the slab's mean (8 subtractions a
// row for 64 FMAs), as the per-point loops form it.
//
// Bits. A column is the chain fmaf(x_r - mu_r, F_rc, y_c) over r in order
// (rows and columns past d add exact zeros), and |y|^2 follows the order of
// the one-thread-a-point layouts, carried from thread to thread by
// shuffles:
//  - DP = 32, 64 (maha_narrow, assign_tile.cuh): one chain fmaf(y_c, y_c,
//    m) over c = 0..DP-1, in blocks of 4 columns, block b held by thread
//    b % TPS; zero columns past d add nothing, so d <= 16 padded to 32
//    gives the bits of its own narrower chain;
//  - DP = 128 (maha_wide): the chain of lane j over columns 4 j + 16 t + q
//    (threads j + 4 (t % 4)), then (s0 + s1) + (s2 + s3) by the same two
//    xor shuffles.
// So a (point, slot) value depends on (x_i, slot, d) alone: not on N, the
// tile, the slot group or the grid.
//
// Outputs (template ASSIGN):
//  - labels (step (e)): the live slots walk first, in slot order, and the
//    logit is 0.5 (logdet_k - |y|^2) - 0.5 d log(2 pi) + logw_k + Gumbel;
//    each thread keeps a strict-`>` running max over its slots for the
//    rows it owns. An inactive slot's logit, -1e30 + its Gumbel, is -1e30
//    exactly or +inf in the Threefry top bin (threefry.cuh top_bin), and is
//    drawn by a second pass, two threads a point. The partials are merged
//    by (max, least slot), which is the first maximum of one walk over all
//    slots in order, bit for bit (starting from (-1e30, slot 0), as the
//    walk does).
//  - log-likelihood rows: every slot counts as live, with no logw and no
//    Gumbel; out[i K + k] = 0.5 (logdet_k - |y|^2) - 0.5 d log(2 pi),
//    written once.
//
// Slot groups. The grid is point tiles x slot groups (blockIdx.y of
// gridDim.y, kernels/assign.py gauss_plan). A block counts the live slots
// on the card (no host read), and group g takes the column tiles
// [g T / G, (g + 1) T / G) of the T = ceil(live / SP) tiles, and the
// inactive slots [g K / G, (g + 1) K / G): each once. With one group the
// labels are written here; with several each group writes its (max,
// label) row and fold_groups (assign_tile.cuh) merges the rows by (max,
// least slot). The log-likelihood needs no fold.
//
// The live slots of a block's column tiles are listed in shared memory
// TE_LIST at a time (a block with more walks them in chunks, the ring
// drained between chunks), so the shared bytes do not grow past K =
// TE_LIST and any K is taken.
#pragma once

#include <math.h>
#include <stdint.h>

#include "assign_tile.cuh"
#include "threefry.cuh"

namespace repro_torch {

constexpr int TE_BM = 128;               // points a block
constexpr int TE_THREADS = 256;
constexpr int TE_XS = TE_BM + 4;         // row stride of the resident x
constexpr int TE_STAGES = 3;
constexpr int TE_LIST = 2048;            // live slots a block lists at once

template <int DP>
struct TiledE {
  static constexpr int SP = 128 / DP;             // slots a column tile
  static constexpr int TPS = DP / 8;              // threads a slot
  // slot stride in a slab row: at DP = 32, 48 puts the two slots a
  // quarter-warp reads on different banks
  static constexpr int FS = DP == 32 ? 48 : DP;
  static constexpr int ROW = SP * FS;             // floats a slab row
  static constexpr int BK = DP == 128 ? 16 : 32;  // rows a slab
  static constexpr int MS = BK + 1;               // mean stride a slot
  static constexpr int STAGE = (BK * ROW + SP * MS + 3) / 4 * 4;
  static constexpr int XT = DP * TE_XS;
  static constexpr int PARTS = SP + 2;            // partials a point
  static constexpr int OWN = TPS >= 8 ? 1 : 8 / TPS;   // rows a thread owns
  static_assert(SP * TPS == 16 && BK * SP <= TE_THREADS &&
                    (BK * 32) % TE_THREADS == 0 && DP % BK == 0 &&
                    TE_LIST % SP == 0,
                "tiled step (e)");
};

// Shared bytes of te_tile<DP> for K slots: the x tile, the ring, the
// partials, the warp counts and the list of live slots.
template <int DP>
__host__ inline size_t te_smem_bytes(int K) {
  using T = TiledE<DP>;
  const size_t list = K < TE_LIST ? (size_t)K : (size_t)TE_LIST;
  return sizeof(float) * ((size_t)T::XT + (size_t)TE_STAGES * T::STAGE +
                          2 * (size_t)T::PARTS * TE_BM + 32 + list);
}

// Live slots: active[k] != 0, or every slot when active is nullptr.
__device__ __forceinline__ int te_count_live(const int* __restrict__ active,
                                             int K) {
  if (active == nullptr) return K;
  int na = 0;
  for (int k0 = 0; k0 < K; k0 += TE_THREADS) {
    const int k = k0 + (int)threadIdx.x;
    na += __syncthreads_count(k < K && __ldg(active + k) != 0);
  }
  return na;
}

// list[r - p0] = the r-th live slot in slot order, for p0 <= r < p1; tmp
// holds a count a warp. Ends with a barrier.
__device__ __forceinline__ void te_list_live(const int* __restrict__ active,
                                             int K, int p0, int p1,
                                             int* list, int* tmp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int run = 0;   // live slots before k0, the same in every thread
  for (int k0 = 0; k0 < K && run < p1; k0 += TE_THREADS) {
    const int k = k0 + tid;
    const bool a = k < K && __ldg(active + k) != 0;
    const unsigned m = __ballot_sync(0xffffffffu, a);
    if (lane == 0) tmp[warp] = __popc(m);
    __syncthreads();
    int before = run, total = run;
#pragma unroll
    for (int w = 0; w < TE_THREADS / 32; ++w) {
      const int c = tmp[w];
      before += w < warp ? c : 0;
      total += c;
    }
    const int r = before + __popc(m & ((1u << lane) - 1u));
    if (a && r >= p0 && r < p1) list[r - p0] = k;
    run = total;
    __syncthreads();
  }
}

// Copy row slab r0 of column tile tl (the live slots at positions tl SP +
// s, s < SP, those below p1; the slot at position j is list[j - p0], or j
// without a list) of the factors and means into one stage, zero past d and
// for missing slots.
template <int DP>
__device__ __forceinline__ void te_load(const float* __restrict__ chol,
                                        const float* __restrict__ mu,
                                        const int* list, int p0, int p1,
                                        int d, int tl, int r0, bool vec,
                                        float* stage) {
  using T = TiledE<DP>;
  float* fs = stage;
  float* ms = stage + T::BK * T::ROW;
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int Q = DP / 4, E = T::BK * T::SP * Q;
#pragma unroll
    for (int i = 0; i < E / TE_THREADS; ++i) {
      const int e = tid + i * TE_THREADS;
      const int r = e / (T::SP * Q), rem = e % (T::SP * Q);
      const int sp = rem / Q, c = 4 * (rem % Q);
      const int j = tl * T::SP + sp;
      const bool ok = j < p1 && r0 + r < d && c < d;
      const int k = ok ? (list != nullptr ? list[j - p0] : j) : 0;
      cp_async16(fs + r * T::ROW + sp * T::FS + c,
                 ok ? chol + ((size_t)k * d + r0 + r) * d + c : chol,
                 ok ? 16 : 0);
    }
  } else {
    constexpr int E = T::BK * T::SP * DP;
#pragma unroll 4
    for (int i = 0; i < E / TE_THREADS; ++i) {
      const int e = tid + i * TE_THREADS;
      const int r = e / (T::SP * DP), rem = e % (T::SP * DP);
      const int sp = rem / DP, c = rem % DP;
      const int j = tl * T::SP + sp;
      const bool ok = j < p1 && r0 + r < d && c < d;
      const int k = ok ? (list != nullptr ? list[j - p0] : j) : 0;
      cp_async4(fs + r * T::ROW + sp * T::FS + c,
                ok ? chol + ((size_t)k * d + r0 + r) * d + c : chol,
                ok ? 4 : 0);
    }
  }
  if (tid < T::SP * T::BK) {
    const int sp = tid / T::BK, r = tid % T::BK;
    const int j = tl * T::SP + sp;
    const bool ok = j < p1 && r0 + r < d;
    const int k = ok ? (list != nullptr ? list[j - p0] : j) : 0;
    cp_async4(ms + sp * T::MS + r, ok ? mu + (size_t)k * d + r0 + r : mu,
              ok ? 4 : 0);
  }
}

// |y|^2 of the thread's 8 rows for its slot, in the order of the
// one-thread-a-point layouts (above); every thread of the slot gets the 8
// values.
template <int DP>
__device__ __forceinline__ void te_maha(const float (&acc)[8][8], int tx,
                                        float (&m)[8]) {
  using T = TiledE<DP>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 8; ++i) m[i] = 0.f;
  if constexpr (DP < 128) {
    const int u = tx % T::TPS;
#pragma unroll
    for (int b = 0; b < 2 * T::TPS; ++b) {
      const int h = b / T::TPS;
      const bool mine = u == b % T::TPS;
      const int src = (lane & ~(T::TPS - 1)) | (b % T::TPS);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float v = m[i];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v = fmaf(acc[i][4 * h + q], acc[i][4 * h + q], v);
        m[i] = __shfl_sync(0xffffffffu, mine ? v : m[i], src);
      }
    }
  } else {
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int h = t / 4;
      const bool mine = (tx >> 2) == (t & 3);
      const int src = (lane & 16) | ((t & 3) << 2) | (tx & 3);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float v = m[i];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v = fmaf(acc[i][4 * h + q], acc[i][4 * h + q], v);
        m[i] = __shfl_sync(0xffffffffu, mine ? v : m[i], src);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      m[i] += __shfl_xor_sync(0xffffffffu, m[i], 1);
      m[i] += __shfl_xor_sync(0xffffffffu, m[i], 2);
    }
  }
}

// The tile of point tile blockIdx.x, slot group blockIdx.y (of gridDim.y),
// padded width DP (32, 64 or 128; d <= DP). Called by all TE_THREADS
// threads; smem holds te_smem_bytes<DP>(K).
//  - ASSIGN: step (e). With one group, lab_out gets the labels (best_out
//    nullptr); with several, group g's (max, label) of point i goes to
//    best_out / lab_out[g n + i].
//  - else: out[i K + k] for every slot (logw, active, slots, gidx unused).
template <int DP, bool ASSIGN>
__device__ __forceinline__ void te_tile(
    const float* __restrict__ x, int n, int d, const float* __restrict__ mu,
    const float* __restrict__ chol, const float* __restrict__ logdet,
    const float* __restrict__ logw, const int* __restrict__ active,
    const int* __restrict__ slots, int K, const long long* __restrict__ gidx,
    uint32_t kz0, uint32_t kz1, float half_d_log2pi, bool vec, float* smem,
    float* __restrict__ out, float* __restrict__ best_out,
    int* __restrict__ lab_out) {
  using T = TiledE<DP>;
  float* xt = smem;
  float* ring = xt + T::XT;
  float* pb = ring + TE_STAGES * T::STAGE;
  int* pl = reinterpret_cast<int*>(pb + T::PARTS * TE_BM);
  int* tmp = pl + T::PARTS * TE_BM;
  int* list = tmp + 32;
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * TE_BM;
  const int np = (int)min((long long)TE_BM, (long long)n - base);
  const int groups = gridDim.y, grp = blockIdx.y;

  // this group's share of the live slots' column tiles
  const int na = te_count_live(ASSIGN ? active : nullptr, K);
  const int nt = (na + T::SP - 1) / T::SP;
  const int t_lo = (int)((long long)grp * nt / groups);
  const int t_hi = (int)((long long)(grp + 1) * nt / groups);
  // the tile's points, transposed, zero past d and np
  if (t_lo < t_hi) {
    const float* xb = x + base * d;
    for (int e = tid; e < TE_BM * DP; e += TE_THREADS) {
      const int p = e / DP, r = e % DP;
      xt[r * TE_XS + p] =
          (p < np && r < d) ? __ldg(xb + (size_t)p * d + r) : 0.f;
    }
  }

  const int tx = tid % 16, ty = tid / 16;
  const int s = tx / T::TPS, u = tx % T::TPS;
  const int g0 = 4 * ty, g1 = g0 + TE_BM / 2;
  const int cA = s * T::FS + 4 * u, cB = cA + DP / 2;
  // the rows this thread owns: i = u + o TPS (i < 8), point g(i)
  float best[T::OWN];
  int lab[T::OWN];
  uint32_t gp[T::OWN];
#pragma unroll
  for (int o = 0; o < T::OWN; ++o) {
    const int i = u + o * T::TPS;
    const int p = i < 4 ? g0 + i : g1 + i - 4;
    best[o] = NEG_INF;
    lab[o] = 0;
    gp[o] = (ASSIGN && i < 8 && p < np) ? (uint32_t)gidx[base + p] : 0u;
  }

  const int ns = (d + T::BK - 1) / T::BK;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  for (int c0 = t_lo; c0 < t_hi; c0 += TE_LIST / T::SP) {
    // a chunk of column tiles, its live slots listed (positions [p0, p1))
    const int c1 = min(t_hi, c0 + TE_LIST / T::SP);
    const int p0 = c0 * T::SP, p1 = min(na, c1 * T::SP);
    if (ASSIGN) te_list_live(active, K, p0, p1, list, tmp);
    const int* order = ASSIGN ? list : nullptr;
    const int steps = (c1 - c0) * ns;
#pragma unroll
    for (int i = 0; i < TE_STAGES - 1; ++i) {
      if (i < steps)
        te_load<DP>(chol, mu, order, p0, p1, d, c0 + i / ns,
                    (i % ns) * T::BK, vec, ring + i * T::STAGE);
      cp_async_commit();
    }
    for (int t = 0; t < steps; ++t) {
      cp_async_wait<TE_STAGES - 2>();
      __syncthreads();
      const int tn = t + TE_STAGES - 1;
      if (tn < steps)
        te_load<DP>(chol, mu, order, p0, p1, d, c0 + tn / ns,
                    (tn % ns) * T::BK, vec,
                    ring + (tn % TE_STAGES) * T::STAGE);
      cp_async_commit();
      const float* fs = ring + (t % TE_STAGES) * T::STAGE;
      const float* ms = fs + T::BK * T::ROW + s * T::MS;
      const float* xr = xt + (t % ns) * T::BK * TE_XS;
#pragma unroll
      for (int r = 0; r < T::BK; ++r) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(xr + r * TE_XS + g0);
        const float4 a1 =
            *reinterpret_cast<const float4*>(xr + r * TE_XS + g1);
        const float mv = ms[r];
        const float4 b0 =
            *reinterpret_cast<const float4*>(fs + r * T::ROW + cA);
        const float4 b1 =
            *reinterpret_cast<const float4*>(fs + r * T::ROW + cB);
        const float av[8] = {a0.x - mv, a0.y - mv, a0.z - mv, a0.w - mv,
                             a1.x - mv, a1.y - mv, a1.z - mv, a1.w - mv};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
      if (t % ns == ns - 1) {
        // the column tile is done: each slot's |y|^2, then its logit or row
        float m[8];
        te_maha<DP>(acc, tx, m);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
        }
        const int j = (c0 + t / ns) * T::SP + s;
        if (j < p1) {
          const int k = ASSIGN ? list[j - p0] : j;
          const float ldk = __ldg(logdet + k);
          const float lwk = ASSIGN ? __ldg(logw + k) : 0.f;
          const uint32_t sk = ASSIGN ? (uint32_t)__ldg(slots + k) : 0u;
#pragma unroll
          for (int o = 0; o < T::OWN; ++o) {
            const int io = u + o * T::TPS;
            float mi = m[0];
#pragma unroll
            for (int i = 1; i < 8; ++i) mi = io == i ? m[i] : mi;
            const int p = io < 4 ? g0 + io : g1 + io - 4;
            if (io < 8) {
              float v = 0.5f * (ldk - mi) - half_d_log2pi;
              if (ASSIGN) {
                v = v + lwk;
                v = v + gumbel(kz0, kz1, gp[o], sk);
                if (v > best[o]) {
                  best[o] = v;
                  lab[o] = k;
                }
              } else if (p < np) {
                out[(base + p) * (size_t)K + k] = v;
              }
            }
          }
        }
      }
    }
    // the ring and the list are refilled by the next chunk
    cp_async_wait<0>();
    __syncthreads();
  }
  if (!ASSIGN) return;

#pragma unroll
  for (int o = 0; o < T::OWN; ++o) {
    const int i = u + o * T::TPS;
    if (i < 8) {
      const int p = i < 4 ? g0 + i : g1 + i - 4;
      pb[s * TE_BM + p] = best[o];
      pl[s * TE_BM + p] = lab[o];
    }
  }
  {
    // the group's share of the inactive slots, two threads a point: -1e30
    // + Gumbel, -1e30 exactly but in the top bin (+inf)
    const int p = tid % TE_BM, h = tid / TE_BM;
    const int k_lo = (int)((long long)grp * K / groups);
    const int k_hi = (int)((long long)(grp + 1) * K / groups);
    float b = NEG_INF;
    int l = 0;
    if (p < np) {
      const uint32_t g = (uint32_t)gidx[base + p];
      for (int k = k_lo + h; k < k_hi; k += 2) {
        if (__ldg(active + k) != 0) continue;
        if (b < INFINITY &&
            top_bin(kz0, kz1, g, (uint32_t)__ldg(slots + k))) {
          b = INFINITY;
          l = k;
        }
      }
    }
    pb[(T::SP + h) * TE_BM + p] = b;
    pl[(T::SP + h) * TE_BM + p] = l;
  }
  __syncthreads();
  if (tid < np) {
    float b = NEG_INF;
    int l = 0;
#pragma unroll
    for (int q = 0; q < T::PARTS; ++q)
      take_best(pb[q * TE_BM + tid], pl[q * TE_BM + tid], b, l);
    if (best_out == nullptr) {
      lab_out[base + tid] = l;
    } else {
      best_out[(size_t)grp * n + base + tid] = b;
      lab_out[(size_t)grp * n + base + tid] = l;
    }
  }
}

}  // namespace repro_torch
