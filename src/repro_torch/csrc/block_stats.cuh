// Per-STATS_BLOCK sub-cluster statistics of one block of points, shared by
// the sweep_gauss and suffstats_labels kernels (n, sx, sxx) and the
// sweep_linear and moments_labels kernels (n and first moments only).
//
// One thread block owns STATS_BLOCK (= 1024) consecutive points and writes
// their partial (n, sx, sxx) for every segment s = 2 * label + sublabel:
//
//   n[s]          = sum_i w_i
//   sx[s][a]      = sum_i w_i x_ia
//   sxx[s][a][b]  = sum_i (w_i x_ia) x_ib
//
// over the points i of the block with segment s (w = the valid mask).
// No float atomics: the block's point ids are sorted by segment with a
// stable counting sort, then every output entry is one sequential sum over
// its segment's points in point order. The result does not depend on
// scheduling, so two launches on the same inputs give identical bits.
// moments_labels' first moments use sort_by_segment (warp 0 alone) and
// accumulate_moments; sweep_linear's fold sorts with sort_segments_block
// and walks only the non-empty segments; the Gaussian fold is
// fold_segments, below.
#pragma once

#include <stdint.h>

namespace repro_torch {

constexpr int STATS_BLOCK = 1024;

// seg[p] (p < np): the point's segment in [0, S), or -1 to leave it out.
// Writes idx (point ids grouped by segment, ascending within a segment) and
// start[0..S] (segment offsets into idx). cursor needs S ints of scratch.
__device__ void sort_by_segment(const int* seg, int np, int S, int* start,
                                int* cursor, int* idx) {
  for (int s = threadIdx.x; s <= S; s += blockDim.x) start[s] = 0;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const unsigned lower = (1u << lane) - 1u;
    for (int b = 0; b < np; b += 32) {           // counts
      const int p = b + lane;
      const int s = p < np ? seg[p] : -1;
      const unsigned same = __match_any_sync(0xffffffffu, s);
      if (s >= 0 && (same & lower) == 0u) start[s + 1] += __popc(same);
      __syncwarp();
    }
    if (lane == 0)
      for (int s = 0; s < S; ++s) start[s + 1] += start[s];
    __syncwarp();
    for (int s = lane; s < S; s += 32) cursor[s] = start[s];
    __syncwarp();
    for (int b = 0; b < np; b += 32) {           // stable placement
      const int p = b + lane;
      const int s = p < np ? seg[p] : -1;
      const unsigned same = __match_any_sync(0xffffffffu, s);
      if (s >= 0) idx[cursor[s] + __popc(same & lower)] = p;
      __syncwarp();
      if (s >= 0 && (same & lower) == 0u) cursor[s] += __popc(same);
      __syncwarp();
    }
  }
  __syncthreads();
}

// First moments of one feature chunk [c0, c0 + dc) of this block's points:
// f, w are the block's (np, dp) rows and (np,) weights; n_out (nullptr to
// skip) gets the (S,) weighted counts and sf_out the chunk's columns of the
// (S, dp) first-moment slice. Consecutive threads take consecutive features
// of one segment, so a warp reads a point's row chunk in one sweep. The
// entry index runs to S dc in an int: callers keep S dc < 2^31.
__device__ void accumulate_moments(const float* __restrict__ f,
                                   const float* __restrict__ w, size_t dp,
                                   int S, const int* start, const int* idx,
                                   int c0, int dc, float* __restrict__ n_out,
                                   float* __restrict__ sf_out) {
  if (n_out != nullptr) {
    for (int e = threadIdx.x; e < S; e += blockDim.x) {
      float acc = 0.f;
      for (int i = start[e]; i < start[e + 1]; ++i) acc += w[idx[i]];
      n_out[e] = acc;
    }
  }
  if (((dp | (size_t)dc | (size_t)c0) & 3) == 0 &&
      (((uintptr_t)f | (uintptr_t)sf_out) & 15) == 0) {
    // four consecutive features per thread, 16-byte loads and stores
    const int dq = dc >> 2;
    for (int e = threadIdx.x; e < S * dq; e += blockDim.x) {
      const int s = e / dq, a = c0 + 4 * (e - s * dq);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int i = start[s]; i < start[s + 1]; ++i) {
        const int p = idx[i];
        const float wp = w[p];
        const float4 v = *reinterpret_cast<const float4*>(f + (size_t)p * dp
                                                          + a);
        acc.x = fmaf(wp, v.x, acc.x);
        acc.y = fmaf(wp, v.y, acc.y);
        acc.z = fmaf(wp, v.z, acc.z);
        acc.w = fmaf(wp, v.w, acc.w);
      }
      *reinterpret_cast<float4*>(sf_out + (size_t)s * dp + a) = acc;
    }
    return;
  }
  for (int e = threadIdx.x; e < S * dc; e += blockDim.x) {
    const int s = e / dc, a = c0 + (e - s * dc);
    float acc = 0.f;
    // unrolled so several loads are in flight; the sum stays in point order
#pragma unroll 4
    for (int i = start[s]; i < start[s + 1]; ++i) {
      const int p = idx[i];
      acc = fmaf(w[p], f[(size_t)p * dp + a], acc);
    }
    sf_out[(size_t)s * dp + a] = acc;
  }
}

// ---------------------------------------------------------------------------
// The Gaussian segment fold (sweep_gauss.cu, suffstats_labels.cu): n, sx and
// sxx of every segment of one STATS_BLOCK, in three block-wide phases.
//
//  1. Sort (sort_segments_block). Every warp counts its batches of 32
//     points with __match_any_sync (shared integer atomics: the counts do
//     not depend on their order), the block scans the S counts into
//     offsets, then warp 0 places the point ids stably (point order within
//     a segment) while the other warps write the zeros of the empty
//     segments with 16-byte stores and no loop over points.
//  2. Gram tiles (gram_segments). A team of (E / 8)^2 threads owns one E x E
//     tile of one segment's sxx at a time, 8 x 8 entries a thread (rows
//     4 ty + i and E / 2 + 4 ty + i, columns likewise from tx, so a row's
//     stores are 16-byte runs), and walks the segment's points in point
//     order: for each, w x_a once (__fmul_rn) and fmaf(w x_a, x_b, acc),
//     the parent chain. E is 8, 16, 32 or 64 at d <= 64 (so 256, 64, 16 or
//     4 teams keep every thread busy) and 128 above (the whole block; a
//     d > 128 segment is ceil(d / 128)^2 tiles). The tile's first row of
//     threads folds sx (fmaf(w, x_b, acc)) and its first thread n (acc +
//     w) in the same walk. A point's row is read straight from global memory (L1 and
//     L2 hold the block's rows; a thread's 8 + 8 values of it are 4 float4
//     loads for 64 FMAs), the next point's loads issued before the current
//     point's FMAs. Several blocks (1 to 4) may share a STATS_BLOCK, each
//     taking every parts-th (segment, tile) item (suffstats_labels.cu).
//
// Every output is one sequential chain over its segment's points in point
// order, as the first version (one thread an entry) had it, so the bits do
// not depend on E, the team or the launch: two launches agree, and the
// three-pass and one-read paths agree.
// ---------------------------------------------------------------------------

// Ints of shared scratch sort_segments_block needs beside seg, idx and
// start: the cursor (S) and the scan's warp totals (32).
__host__ __device__ inline size_t sort_scratch_ints(int S) {
  return (size_t)S + 32;
}

// Exclusive scan of a[0..len) in place by the whole block (blockDim.x a
// multiple of 32, at most 1024); returns the total to every thread. Each
// thread scans a run of ceil(len / blockDim.x) entries; the run totals are
// scanned with warp shuffles and the warp totals in tmp (32 ints).
__device__ int block_scan_excl(int* a, int len, int* tmp) {
  const int nt = blockDim.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int per = (len + nt - 1) / nt;
  const int lo = min(len, t * per), hi = min(len, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) tmp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int nw = nt >> 5;
    int v = lane < nw ? tmp[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane < nw) tmp[lane] = v;          // inclusive warp totals
  }
  __syncthreads();
  int run = (warp > 0 ? tmp[warp - 1] : 0) + incl - sum;
  const int total = tmp[(nt >> 5) - 1];
  for (int i = lo; i < hi; ++i) {
    const int c = a[i];
    a[i] = run;
    run += c;
  }
  __syncthreads();
  return total;
}

// seg[p] (p < np): the point's segment in [0, S), or -1 to leave it out.
// Writes start[0..S] (segment offsets) and idx (point ids grouped by
// segment, ascending within a segment). scratch holds sort_scratch_ints(S)
// ints. ``idle(start)`` is called by warps 1.. while warp 0 places the ids
// (start is final then; idx is not); all threads return after a barrier.
template <class Idle>
__device__ void sort_segments_block(const int* seg, int np, int S,
                                    int* start, int* idx, int* scratch,
                                    Idle idle) {
  int* cursor = scratch;
  int* tmp = scratch + S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  for (int s = threadIdx.x; s <= S; s += blockDim.x) start[s] = 0;
  __syncthreads();
  for (int b = 32 * warp; b < np; b += 32 * nw) {     // counts
    const int p = b + lane;
    const int s = p < np ? seg[p] : -1;
    const unsigned same = __match_any_sync(0xffffffffu, s);
    if (s >= 0 && (same & lower) == 0u) atomicAdd(start + s, __popc(same));
  }
  __syncthreads();
  block_scan_excl(start, S + 1, tmp);                  // start[S] = total
  for (int s = threadIdx.x; s < S; s += blockDim.x) cursor[s] = start[s];
  __syncthreads();
  if (warp == 0) {
    for (int b = 0; b < np; b += 32) {                 // stable placement
      const int p = b + lane;
      const int s = p < np ? seg[p] : -1;
      const unsigned same = __match_any_sync(0xffffffffu, s);
      if (s >= 0) idx[cursor[s] + __popc(same & lower)] = p;
      __syncwarp();
      if (s >= 0 && (same & lower) == 0u) cursor[s] += __popc(same);
      __syncwarp();
    }
  } else {
    idle(start);
  }
  __syncthreads();
}

// Zeros of the empty segments' n, sx and sxx (entries of a block's (S,),
// (S, d), (S, d, d) slices), written by the threads [t0, t0 + nt) of the
// block: sxx runs with 16-byte stores when a segment's d^2 floats start
// 16-byte aligned (even d, aligned base). Only the segments s = part mod
// parts: the block is part ``part`` of ``parts`` sharing a STATS_BLOCK.
__device__ void zero_empty_segments(const int* start, int d, int S, int t0,
                                    int nt, float* __restrict__ n_out,
                                    float* __restrict__ sx_out,
                                    float* __restrict__ sxx_out, int part,
                                    int parts) {
  const int t = threadIdx.x - t0;
  const size_t dd = (size_t)d * d;
  const bool vec = (d & 1) == 0 && ((uintptr_t)sxx_out & 15) == 0;
  for (int s = part; s < S; s += parts) {
    if (start[s + 1] != start[s]) continue;           // uniform
    if (t == 0) n_out[s] = 0.f;
    for (int a = t; a < d; a += nt) sx_out[(size_t)s * d + a] = 0.f;
    float* z = sxx_out + (size_t)s * dd;
    if (vec) {
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      for (size_t e = t; e < dd / 4; e += nt)
        reinterpret_cast<float4*>(z)[e] = zero;
    } else {
      for (size_t e = t; e < dd; e += nt) z[e] = 0.f;
    }
  }
}

// This thread's 8 values of point row xp at columns c0 + {0..3} and
// c1 + {0..3}, zero at and past d; VEC: d % 4 == 0 and 16-byte rows.
template <bool VEC>
__device__ __forceinline__ void gram_load8(const float* __restrict__ xp,
                                           int d, int c0, int c1,
                                           float (&v)[8]) {
  if (VEC) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 u = c0 < d ? __ldg(reinterpret_cast<const float4*>(xp + c0))
                            : z;
    const float4 q = c1 < d ? __ldg(reinterpret_cast<const float4*>(xp + c1))
                            : z;
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
    v[4] = q.x; v[5] = q.y; v[6] = q.z; v[7] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = c0 + i < d ? __ldg(xp + c0 + i) : 0.f;
      v[4 + i] = c1 + i < d ? __ldg(xp + c1 + i) : 0.f;
    }
  }
}

// Store 4 entries of row r at columns c.. of a (d, d) slab, those below d.
template <bool VEC>
__device__ __forceinline__ void gram_store4(float* __restrict__ out, int d,
                                            int r, int c, const float* v) {
  if (r >= d) return;
  float* o = out + (size_t)r * d + c;
  if (VEC) {
    if (c < d) *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2],
                                                           v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c + j < d) o[j] = v[j];
  }
}

// Phase 2 on a sorted block (start, idx from sort_segments_block): the
// sxx, sx and n of every non-empty segment. E: the tile edge (8, 16, 32,
// 64 or 128; E < 128 needs d <= E). x the block's rows (np, d), w its
// weights (shared or global), VEC as in gram_load8 (and an aligned
// sxx_out). Called by every thread of a 256-thread block, which takes the
// items (segment, tile) numbered part mod parts.
template <int E, bool VEC>
__device__ void gram_segments(const float* __restrict__ x, const float* w,
                              int d, int S, const int* start, const int* idx,
                              float* __restrict__ n_out,
                              float* __restrict__ sx_out,
                              float* __restrict__ sxx_out, int part,
                              int parts) {
  constexpr int TW = E / 8, T = TW * TW, H = E / 2;
  const int team = threadIdx.x / T, teams = blockDim.x / T;
  const int tt = threadIdx.x % T, tx = tt % TW, ty = tt / TW;
  const int nt = (d + E - 1) / E;
  const size_t dd = (size_t)d * d;
  // items: (segment, tile row, tile column), segments in order
  for (int it = part + parts * team; it < S * nt * nt; it += parts * teams) {
    const int s = it / (nt * nt), tile = it % (nt * nt);
    const int i0 = start[s], i1 = start[s + 1];
    if (i0 == i1) continue;                       // zeros written already
    const int ta = tile / nt, tb = tile % nt;
    const int a0 = ta * E + 4 * ty, a1 = a0 + H;
    const int b0 = tb * E + 4 * tx, b1 = b0 + H;
    const bool do_sx = ta == 0 && ty == 0;
    const bool do_n = ta == 0 && tb == 0 && tt == 0;
    float acc[8][8], sx[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sx[i] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    float n = 0.f;
    float xa[8], xb[8];
    int p = idx[i0];
    float wp = w[p];
    gram_load8<VEC>(x + (size_t)p * d, d, a0, a1, xa);
    gram_load8<VEC>(x + (size_t)p * d, d, b0, b1, xb);
    for (int i = i0; i < i1; ++i) {
      // the next point's loads go out before this point's FMAs
      float na[8], nb[8], nw = 0.f;
      const bool more = i + 1 < i1;
      if (more) {
        const int q = idx[i + 1];
        nw = w[q];
        gram_load8<VEC>(x + (size_t)q * d, d, a0, a1, na);
        gram_load8<VEC>(x + (size_t)q * d, d, b0, b1, nb);
      }
      float wa[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) wa[r] = __fmul_rn(wp, xa[r]);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(wa[r], xb[c], acc[r][c]);
      }
      if (do_sx) {
#pragma unroll
        for (int c = 0; c < 8; ++c) sx[c] = fmaf(wp, xb[c], sx[c]);
      }
      if (do_n) n = n + wp;
      if (more) {
        wp = nw;
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          xa[r] = na[r];
          xb[r] = nb[r];
        }
      }
    }
    float* o = sxx_out + (size_t)s * dd;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      gram_store4<VEC>(o, d, a0 + r, b0, acc[r]);
      gram_store4<VEC>(o, d, a0 + r, b1, acc[r] + 4);
      gram_store4<VEC>(o, d, a1 + r, b0, acc[4 + r]);
      gram_store4<VEC>(o, d, a1 + r, b1, acc[4 + r] + 4);
    }
    if (do_sx) {
      float* so = sx_out + (size_t)s * d;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (b0 + c < d) so[b0 + c] = sx[c];
        if (b1 + c < d) so[b1 + c] = sx[4 + c];
      }
    }
    if (do_n) n_out[s] = n;
  }
}

// The tile edge of gram_segments for width d (the wrapper's stats_plan
// gives the same; the launchers check it).
__host__ __device__ inline int gram_edge(int d) {
  return d <= 8 ? 8 : d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 128;
}

// The whole fold of one STATS_BLOCK: seg[p] set for its np points, shared
// idx (STATS_BLOCK), start (S + 1) and scratch (sort_scratch_ints(S));
// outputs this block's (S,), (S, d), (S, d, d) slices. E = gram_edge(d).
// parts blocks may share a STATS_BLOCK (each sorts it and writes the
// outputs of its part); an output's bits do not depend on parts.
template <int E, bool VEC>
__device__ void fold_segments(const float* __restrict__ x, const float* w,
                              int d, int np, int S, const int* seg, int* idx,
                              int* start, int* scratch,
                              float* __restrict__ n_out,
                              float* __restrict__ sx_out,
                              float* __restrict__ sxx_out, int part = 0,
                              int parts = 1) {
  sort_segments_block(seg, np, S, start, idx, scratch, [&](const int* st) {
    zero_empty_segments(st, d, S, 32, blockDim.x - 32, n_out, sx_out,
                        sxx_out, part, parts);
  });
  gram_segments<E, VEC>(x, w, d, S, start, idx, n_out, sx_out, sxx_out, part,
                        parts);
}

}  // namespace repro_torch
