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
// No float atomics: warp 0 sorts the block's point ids by segment with a
// stable counting sort, then every output entry is one thread's sequential
// sum over its segment's points in point order. The result does not depend
// on scheduling, so two launches on the same inputs give identical bits.
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

// x, w: this block's points ((np, d) and (np,)); outputs: this block's
// (S,), (S, d), (S, d, d) partial slices. The entry index runs to S d^2 in
// an int: callers hold S <= 16384 and d <= 256 (S d^2 <= 2^30).
__device__ void accumulate_segments(const float* __restrict__ x,
                                    const float* __restrict__ w, int d, int S,
                                    const int* start, const int* idx,
                                    float* __restrict__ n_out,
                                    float* __restrict__ sx_out,
                                    float* __restrict__ sxx_out) {
  accumulate_moments(x, w, d, S, start, idx, 0, d, n_out, sx_out);
  const int dd = d * d;
  for (int e = threadIdx.x; e < S * dd; e += blockDim.x) {
    const int s = e / dd, r = e - s * dd;
    const int a = r / d, b = r - a * d;
    float acc = 0.f;
#pragma unroll 4
    for (int i = start[s]; i < start[s + 1]; ++i) {
      const int p = idx[i];
      const float* xp = x + (size_t)p * d;
      acc = fmaf(w[p] * xp[a], xp[b], acc);
    }
    sxx_out[e] = acc;
  }
}

}  // namespace repro_torch
