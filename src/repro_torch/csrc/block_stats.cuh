// Per-STATS_BLOCK sub-cluster statistics of one block of points, shared by
// the sweep_gauss and suffstats_labels kernels.
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

// x, w: this block's points ((np, d) and (np,)); outputs: this block's
// (S,), (S, d), (S, d, d) partial slices. The entry index runs to S d^2 in
// an int: callers hold S <= 16384 and d <= 64 (S d^2 <= 2^26).
__device__ void accumulate_segments(const float* __restrict__ x,
                                    const float* __restrict__ w, int d, int S,
                                    const int* start, const int* idx,
                                    float* __restrict__ n_out,
                                    float* __restrict__ sx_out,
                                    float* __restrict__ sxx_out) {
  for (int e = threadIdx.x; e < S; e += blockDim.x) {
    float acc = 0.f;
    for (int i = start[e]; i < start[e + 1]; ++i) acc += w[idx[i]];
    n_out[e] = acc;
  }
  for (int e = threadIdx.x; e < S * d; e += blockDim.x) {
    const int s = e / d, a = e - s * d;
    float acc = 0.f;
    for (int i = start[s]; i < start[s + 1]; ++i) {
      const int p = idx[i];
      acc = fmaf(w[p], x[(size_t)p * d + a], acc);
    }
    sx_out[e] = acc;
  }
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
