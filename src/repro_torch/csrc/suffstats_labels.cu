// Label-indexed sub-cluster sufficient statistics on an NVIDIA Hopper card
// (sm_90a), per STATS_BLOCK of points.
//
// Replaces the TPU kernel src/repro/kernels/suffstats.py:suffstats_labels
// (_suffstats_labels_kernel). Given x (N, d), int labels and sublabels and
// the valid mask, it writes for every block b of STATS_BLOCK points the
// partials n (k, 2), sx (k, 2, d) and sxx (k, 2, d, d) over segments
// 2 * label + sublabel (block_stats.cuh). The caller folds the nsb blocks
// in one fixed-order reduction. Labels outside [0, k), sublabels outside
// {0, 1} and points with valid == 0 add nothing, as the one-hot of the
// reference gives them an all-zero row.
//
// Design. The TPU kernel built a (bn, bk) one-hot per tile and accumulated
// with the matrix unit, revisiting the output tile over the point axis in
// order. Here one thread block owns one STATS_BLOCK: warp 0 sorts the point
// ids by segment (stable), then each output entry is one thread's sum over
// its segment's points. No float atomics, so the result is the same bits on
// every launch.
//
// What bounds it. It reads N (4 d + 12) bytes (x, two labels, valid) and
// writes nsb * 2k * (1 + d + d^2) * 4 bytes of partials; it does N d^2
// FMAs. At the fit's shapes (N = 1e6, d = 32, 2k = 128) the partial writes
// dominate, so it is bound by device-memory bytes, not by arithmetic.
//
// Limits: 1 <= k <= 8192, 1 <= d <= 64 (so 2k d^2 fits the int entry
// index of block_stats.cuh).
#include <cuda_runtime.h>

#include "block_stats.cuh"

namespace repro_torch {

constexpr int STATS_THREADS = 256;

__global__ void __launch_bounds__(STATS_THREADS) suffstats_labels_kernel(
    const float* __restrict__ x, int n, int d, const int* __restrict__ labels,
    const int* __restrict__ sublabels, const float* __restrict__ valid, int K,
    float* __restrict__ n2, float* __restrict__ sx2,
    float* __restrict__ sxx2) {
  extern __shared__ int smem_i[];
  const int S = 2 * K;
  int* seg = smem_i;                  // STATS_BLOCK
  int* idx = seg + STATS_BLOCK;       // STATS_BLOCK
  int* start = idx + STATS_BLOCK;     // S + 1
  int* cursor = start + S + 1;        // S

  const size_t base = (size_t)blockIdx.x * STATS_BLOCK;
  const long long rest = (long long)n - (long long)base;
  const int np = rest < STATS_BLOCK ? (int)rest : STATS_BLOCK;
  for (int p = threadIdx.x; p < np; p += STATS_THREADS) {
    const int l = labels[base + p], s = sublabels[base + p];
    const bool in = valid[base + p] != 0.f && l >= 0 && l < K && s >= 0 &&
                    s <= 1;
    seg[p] = in ? 2 * l + s : -1;
  }
  __syncthreads();
  sort_by_segment(seg, np, S, start, cursor, idx);
  const size_t blk = blockIdx.x;
  accumulate_segments(x + base * d, valid + base, d, S, start, idx,
                      n2 + blk * S, sx2 + blk * S * d,
                      sxx2 + blk * S * d * d);
}

}  // namespace repro_torch

extern "C" int suffstats_labels_launch(const float* x, int n, int d,
                                       const int* labels,
                                       const int* sublabels,
                                       const float* valid, int K, float* n2,
                                       float* sx2, float* sxx2,
                                       void* stream) {
  using namespace repro_torch;
  if (n <= 0 || d <= 0 || d > 64 || K <= 0 || K > 8192)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * (2 * (size_t)STATS_BLOCK + 4 * (size_t)K + 1);
  cudaError_t err = cudaFuncSetAttribute(
      suffstats_labels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nsb = (n + STATS_BLOCK - 1) / STATS_BLOCK;
  suffstats_labels_kernel<<<nsb, STATS_THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      x, n, d, labels, sublabels, valid, K, n2, sx2, sxx2);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
