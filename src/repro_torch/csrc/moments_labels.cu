// Label-indexed first moments on an NVIDIA Hopper card (sm_90a), per
// STATS_BLOCK of points: the statistics of the linear families.
//
// Replaces the TPU kernel src/repro/kernels/suffstats.py:moments_labels
// (_moments_labels_kernel). Given per-point features f (N, d') (x for the
// multinomial and Poisson families, the stacked [x, x^2] for the diagonal
// Gaussian), int labels and sublabels and the valid mask, it writes for
// every block b of STATS_BLOCK points the partials n (k, 2) and sf (k, 2, d')
// over segments 2 * label + sublabel. The caller folds the nsb blocks in one
// fixed-order reduction. Labels outside [0, k), sublabels outside {0, 1}
// and points with valid == 0 add nothing, as the one-hot of the reference
// gives them an all-zero row.
//
// Design. The TPU kernel built a (bn, bk) one-hot per tile and accumulated
// r^T f with the matrix unit, revisiting the output tile over the point
// axis in order. Here the grid is (STATS_BLOCK blocks, chunks of
// FEAT_CHUNK features): each thread block sorts its block's point ids by
// segment (warp 0, stable, block_stats.cuh), then every output entry of its
// feature chunk is one thread's sequential sum over the segment's points in
// point order. No float atomics, so every launch gives the same bits. The
// second grid axis keeps the card busy at a wide d' with few points (the
// 20newsgroups shape: N = 11,314, so 12 point blocks, d' = 20,000).
//
// What bounds it. It reads N (4 d' + 12) bytes (features, two labels,
// valid) and writes nsb * 2k * (1 + d') * 4 bytes of partials; it does N d'
// FMAs. At the multinomial fit's shapes (N = 1e6, d' = 128, 2k = 128) both
// byte streams are about 0.5 GB and 64 MB, so it is bound by device-memory
// bytes, not by arithmetic.
//
// Limits: 1 <= k <= 8192 (segment offsets live in shared memory),
// 1 <= d' <= 65536.
#include <cuda_runtime.h>

#include "block_stats.cuh"

namespace repro_torch {

constexpr int MOMENTS_THREADS = 256;
constexpr int FEAT_CHUNK = 128;

__global__ void __launch_bounds__(MOMENTS_THREADS) moments_labels_kernel(
    const float* __restrict__ f, int n, int dp, const int* __restrict__ labels,
    const int* __restrict__ sublabels, const float* __restrict__ valid, int K,
    float* __restrict__ n2, float* __restrict__ sf2) {
  extern __shared__ int smem_i[];
  const int S = 2 * K;
  int* seg = smem_i;                  // STATS_BLOCK
  int* idx = seg + STATS_BLOCK;       // STATS_BLOCK
  int* start = idx + STATS_BLOCK;     // S + 1
  int* cursor = start + S + 1;        // S

  const size_t base = (size_t)blockIdx.x * STATS_BLOCK;
  const long long rest = (long long)n - (long long)base;
  const int np = rest < STATS_BLOCK ? (int)rest : STATS_BLOCK;
  for (int p = threadIdx.x; p < np; p += MOMENTS_THREADS) {
    const int l = labels[base + p], s = sublabels[base + p];
    const bool in = valid[base + p] != 0.f && l >= 0 && l < K && s >= 0 &&
                    s <= 1;
    seg[p] = in ? 2 * l + s : -1;
  }
  __syncthreads();
  sort_by_segment(seg, np, S, start, cursor, idx);
  const int c0 = blockIdx.y * FEAT_CHUNK;
  const int dc = min(FEAT_CHUNK, dp - c0);
  const size_t blk = blockIdx.x;
  accumulate_moments(f + base * dp, valid + base, dp, S, start, idx, c0, dc,
                     blockIdx.y == 0 ? n2 + blk * S : nullptr,
                     sf2 + blk * S * (size_t)dp);
}

}  // namespace repro_torch

extern "C" int moments_labels_launch(const float* f, int n, int dp,
                                     const int* labels, const int* sublabels,
                                     const float* valid, int K, float* n2,
                                     float* sf2, void* stream) {
  using namespace repro_torch;
  if (n <= 0 || dp <= 0 || dp > 65536 || K <= 0 || K > 8192)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(int) * (2 * (size_t)STATS_BLOCK + 4 * (size_t)K + 1);
  cudaError_t err = cudaFuncSetAttribute(
      moments_labels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + STATS_BLOCK - 1) / STATS_BLOCK,
                  (dp + FEAT_CHUNK - 1) / FEAT_CHUNK);
  moments_labels_kernel<<<grid, MOMENTS_THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      f, n, dp, labels, sublabels, valid, K, n2, sf2);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
