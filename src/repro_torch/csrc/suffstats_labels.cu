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
// order. Here one thread block owns one STATS_BLOCK and runs the segment
// fold of block_stats.cuh (fold_segments): the whole block sorts the point
// ids by segment (stable), the empty segments get their zeros from 16-byte
// stores, and each non-empty segment's sxx is a gathered Gram product
// walked in point order by teams of threads holding 8 x 8 register tiles,
// n and sx in the same walk. No float atomics, so the result is the same
// bits on every launch, and the same bits as the first version (one thread
// an entry), whose chains it keeps.
//
// What bounds it. It reads N (4 d + 12) bytes (x, two labels, valid) and
// writes nsb * 2k * (1 + d + d^2) * 4 bytes of partials; it does N d^2
// FMAs. At the fits' shapes (N = 1e6, d = 32, 2k = 128; 4e5 x 256 over
// 2k = 64) the partial writes dominate, so it is bound by device-memory
// bytes, not by arithmetic; the design makes every byte of a partial one
// store (the zeros of empty segments included) and keeps the FMAs off the
// critical path (8 x 8 register tiles, 64 FMAs for four 16-byte loads a
// point).
//
// The tile edge E (gram_edge(d)), the shared bytes and the blocks that
// share a STATS_BLOCK (grid y: 1 to 4, each taking every splits-th
// (segment, tile) item, so that a grid of few STATS_BLOCKs fills the card)
// are the wrapper's (kernels/suffstats.py stats_plan); the launcher
// instantiates E in {8, 16, 32, 64, 128}, each with and without 16-byte
// rows, and refuses any other plan.
//
// Slot windows. One launch folds the labels of one window [k0, k0 + W)
// of the k slots (W <= 8192: its 2W + 1 offsets and the sort's cursors
// live in shared memory) into that window's rows of the (nsb, k, 2, ...)
// partials; labels outside the window add nothing to it, as labels
// outside [0, k) add nothing at all. The wrapper launches the windows of
// kernels/suffstats.py slot_windows in turn, so every output entry is
// written by exactly one launch, with the chain it has at any k.
//
// Limits: 1 <= W <= 8192 slots a launch, any k and d (a segment walks
// ceil(d / 128)^2 Gram tiles past d = 128; offsets are 64-bit).
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_stats.cuh"

namespace repro_torch {

constexpr int STATS_THREADS = 256;

// Shared words of the kernel: seg, idx, w (STATS_BLOCK each), start
// (S + 1) and the sort's scratch.
__host__ inline size_t stats_smem_bytes(int K) {
  const int S = 2 * K;
  return sizeof(int) * (3 * (size_t)STATS_BLOCK + (size_t)S + 1 +
                        sort_scratch_ints(S));
}

// K: the window's slots (labels k0 .. k0 + K - 1); S_out: segments a
// block of the partials (2k), whose window rows n2, sx2, sxx2 point at.
template <int E, bool VEC>
__global__ void __launch_bounds__(STATS_THREADS, 2) suffstats_labels_kernel(
    const float* __restrict__ x, int n, int d, const int* __restrict__ labels,
    const int* __restrict__ sublabels, const float* __restrict__ valid, int K,
    int k0, long long S_out, float* __restrict__ n2,
    float* __restrict__ sx2, float* __restrict__ sxx2) {
  extern __shared__ int smem_i[];
  const int S = 2 * K;
  int* seg = smem_i;                                      // STATS_BLOCK
  int* idx = seg + STATS_BLOCK;                           // STATS_BLOCK
  float* w = reinterpret_cast<float*>(idx + STATS_BLOCK); // STATS_BLOCK
  int* start = reinterpret_cast<int*>(w + STATS_BLOCK);   // S + 1
  int* scratch = start + S + 1;

  const size_t base = (size_t)blockIdx.x * STATS_BLOCK;
  const long long rest = (long long)n - (long long)base;
  const int np = rest < STATS_BLOCK ? (int)rest : STATS_BLOCK;
  for (int p = threadIdx.x; p < np; p += STATS_THREADS) {
    const int l = labels[base + p] - k0, s = sublabels[base + p];
    const float v = valid[base + p];
    const bool in = v != 0.f && l >= 0 && l < K && s >= 0 && s <= 1;
    seg[p] = in ? 2 * l + s : -1;
    w[p] = v;
  }
  __syncthreads();
  const size_t row = (size_t)blockIdx.x * S_out;
  fold_segments<E, VEC>(x + base * d, w, d, np, S, seg, idx, start, scratch,
                        n2 + row, sx2 + row * d, sxx2 + row * d * d,
                        blockIdx.y, gridDim.y);
}

template <int E>
int launch_edge(bool vec, const float* x, int n, int d, const int* labels,
                const int* sublabels, const float* valid, int K, int k0,
                long long S_out, int splits, float* n2, float* sx2,
                float* sxx2, size_t smem, cudaStream_t stream) {
  auto kernel = vec ? suffstats_labels_kernel<E, true>
                    : suffstats_labels_kernel<E, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nsb = (n + STATS_BLOCK - 1) / STATS_BLOCK;
  kernel<<<dim3(nsb, splits), STATS_THREADS, smem, stream>>>(
      x, n, d, labels, sublabels, valid, K, k0, S_out, n2, sx2, sxx2);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// One slot window [k0, k0 + W) of k slots: n2, sx2, sxx2 are the whole
// (nsb, k, 2, ...) partials, of which it writes the window's rows. edge,
// smem, splits: the wrapper's stats_plan for the window (the tile edge
// gram_edge(d), the kernel's shared bytes for W slots, and the blocks
// that share a STATS_BLOCK, 1 to 4); any other plan is refused.
extern "C" int suffstats_labels_launch(const float* x, int n, int d,
                                       const int* labels,
                                       const int* sublabels,
                                       const float* valid, int k, int k0,
                                       int W, int edge, int smem, int splits,
                                       float* n2, float* sx2, float* sxx2,
                                       void* stream) {
  using namespace repro_torch;
  if (n <= 0 || d <= 0 || k <= 0 || W <= 0 || W > 8192 || k0 < 0 ||
      k0 > k - W || edge != gram_edge(d) ||
      (size_t)smem != stats_smem_bytes(W) || splits < 1 || splits > 4)
    return (int)cudaErrorInvalidValue;
  const long long S_out = 2LL * k;
  const size_t off = 2 * (size_t)k0;
  n2 += off;
  sx2 += off * d;
  sxx2 += off * d * d;
  const bool vec = (d & 3) == 0 && ((uintptr_t)x & 15) == 0 &&
                   ((uintptr_t)sxx2 & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_STATS_EDGE(E)                                                \
  if (edge == E)                                                           \
  return launch_edge<E>(vec, x, n, d, labels, sublabels, valid, W, k0,   \
                        S_out, splits, n2, sx2, sxx2, (size_t)smem, s)
  REPRO_STATS_EDGE(8);
  REPRO_STATS_EDGE(16);
  REPRO_STATS_EDGE(32);
  REPRO_STATS_EDGE(64);
  REPRO_STATS_EDGE(128);
#undef REPRO_STATS_EDGE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
