// Left-to-right fold of per-STATS_BLOCK statistic partials into a running
// accumulator on an NVIDIA Hopper card (sm_90a):
//
//   out[j] = (((acc[j] + p[0][j]) + p[1][j]) + ...) + p[nb - 1][j]
//
// The reference folds the partials of its one-read megakernels and of its
// blocked label-stat pass this way (src/repro/core/family.py:224-226, a
// lax.scan of adds from the accumulator, and :110-126), in global point
// order. That order is what makes a tiled chain bitwise the resident
// chain: a tile's partials continue the same sum from the accumulator the
// previous tile left, so the float additions are the same at every tile
// size. A reduction over the block axis (a tree, or sum-then-add) is not.
// It is not a Pallas kernel of the reference; on the card it takes the
// place of nb separate adds (about 1,000 launches a fold at N = 10^6).
//
// Design. One thread per output element walks the blocks in order with
// __fadd_rn (no reassociation, no contraction), loading 16 blocks ahead so
// the loads overlap while the adds stay sequential; consecutive threads
// read consecutive elements of one block. No atomics: two launches give
// the same bits, and the bits are those of the plain loop of adds.
//
// What bounds it. It reads nb m + m floats and writes m: bound by device
// memory bytes at large m (the (nb, k, 2, d, d) partials). At small m (the
// counts, m = 2k) a thread's nb dependent adds bound it by latency.
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int FOLD_THREADS = 256;
constexpr int FOLD_AHEAD = 16;

__global__ void __launch_bounds__(FOLD_THREADS) fold_partials_kernel(
    const float* __restrict__ acc, const float* __restrict__ parts,
    long long m, int nb, float* __restrict__ out) {
  const long long j = (long long)blockIdx.x * FOLD_THREADS + threadIdx.x;
  if (j >= m) return;
  const float* p = parts + j;
  float s = acc[j];
  int b = 0;
  for (; b + FOLD_AHEAD <= nb; b += FOLD_AHEAD) {
    float v[FOLD_AHEAD];
#pragma unroll
    for (int u = 0; u < FOLD_AHEAD; ++u) v[u] = p[(size_t)(b + u) * m];
#pragma unroll
    for (int u = 0; u < FOLD_AHEAD; ++u) s = __fadd_rn(s, v[u]);
  }
  for (; b < nb; ++b) s = __fadd_rn(s, p[(size_t)b * m]);
  out[j] = s;
}

}  // namespace repro_torch

extern "C" int fold_partials_launch(const float* acc, const float* parts,
                                    long long m, int nb, float* out,
                                    void* stream) {
  using namespace repro_torch;
  if (m <= 0 || nb < 0) return (int)cudaErrorInvalidValue;
  const long long grid = (m + FOLD_THREADS - 1) / FOLD_THREADS;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fold_partials_kernel<<<(unsigned)grid, FOLD_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(acc, parts, m,
                                                              nb, out);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
