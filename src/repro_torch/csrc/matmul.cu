// Blocked fp32 matrix product C = A B on an NVIDIA Hopper card (sm_90a):
// the paper's "Kernel #1", which serves the diagonal-Gaussian likelihood
// (x^2 @ prec^T and x @ (prec mu)^T) below the d N size crossover.
//
// Replaces the TPU kernel src/repro/kernels/matmul.py:matmul
// (_matmul_kernel). A (M, K) and B (K, N) are row-major and contiguous;
// C (M, N) is written whole.
//
// Design. The TPU kernel revisited a (bm, bn) accumulator over the K grid
// axis in order; here each thread block owns a BM x BN tile of C and
// walks K itself in BK-deep slabs of A and B staged in shared memory (A
// transposed, so a thread's TM rows are one broadcast read), each of its
// 256 threads keeping a TM x TN block of sums in registers. Every sum runs
// over k = 0, 1, ... in order with fmaf, zero-padded past the edges (0 * 0
// adds nothing), so an element's bits depend on its row of A and column of
// B only: not on M, nor on where the row sits in the batch. No TF32 and no
// tensor cores: the reference computes in fp32.
//
// What bounds it. 2 M N K FLOP against 4 (M K + K N + M N) bytes: at the
// serving shapes (M = 8192, K = 32, N = 16) 8.4 MFLOP against 1.6 MB, so
// it is bound by bytes (about 0.5 us at 3.35 TB/s) and, at that size, by
// launch latency.
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int MM_THREADS = (BM / TM) * (BN / TN);   // 256

__global__ void __launch_bounds__(MM_THREADS) matmul_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ c, int M, int K, int N) {
  __shared__ __align__(16) float as[BK][BM + 4];
  __shared__ __align__(16) float bs[BK][BN + 4];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += MM_THREADS) {
      const int r = e / BK, kk = e % BK;
      const int gr = row0 + r, gk = k0 + kk;
      as[kk][r] = (gr < M && gk < K) ? a[(size_t)gr * K + gk] : 0.f;
    }
    for (int e = tid; e < BK * BN; e += MM_THREADS) {
      const int kk = e / BN, cc = e % BN;
      const int gk = k0 + kk, gc = col0 + cc;
      bs[kk][cc] = (gk < K && gc < N) ? b[(size_t)gk * N + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * TM]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[kk][tx * TN]);
      const float ar[TM] = {av.x, av.y, av.z, av.w};
      const float br[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty * TM + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx * TN + j;
      if (gc < N) c[(size_t)gr * N + gc] = acc[i][j];
    }
  }
}

}  // namespace repro_torch

extern "C" int matmul_launch(const float* a, const float* b, float* c, int M,
                             int K, int N, void* stream) {
  using namespace repro_torch;
  if (M <= 0 || K <= 0 || N <= 0 || (N + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  matmul_kernel<<<grid, MM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, c, M, K, N);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
