// Blocked fp32 matrix product C = A B on an NVIDIA Hopper card (sm_90a):
// the paper's "Kernel #1", which serves the diagonal-Gaussian likelihood
// (x^2 @ prec^T and x @ (prec mu)^T) below the d N size crossover, and the
// multinomial and Poisson served products at every size.
//
// Replaces the TPU kernel src/repro/kernels/matmul.py:matmul
// (_matmul_kernel). A (M, K) and B (K, N) are row-major and contiguous;
// C (M, N) is written whole.
//
// What bounds it. 2 M N K FLOP against 4 (M K + K N + M N) bytes: at the
// serving shapes (M = 8192, K = 32 or 128, N = 16 slots) bound by bytes
// (0.5 and 1.4 us at 3.35 TB/s) and, at that size, by launch latency and
// the caller's host time.
//
// Design, for the serving products: N is a slab's slots (16 to 64) and K a
// family's d or d' (32 to 128), while M runs to 8192 rows a step. A block
// of 128 threads owns BM rows and a BN-column tile of C, BN = 16, 32 or 64
// from N (kernels/matmul.py matmul_bn), each thread one row and 4 columns,
// so BM = 32, 16 or 8: 256 blocks at M = 8192 and N = 16, two waves of
// 132 SMs, and no thread on a padded column while N <= BN. K is walked in
// slabs of BK = 32 (K <= 32) or 64 through two shared buffers (so K = 128,
// the multinomial's d', is two slabs copied at once): A's rows by
// coalesced 16-byte cp.async (4-byte where K % 4 != 0 or A is unaligned)
// into row-major tiles padded to a conflict-free row stride (no transposed
// writes), B's slab by 4-byte cp.async, each B element staged once a
// block; slab s + 1 is in flight while slab s is multiplied. Every element is one fmaf chain
// over k = 0, 1, ..., K - 1 from 0, zero-padded past K (fmaf(0, 0, acc) ==
// acc: acc is never -0), so its bits depend on its row of A and column of
// B only: not on M, nor on where the row sits in the batch, nor on the
// tile shape. No TF32 and no tensor cores: the reference computes in fp32.
#include <cstdint>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int MM_THREADS = 128, MM_TN = 4;

__device__ __forceinline__ void mm_cp16(float* dst, const float* src,
                                        int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void mm_cp4(float* dst, const float* src,
                                       int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

template <int BN, int BK>
__global__ void __launch_bounds__(MM_THREADS) matmul_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ c, int M, int K, int N, int vec_a) {
  constexpr int TPR = BN / MM_TN;              // threads a row
  constexpr int BM = MM_THREADS / TPR;         // rows a block
  constexpr int AS = BK + 4;                   // A tile row stride
  __shared__ __align__(16) float as[2][BM][AS];
  __shared__ __align__(16) float bs[2][BK][BN];
  const int tid = threadIdx.x;
  const int tc = tid % TPR, tr = tid / TPR;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int nslab = (K + BK - 1) / BK;

  auto load = [&](int s, int buf) {
    const int k0 = s * BK;
    if (vec_a) {
      for (int e = tid; e < BM * (BK / 4); e += MM_THREADS) {
        const int r = e / (BK / 4), q = e % (BK / 4);
        const int gr = row0 + r, gk = k0 + 4 * q;
        const bool ok = gr < M && gk < K;     // K % 4 == 0: all 4 or none
        mm_cp16(&as[buf][r][4 * q], ok ? a + (size_t)gr * K + gk : a,
                ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < BM * BK; e += MM_THREADS) {
        const int r = e / BK, kk = e % BK;
        const int gr = row0 + r, gk = k0 + kk;
        const bool ok = gr < M && gk < K;
        mm_cp4(&as[buf][r][kk], ok ? a + (size_t)gr * K + gk : a,
               ok ? 4 : 0);
      }
    }
    for (int e = tid; e < BK * BN; e += MM_THREADS) {
      const int kk = e / BN, cc = e % BN;
      const int gk = k0 + kk, gc = col0 + cc;
      const bool ok = gk < K && gc < N;
      mm_cp4(&bs[buf][kk][cc], ok ? b + (size_t)gk * N + gc : b,
             ok ? 4 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[MM_TN];
#pragma unroll
  for (int j = 0; j < MM_TN; ++j) acc[j] = 0.f;
  load(0, 0);
  for (int s = 0; s < nslab; ++s) {
    if (s + 1 < nslab) {
      load(s + 1, (s + 1) & 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const int buf = s & 1;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      const float4 av = *reinterpret_cast<const float4*>(&as[buf][tr][kk]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 bv =
            *reinterpret_cast<const float4*>(&bs[buf][kk + q][MM_TN * tc]);
        acc[0] = fmaf(ar[q], bv.x, acc[0]);
        acc[1] = fmaf(ar[q], bv.y, acc[1]);
        acc[2] = fmaf(ar[q], bv.z, acc[2]);
        acc[3] = fmaf(ar[q], bv.w, acc[3]);
      }
    }
    __syncthreads();   // buffer s & 1 is refilled by slab s + 2
  }
  const int gr = row0 + tr;
  if (gr >= M) return;
#pragma unroll
  for (int j = 0; j < MM_TN; ++j) {
    const int gc = col0 + MM_TN * tc + j;
    if (gc < N) c[(size_t)gr * N + gc] = acc[j];
  }
}

}  // namespace repro_torch

// bn: the column tile, 16, 32 or 64, from the wrapper (kernels/matmul.py
// matmul_bn); ceil(N / bn) column tiles cover N.
extern "C" int matmul_launch(const float* a, const float* b, float* c, int M,
                             int K, int N, int bn, void* stream) {
  using namespace repro_torch;
  if (M <= 0 || K <= 0 || N <= 0 || (bn != 16 && bn != 32 && bn != 64) ||
      (N + bn - 1) / bn > 65535)
    return (int)cudaErrorInvalidValue;
  const int bm = MM_THREADS / (bn / MM_TN);
  const dim3 grid((M + bm - 1) / bm, (N + bn - 1) / bn);
  const int vec_a =
      K % 4 == 0 && reinterpret_cast<std::uintptr_t>(a) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 32) {   // one 32-deep slab: the diagonal product's d = 32
    if (bn == 16)
      matmul_kernel<16, 32><<<grid, MM_THREADS, 0, s>>>(a, b, c, M, K, N,
                                                         vec_a);
    else if (bn == 32)
      matmul_kernel<32, 32><<<grid, MM_THREADS, 0, s>>>(a, b, c, M, K, N,
                                                         vec_a);
    else
      matmul_kernel<64, 32><<<grid, MM_THREADS, 0, s>>>(a, b, c, M, K, N,
                                                         vec_a);
  } else {
    if (bn == 16)
      matmul_kernel<16, 64><<<grid, MM_THREADS, 0, s>>>(a, b, c, M, K, N,
                                                         vec_a);
    else if (bn == 32)
      matmul_kernel<32, 64><<<grid, MM_THREADS, 0, s>>>(a, b, c, M, K, N,
                                                         vec_a);
    else
      matmul_kernel<64, 64><<<grid, MM_THREADS, 0, s>>>(a, b, c, M, K, N,
                                                         vec_a);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
