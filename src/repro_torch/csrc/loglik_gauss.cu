// Dense Gaussian log-likelihoods of a batch of points under every cluster,
// on an NVIDIA Hopper card (sm_90a): the (N, K) matrix DPMMEngine.query
// turns into hard labels, log p(k | x) and log p(x).
//
// Replaces the TPU kernel src/repro/kernels/loglik.py:loglik
// (_loglik_kernel, the paper's dcolwise_dot_all hot spot). Per point i and
// cluster k:
//   out_ik = 0.5 (logdet_k - |F_k^T (x_i - mu_k)|^2) - 0.5 d log(2 pi)
// with F_k the factor of the precision (Sigma_k^-1 = F_k F_k^T).
//
// Design. The TPU kernel tiled (points, clusters) on a 2-D grid with the
// whitening product on the matrix unit. Here the grid is 2-D again, and
// the route the wrapper's choice (kernels/assign.py gauss_plan and
// panel_plan, functions of the shape only):
//  - d <= 16: a thread block owns PB points and loops over tiles of
//    clusters staged in shared memory, one thread a point with its
//    d-vectors in registers (assign_tile.cuh maha_narrow);
//  - 16 < d <= 128: the register tile of the sweep's step (e) (te_tile.cuh,
//    the device code of assign_gauss.cu and sweep_gauss.cu at these
//    widths) with every slot live and no weights or noise, on 128-point
//    tiles x slot groups, each group a share of the column tiles;
//  - d > 128: the panel layout of assign_tile.cuh (gauss_panel), (X - mu_k)
//    F_k as an output-stationary 8 x 8 register tile fed by a cp.async ring
//    of row slabs, any d.
// Every output element is written once, and a point's row does not depend
// on the batch it came in or the grid, so a ragged request gets the bits
// of the same rows in a larger one.
//
// What bounds it. 2 N K d (d + 1) FLOP of fp32 FMA against N d 4 +
// K d^2 4 bytes read and N K 4 bytes written: at a serving step (N = 8192,
// K = 32, d = 32) 0.55 GFLOP against 2.2 MB, so the CUDA cores' fp32 rate
// bounds it (about 8 us at 67 TFLOP/s; at that size a launch is mostly
// latency); at the d = 256 fit's state (N = 4e5, all K = 32 slots) 1.7
// TFLOP, 25.1 ms. No tensor cores and no TF32: at d = 256 a |y|^2 in the
// hundreds keeps about three digits in TF32.
//
// Limits: 1 <= d, 1 <= K, N < 2^31 (ints); factors past d = 128 are read
// with 64-bit offsets.
#include <cuda_runtime.h>
#include <stdint.h>

#include "assign_tile.cuh"
#include "te_tile.cuh"

namespace repro_torch {

constexpr int PB = 128;               // points a block of the narrow layout
constexpr int NARROW_THREADS = 128;   // one point per thread

template <int DP>
__global__ void __launch_bounds__(NARROW_THREADS) loglik_gauss_kernel(
    const float* __restrict__ x, int n, int d, const float* __restrict__ mu,
    const float* __restrict__ chol, const float* __restrict__ logdet, int K,
    int bk_max, float half_d_log2pi, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const GaussTile<DP> t(reinterpret_cast<float*>(smem), bk_max);
  const size_t base = (size_t)blockIdx.x * PB;
  const int np = min((long long)PB, (long long)n - (long long)base);
  const float* xb = x + base * d;
  for (int kt = 0; kt < K; kt += bk_max) {
    const int bk = min(bk_max, K - kt);
    stage_gauss_tile<DP>(t, kt, bk, d, mu, chol, logdet, nullptr, nullptr,
                         nullptr);
    for (int p = threadIdx.x; p < np; p += blockDim.x) {
      float xr[DP];
      load_row<DP>(xb + (size_t)p * d, d, xr);
      float* row = out + (base + p) * (size_t)K + kt;
      for (int kk = 0; kk < bk; ++kk) {
        const float maha = maha_narrow<DP>(xr, t.f + kk * DP * DP,
                                           t.mu + kk * DP);
        row[kk] = 0.5f * (t.ld[kk] - maha) - half_d_log2pi;
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(TE_THREADS, 2) loglik_gauss_tiled_kernel(
    const float* __restrict__ x, int n, int d, const float* __restrict__ mu,
    const float* __restrict__ chol, const float* __restrict__ logdet, int K,
    float half_d_log2pi, int vec, float* __restrict__ out) {
  extern __shared__ __align__(16) float te_smem[];
  te_tile<DP, false>(x, n, d, mu, chol, logdet, nullptr, nullptr, nullptr, K,
                     nullptr, 0u, 0u, half_d_log2pi, vec != 0, te_smem, out,
                     nullptr, nullptr);
}

template <int BM>
__global__ void __launch_bounds__(PanelTile<BM>::THREADS, 2)
    loglik_gauss_panel_kernel(const float* __restrict__ x, int n, int d,
                              const float* __restrict__ mu,
                              const float* __restrict__ chol,
                              const float* __restrict__ logdet, int K,
                              int per, float half_d_log2pi, int vec,
                              float* __restrict__ out) {
  extern __shared__ __align__(16) float panel_smem[];
  gauss_panel<BM, false>(x, n, d, mu, chol, logdet, nullptr, nullptr,
                         nullptr, K, per, nullptr, 0u, 0u, half_d_log2pi,
                         vec != 0, panel_smem, out, nullptr, nullptr);
}

template <int DP>
int launch_narrow(const float* x, int n, int d, const float* mu,
                  const float* chol, const float* logdet, int K, float* out,
                  cudaStream_t stream) {
  const int bk_max = gauss_tile_slots(DP, K);
  const size_t smem = sizeof(float) * gauss_tile_floats(DP, bk_max);
  cudaError_t err = cudaFuncSetAttribute(
      loglik_gauss_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + PB - 1) / PB;
  const float half_d_log2pi = (float)(0.5 * d * 1.8378770664093453);
  loglik_gauss_kernel<DP><<<blocks, NARROW_THREADS, smem, stream>>>(
      x, n, d, mu, chol, logdet, K, bk_max, half_d_log2pi, out);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_tiled(const float* x, int n, int d, const float* mu,
                 const float* chol, const float* logdet, int K, int groups,
                 int smem, float* out, cudaStream_t stream) {
  if ((size_t)smem != te_smem_bytes<DP>(K)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      loglik_gauss_tiled_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = ((long long)n + TE_BM - 1) / TE_BM;
  const float half_d_log2pi = (float)(0.5 * d * 1.8378770664093453);
  const int vec = (d & 3) == 0 && ((uintptr_t)chol & 15) == 0;
  loglik_gauss_tiled_kernel<DP><<<dim3((unsigned)tiles, groups), TE_THREADS,
                                  smem, stream>>>(
      x, n, d, mu, chol, logdet, K, half_d_log2pi, vec, out);
  return (int)cudaGetLastError();
}

template <int BM>
int launch_panel(const float* x, int n, int d, const float* mu,
                 const float* chol, const float* logdet, int K, int per,
                 int groups, int smem, float* out, cudaStream_t stream) {
  using T = PanelTile<BM>;
  if (smem != T::SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      loglik_gauss_panel_kernel<BM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = ((long long)n + BM - 1) / BM;
  const float half_d_log2pi = (float)(0.5 * d * 1.8378770664093453);
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(chol) % 16 == 0;
  loglik_gauss_panel_kernel<BM><<<dim3((unsigned)tiles, groups), T::THREADS,
                                  smem, stream>>>(
      x, n, d, mu, chol, logdet, K, per, half_d_log2pi, vec ? 1 : 0, out);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// d <= 128: the launch is the wrapper's choice (kernels/assign.py
// gauss_plan, a function of the shape only): dp 0, the narrow layout
// (d <= 16, one group, smem 0), or the tile's padded width 32, 64 or 128
// (d <= 32, 32 < d <= 64, 64 < d <= 128) on `groups` slot groups with smem
// shared bytes, which must be that layout's.
extern "C" int loglik_gauss_launch(const float* x, int n, int d,
                                   const float* mu, const float* chol,
                                   const float* logdet, int K, int dp,
                                   int groups, int smem, float* out,
                                   void* stream) {
  using namespace repro_torch;
  const bool width_ok = dp == 0    ? d <= 16
                        : dp == 32 ? d <= 32
                        : dp == 64 ? d > 32 && d <= 64
                        : dp == 128 ? d > 64 && d <= 128
                                    : false;
  if (n <= 0 || K <= 0 || d <= 0 || !width_ok || groups <= 0 ||
      groups > 65535 || (dp == 0 && (groups != 1 || smem != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dp == 0) {
    const auto narrow = d <= 4   ? &launch_narrow<4>
                        : d <= 8 ? &launch_narrow<8>
                                 : &launch_narrow<16>;
    return narrow(x, n, d, mu, chol, logdet, K, out, s);
  }
  const auto tiled = dp == 32   ? &launch_tiled<32>
                     : dp == 64 ? &launch_tiled<64>
                                : &launch_tiled<128>;
  return tiled(x, n, d, mu, chol, logdet, K, groups, smem, out, s);
}

// d > 128: the launch is the wrapper's choice (kernels/assign.py
// panel_plan, a function of the shape only): bm points a block (32 or
// 128), per slots a group, groups = ceil(K / per) groups, and smem, which
// must be that tile's layout.
extern "C" int loglik_gauss_panel_launch(const float* x, int n, int d,
                                         const float* mu, const float* chol,
                                         const float* logdet, int K, int bm,
                                         int per, int groups, int smem,
                                         float* out, void* stream) {
  using namespace repro_torch;
  if (n <= 0 || K <= 0 || d <= WIDE_D || per <= 0 || groups <= 0 ||
      groups > 65535 || (long long)groups * per < K ||
      (long long)(groups - 1) * per >= K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 128)
    return launch_panel<128>(x, n, d, mu, chol, logdet, K, per, groups,
                             smem, out, s);
  if (bm == 32)
    return launch_panel<32>(x, n, d, mu, chol, logdet, K, per, groups, smem,
                            out, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
