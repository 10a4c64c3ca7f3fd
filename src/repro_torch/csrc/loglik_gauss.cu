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
// whitening product on the matrix unit; here a thread block owns PB points
// and loops over tiles of clusters staged in shared memory, with the
// whitening device code of the sweep's step (e) (assign_tile.cuh):
// maha_narrow, one thread per point with its d-vectors in registers, for
// d <= 64, maha_wide, four lanes per point, for d <= 128, and maha_panel,
// the factor staged in 64-column panels for 64 points, for d <= 256. Every
// slot is computed (the caller masks inactive ones), and a point's row does
// not depend on the batch it came in, so a ragged request gets the bits of
// the same rows in a larger one.
//
// What bounds it. 2 N K d^2 FLOP of fp32 FMA against N d 4 + K d^2 4 bytes
// read and N K 4 bytes written: at a serving step (N = 8192, K = 16,
// d = 32) 0.27 GFLOP against 1.6 MB, so the CUDA cores' fp32 rate bounds
// it (about 4 us at 67 TFLOP/s); at that size a launch is mostly latency.
//
// Limits: 1 <= d <= 256, 1 <= K.
#include <cuda_runtime.h>
#include <stdint.h>

#include "assign_tile.cuh"

namespace repro_torch {

constexpr int PB = 128;               // points per thread block
constexpr int NARROW_THREADS = 128;   // one point per thread
constexpr int WIDE_THREADS = 256;     // 64 lane groups, two passes

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

__global__ void __launch_bounds__(WIDE_THREADS) loglik_gauss_wide_kernel(
    const float* __restrict__ x, int n, int d, const float* __restrict__ mu,
    const float* __restrict__ chol, const float* __restrict__ logdet, int K,
    int bk_max, float half_d_log2pi, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);
  const GaussTile<WIDE_D> t(tile, bk_max);
  float* xsm = tile + gauss_tile_floats(WIDE_D, bk_max);
  const int groups = blockDim.x / WIDE_LANES;
  const int grp = threadIdx.x / WIDE_LANES, j = threadIdx.x % WIDE_LANES;
  float* xs = xsm + grp * WIDE_XSTRIDE;
  const size_t base = (size_t)blockIdx.x * PB;
  const int np = min((long long)PB, (long long)n - (long long)base);
  const float* xb = x + base * d;
  for (int kt = 0; kt < K; kt += bk_max) {
    const int bk = min(bk_max, K - kt);
    stage_gauss_tile<WIDE_D>(t, kt, bk, d, mu, chol, logdet, nullptr,
                             nullptr, nullptr);
    for (int p0 = 0; p0 < np; p0 += groups) {
      const int p = p0 + grp;
      const bool live = p < np;
      stage_x_wide(xb, p, live, d, j, xs);
      __syncwarp();
      for (int kk = 0; kk < bk; ++kk) {
        const float maha = maha_wide(xs, t.f + (size_t)kk * WIDE_D * WIDE_D,
                                     t.mu + kk * WIDE_D, d, j);
        if (live && j == 0)
          out[(base + p) * (size_t)K + kt + kk] =
              0.5f * (t.ld[kk] - maha) - half_d_log2pi;
      }
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(PANEL_THREADS) loglik_gauss_panel_kernel(
    const float* __restrict__ x, int n, int d, const float* __restrict__ mu,
    const float* __restrict__ chol, const float* __restrict__ logdet, int K,
    float half_d_log2pi, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const PanelSmem sm(reinterpret_cast<float*>(smem));
  const size_t base = (size_t)blockIdx.x * PANEL_PB;
  const int np = min((long long)PANEL_PB, (long long)n - (long long)base);
  stage_x_panel(x + base * d, np, d, sm.xs);
  const int grp = threadIdx.x / PANEL_LANES, j = threadIdx.x % PANEL_LANES;
  const float* xs = sm.xs + grp * PANEL_XSTRIDE;
  for (int k = 0; k < K; ++k) {
    const float maha = maha_panel(sm, xs, chol + (size_t)k * d * d,
                                  mu + (size_t)k * d, d, j);
    if (grp < np && j == 0)
      out[(base + grp) * (size_t)K + k] =
          0.5f * (__ldg(logdet + k) - maha) - half_d_log2pi;
  }
}

template <class Kernel>
int launch(Kernel kernel, int dp, int threads, size_t extra_words,
           const float* x, int n, int d, const float* mu, const float* chol,
           const float* logdet, int K, float* out, cudaStream_t stream) {
  const int bk_max = gauss_tile_slots(dp, K);
  const size_t smem =
      sizeof(float) * (gauss_tile_floats(dp, bk_max) + extra_words);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + PB - 1) / PB;
  const float half_d_log2pi = (float)(0.5 * d * 1.8378770664093453);
  kernel<<<blocks, threads, smem, stream>>>(x, n, d, mu, chol, logdet, K,
                                            bk_max, half_d_log2pi, out);
  return (int)cudaGetLastError();
}

int launch_panel(const float* x, int n, int d, const float* mu,
                 const float* chol, const float* logdet, int K, float* out,
                 cudaStream_t stream) {
  const size_t smem = sizeof(float) * panel_smem_floats();
  cudaError_t err = cudaFuncSetAttribute(
      loglik_gauss_panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + PANEL_PB - 1) / PANEL_PB;
  const float half_d_log2pi = (float)(0.5 * d * 1.8378770664093453);
  loglik_gauss_panel_kernel<<<blocks, PANEL_THREADS, smem, stream>>>(
      x, n, d, mu, chol, logdet, K, half_d_log2pi, out);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

extern "C" int loglik_gauss_launch(const float* x, int n, int d,
                                   const float* mu, const float* chol,
                                   const float* logdet, int K, float* out,
                                   void* stream) {
  using namespace repro_torch;
  if (n <= 0 || K <= 0 || d <= 0 || d > PANEL_D)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > WIDE_D) return launch_panel(x, n, d, mu, chol, logdet, K, out, s);
#define REPRO_LOGLIK_CASE(KERNEL, DP, THREADS, EXTRA)                   \
  return launch(KERNEL, DP, THREADS, EXTRA, x, n, d, mu, chol, logdet, K, \
                out, s)
  if (d <= 4) REPRO_LOGLIK_CASE(loglik_gauss_kernel<4>, 4, NARROW_THREADS, 0);
  if (d <= 8) REPRO_LOGLIK_CASE(loglik_gauss_kernel<8>, 8, NARROW_THREADS, 0);
  if (d <= 16)
    REPRO_LOGLIK_CASE(loglik_gauss_kernel<16>, 16, NARROW_THREADS, 0);
  if (d <= 32)
    REPRO_LOGLIK_CASE(loglik_gauss_kernel<32>, 32, NARROW_THREADS, 0);
  if (d <= 64)
    REPRO_LOGLIK_CASE(loglik_gauss_kernel<64>, 64, NARROW_THREADS, 0);
  REPRO_LOGLIK_CASE(loglik_gauss_wide_kernel, WIDE_D, WIDE_THREADS,
                    wide_x_floats(WIDE_THREADS));
#undef REPRO_LOGLIK_CASE
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
