// Step (e) alone for the full-covariance Gaussian family, on an NVIDIA
// Hopper card (sm_90a): labels of a batch of points under a model, the
// posterior draw DPMMEngine.sample serves.
//
// Replaces the TPU kernel src/repro/kernels/assign.py:assign_gauss
// (_assign_gauss_kernel). Per point i with Gumbel counter gidx[i]:
//   z_i = first argmax_k [ 0.5 (logdet_k - |F_k^T (x_i - mu_k)|^2)
//                          - 0.5 d log(2 pi) + logw_k  (-1e30 if slot k is
//                          inactive) + Gumbel(key_z, gidx_i, slots_k) ]
//
// Design. The TPU kernel's grid (point blocks, K tiles) ran the K axis in
// order and carried the running (max, argmax) in VMEM scratch; here a
// thread block owns PB points and loops over the K tiles itself, with the
// device code of the sweep's step (e) (assign_tile.cuh, gauss_assign_narrow
// for d <= 64 and gauss_assign_wide for d <= 128): the same tile staging,
// inactive-slot skip, Threefry counters and strict-`>` first max, so a
// label equals the one the sweep would draw for the same inputs. For
// 128 < d <= 256, where a factor (up to 256 KiB) exceeds a block's shared
// memory and there is no one-read sweep, gauss_assign_panel stages each
// active slot's factor in 64-column panels for a block of 64 points. The
// (N, K) logits never exist in device memory.
//
// What bounds it. 2 N K_live d^2 FLOP of fp32 FMA against N d 4 bytes of
// points and K d^2 4 bytes of factors: at a serving step (N = 8192, 16
// live slots, d = 32) 0.27 GFLOP, about 4 us at 67 TFLOP/s, so it is bound
// by the CUDA cores' fp32 rate; at that size a launch is mostly latency.
// At the d = 256 fit (N = 1e5, 17 live slots) it is 0.23 TFLOP, 3.4 ms at
// 67 TFLOP/s.
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
__global__ void __launch_bounds__(NARROW_THREADS) assign_gauss_kernel(
    const float* __restrict__ x, int n, int d, const float* __restrict__ mu,
    const float* __restrict__ chol, const float* __restrict__ logdet,
    const float* __restrict__ logw, const int* __restrict__ active,
    const int* __restrict__ slots, int K, int bk_max,
    const long long* __restrict__ gidx, const long long* __restrict__ key_z,
    float half_d_log2pi, int* __restrict__ labels) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);
  float* best = tile + gauss_tile_floats(DP, bk_max);
  int* lab = reinterpret_cast<int*>(best + PB);
  const size_t base = (size_t)blockIdx.x * PB;
  const int np = min((long long)PB, (long long)n - (long long)base);
  gauss_assign_narrow<DP>(x + base * d, np, d, gidx + base, mu, chol, logdet,
                          logw, active, slots, K, bk_max,
                          (uint32_t)key_z[0], (uint32_t)key_z[1],
                          half_d_log2pi, tile, best, lab);
  for (int p = threadIdx.x; p < np; p += blockDim.x) labels[base + p] = lab[p];
}

__global__ void __launch_bounds__(WIDE_THREADS) assign_gauss_wide_kernel(
    const float* __restrict__ x, int n, int d, const float* __restrict__ mu,
    const float* __restrict__ chol, const float* __restrict__ logdet,
    const float* __restrict__ logw, const int* __restrict__ active,
    const int* __restrict__ slots, int K, int bk_max,
    const long long* __restrict__ gidx, const long long* __restrict__ key_z,
    float half_d_log2pi, int* __restrict__ labels) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);
  float* xsm = tile + gauss_tile_floats(WIDE_D, bk_max);
  float* best = xsm + wide_x_floats(WIDE_THREADS);
  int* lab = reinterpret_cast<int*>(best + PB);
  const size_t base = (size_t)blockIdx.x * PB;
  const int np = min((long long)PB, (long long)n - (long long)base);
  gauss_assign_wide(x + base * d, np, d, gidx + base, mu, chol, logdet, logw,
                    active, slots, K, bk_max, (uint32_t)key_z[0],
                    (uint32_t)key_z[1], half_d_log2pi, tile, xsm, best, lab);
  for (int p = threadIdx.x; p < np; p += blockDim.x) labels[base + p] = lab[p];
}

__global__ void __launch_bounds__(PANEL_THREADS) assign_gauss_panel_kernel(
    const float* __restrict__ x, int n, int d, const float* __restrict__ mu,
    const float* __restrict__ chol, const float* __restrict__ logdet,
    const float* __restrict__ logw, const int* __restrict__ active,
    const int* __restrict__ slots, int K, const long long* __restrict__ gidx,
    const long long* __restrict__ key_z, float half_d_log2pi,
    int* __restrict__ labels) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t base = (size_t)blockIdx.x * PANEL_PB;
  const int np = min((long long)PANEL_PB, (long long)n - (long long)base);
  gauss_assign_panel(x + base * d, np, d, gidx + base, mu, chol, logdet, logw,
                     active, slots, K, (uint32_t)key_z[0], (uint32_t)key_z[1],
                     half_d_log2pi, reinterpret_cast<float*>(smem),
                     labels + base);
}

template <class Kernel>
int launch(Kernel kernel, int dp, int threads, size_t extra_words,
           const float* x, int n, int d, const float* mu, const float* chol,
           const float* logdet, const float* logw, const int* active,
           const int* slots, int K, const long long* gidx,
           const long long* key_z, int* labels, cudaStream_t stream) {
  const int bk_max = gauss_tile_slots(dp, K);
  const size_t smem = sizeof(float) * (gauss_tile_floats(dp, bk_max) +
                                       extra_words + 2 * (size_t)PB);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + PB - 1) / PB;
  const float half_d_log2pi = (float)(0.5 * d * 1.8378770664093453);
  kernel<<<blocks, threads, smem, stream>>>(
      x, n, d, mu, chol, logdet, logw, active, slots, K, bk_max, gidx, key_z,
      half_d_log2pi, labels);
  return (int)cudaGetLastError();
}

int launch_panel(const float* x, int n, int d, const float* mu,
                 const float* chol, const float* logdet, const float* logw,
                 const int* active, const int* slots, int K,
                 const long long* gidx, const long long* key_z, int* labels,
                 cudaStream_t stream) {
  const size_t smem = sizeof(float) * panel_smem_floats();
  cudaError_t err = cudaFuncSetAttribute(
      assign_gauss_panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + PANEL_PB - 1) / PANEL_PB;
  const float half_d_log2pi = (float)(0.5 * d * 1.8378770664093453);
  assign_gauss_panel_kernel<<<blocks, PANEL_THREADS, smem, stream>>>(
      x, n, d, mu, chol, logdet, logw, active, slots, K, gidx, key_z,
      half_d_log2pi, labels);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

extern "C" int assign_gauss_launch(const float* x, int n, int d,
                                   const float* mu, const float* chol,
                                   const float* logdet, const float* logw,
                                   const int* active, const int* slots, int K,
                                   const long long* gidx,
                                   const long long* key_z, int* labels,
                                   void* stream) {
  using namespace repro_torch;
  if (n <= 0 || K <= 0 || d <= 0 || d > PANEL_D)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > WIDE_D)
    return launch_panel(x, n, d, mu, chol, logdet, logw, active, slots, K,
                        gidx, key_z, labels, s);
#define REPRO_ASSIGN_CASE(KERNEL, DP, THREADS, EXTRA)                       \
  return launch(KERNEL, DP, THREADS, EXTRA, x, n, d, mu, chol, logdet, logw, \
                active, slots, K, gidx, key_z, labels, s)
  if (d <= 4) REPRO_ASSIGN_CASE(assign_gauss_kernel<4>, 4, NARROW_THREADS, 0);
  if (d <= 8) REPRO_ASSIGN_CASE(assign_gauss_kernel<8>, 8, NARROW_THREADS, 0);
  if (d <= 16)
    REPRO_ASSIGN_CASE(assign_gauss_kernel<16>, 16, NARROW_THREADS, 0);
  if (d <= 32)
    REPRO_ASSIGN_CASE(assign_gauss_kernel<32>, 32, NARROW_THREADS, 0);
  if (d <= 64)
    REPRO_ASSIGN_CASE(assign_gauss_kernel<64>, 64, NARROW_THREADS, 0);
  REPRO_ASSIGN_CASE(assign_gauss_wide_kernel, WIDE_D, WIDE_THREADS,
                    wide_x_floats(WIDE_THREADS));
#undef REPRO_ASSIGN_CASE
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
