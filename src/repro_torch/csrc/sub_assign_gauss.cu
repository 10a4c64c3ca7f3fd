// Step (f) alone for the full-covariance Gaussian family, on an NVIDIA
// Hopper card (sm_90a): the sub-label of every point under its own
// cluster, the second pass of the three-pass sweep (gibbs.sweep_tile with
// fused=False, ComponentFamily.sweep_ref, which the fit runs past the
// one-read sweep's d <= 128).
//
// Replaces the TPU kernel src/repro/kernels/assign.py:sub_assign_gauss
// (_sub_assign_gauss_kernel). Per point i with label l = labels[i] and
// Gumbel counter gidx[i]:
//   zb_i = first argmax_s [ 0.5 (sub_logdet_ls - |F_ls^T (x_i - mu_ls)|^2)
//                           - 0.5 d log(2 pi) + sublogw_ls
//                           + Gumbel(key_zb, gidx_i, s) ],  s in {0, 1}
// A label outside [0, K) gets sub-label 0.
//
// Design. The TPU kernel kept all (K, 2, d, d) factors resident in VMEM and
// gathered each point's own two with jnp.take. Here no factor is staged:
// each point reads its own cluster's two factors from global memory, and
// all of them stay in the 50 MB L2 (16 MiB at K = 32, d = 256). Three
// layouts by d, with the device code of the one-read sweep's step (f)
// (assign_tile.cuh), so for d <= 128 the sub-labels equal the sweep's bit
// for bit on the same labels:
//  - narrow (d <= 64): one thread per point, x in registers
//    (gauss_sub_narrow, template DP = d rounded up to a power of two);
//  - wide (64 < d <= 128): four lanes per point, 32 columns each, x staged
//    in shared memory, two xor shuffles (gauss_sub_wide);
//  - warp (128 < d <= 256): one warp per point, lane c takes columns
//    c + 32t, so a warp reads a factor row in coalesced 128-byte pieces,
//    and five xor shuffles leave the same |y|^2 in every lane
//    (maha_warp_global).
//
// What bounds it. 2 N 2 d^2 FLOP of fp32 FMA against N d 4 bytes of x and
// N 12 bytes of labels, indices and output: at the fit's final state
// (N = 1e6, d = 32) 4.1 GFLOP, about 0.06 ms at 67 TFLOP/s, so the CUDA
// cores' fp32 rate bounds it. Each point reads 2 d^2 4 bytes of factors
// from L2 (8 KiB at d = 32, 512 KiB at d = 256), which is what a first
// kernel spends its time on; sorting points by label to share a staged
// factor is left for a later version.
//
// Limits: 1 <= d <= 256, 1 <= K.
#include <cuda_runtime.h>
#include <stdint.h>

#include "assign_tile.cuh"

namespace repro_torch {

// Warp layout (128 < d <= PANEL_D): one warp per point, its x row xs staged
// in shared memory; lane c sums columns c + 32t of y = F^T (x - m), so a
// warp reads a factor row from L2 in coalesced 128-byte pieces, and five xor
// shuffles leave the same |y|^2 in every lane.
constexpr int WARP_COLS = PANEL_D / 32;
__device__ __forceinline__ float maha_warp_global(
    const float* xs, const float* __restrict__ f,
    const float* __restrict__ m, int d, int lane) {
  float y[WARP_COLS];
#pragma unroll
  for (int t = 0; t < WARP_COLS; ++t) y[t] = 0.f;
#pragma unroll 2
  for (int r = 0; r < d; ++r) {
    const float dv = xs[r] - __ldg(m + r);
    const float* fr = f + (size_t)r * d;
#pragma unroll
    for (int t = 0; t < WARP_COLS; ++t) {
      const int c = lane + 32 * t;
      if (c < d) y[t] = fmaf(dv, __ldg(fr + c), y[t]);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < WARP_COLS; ++t) s = fmaf(y[t], y[t], s);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

constexpr int NARROW_THREADS = 128;   // one point per thread
constexpr int WIDE_THREADS = 256;     // 64 lane groups, one point each
constexpr int WARP_THREADS = 256;     // 8 warps
constexpr int WARP_PB = 64;           // points per block, 8 per warp

template <int DP>
__global__ void __launch_bounds__(NARROW_THREADS) sub_assign_gauss_kernel(
    const float* __restrict__ x, int n, int d, const int* __restrict__ labels,
    int K, const float* __restrict__ sub_mu,
    const float* __restrict__ sub_chol, const float* __restrict__ sub_logdet,
    const float* __restrict__ sublogw, const long long* __restrict__ gidx,
    const long long* __restrict__ key_zb, float half_d_log2pi,
    int* __restrict__ sublabels) {
  const size_t i = (size_t)blockIdx.x * NARROW_THREADS + threadIdx.x;
  if (i >= (size_t)n) return;
  const int l = labels[i];
  if (l < 0 || l >= K) {
    sublabels[i] = 0;
    return;
  }
  float xr[DP];
  load_row<DP>(x + i * d, d, xr);
  sublabels[i] = gauss_sub_narrow<DP>(
      xr, d, l, sub_mu, sub_chol, sub_logdet, sublogw, (uint32_t)gidx[i],
      (uint32_t)key_zb[0], (uint32_t)key_zb[1], half_d_log2pi);
}

__global__ void __launch_bounds__(WIDE_THREADS) sub_assign_gauss_wide_kernel(
    const float* __restrict__ x, int n, int d, const int* __restrict__ labels,
    int K, const float* __restrict__ sub_mu,
    const float* __restrict__ sub_chol, const float* __restrict__ sub_logdet,
    const float* __restrict__ sublogw, const long long* __restrict__ gidx,
    const long long* __restrict__ key_zb, float half_d_log2pi,
    int* __restrict__ sublabels) {
  constexpr int groups = WIDE_THREADS / WIDE_LANES;
  __shared__ float xsm[groups * WIDE_XSTRIDE];
  const int grp = threadIdx.x / WIDE_LANES, j = threadIdx.x % WIDE_LANES;
  const size_t base = (size_t)blockIdx.x * groups;
  const int np = min((long long)groups, (long long)n - (long long)base);
  const bool live = grp < np;
  float* xs = xsm + grp * WIDE_XSTRIDE;
  stage_x_wide(x + base * d, grp, live, d, j, xs);
  __syncwarp();
  const int l = live ? labels[base + grp] : 0;
  const bool ok = live && l >= 0 && l < K;
  // every lane of the warp runs the shuffles, pad groups included
  const int zb = gauss_sub_wide(
      xs, d, j, ok ? l : 0, sub_mu, sub_chol, sub_logdet, sublogw, ok,
      ok ? (uint32_t)gidx[base + grp] : 0u, (uint32_t)key_zb[0],
      (uint32_t)key_zb[1], half_d_log2pi);
  if (live && j == 0) sublabels[base + grp] = ok ? zb : 0;
}

__global__ void __launch_bounds__(WARP_THREADS) sub_assign_gauss_warp_kernel(
    const float* __restrict__ x, int n, int d, const int* __restrict__ labels,
    int K, const float* __restrict__ sub_mu,
    const float* __restrict__ sub_chol, const float* __restrict__ sub_logdet,
    const float* __restrict__ sublogw, const long long* __restrict__ gidx,
    const long long* __restrict__ key_zb, float half_d_log2pi,
    int* __restrict__ sublabels) {
  constexpr int warps = WARP_THREADS / 32;
  __shared__ float xsm[warps * PANEL_D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xs = xsm + warp * PANEL_D;
  const size_t base = (size_t)blockIdx.x * WARP_PB;
  const int np = min((long long)WARP_PB, (long long)n - (long long)base);
  const uint32_t kb0 = (uint32_t)key_zb[0], kb1 = (uint32_t)key_zb[1];
  for (int p = warp; p < np; p += warps) {     // uniform over the warp
    const size_t i = base + p;
    for (int c = lane; c < d; c += 32) xs[c] = __ldg(x + i * d + c);
    __syncwarp();
    const int l = labels[i];
    int zb = 0;
    if (l >= 0 && l < K) {
      const uint32_t g = (uint32_t)gidx[i];
      float t2[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const size_t ks = (size_t)l * 2 + s;
        const float maha = maha_warp_global(xs, sub_chol + ks * d * d,
                                            sub_mu + ks * d, d, lane);
        float t = 0.5f * (__ldg(sub_logdet + ks) - maha) - half_d_log2pi;
        t = t + __ldg(sublogw + ks);
        t2[s] = t + gumbel(kb0, kb1, g, (uint32_t)s);
      }
      zb = t2[1] > t2[0] ? 1 : 0;
    }
    if (lane == 0) sublabels[i] = zb;
    __syncwarp();
  }
}

template <class Kernel>
int launch(Kernel kernel, int threads, int points_per_block, const float* x,
           int n, int d, const int* labels, int K, const float* sub_mu,
           const float* sub_chol, const float* sub_logdet,
           const float* sublogw, const long long* gidx,
           const long long* key_zb, int* sublabels, cudaStream_t stream) {
  const int blocks = (n + points_per_block - 1) / points_per_block;
  const float half_d_log2pi = (float)(0.5 * d * 1.8378770664093453);
  kernel<<<blocks, threads, 0, stream>>>(x, n, d, labels, K, sub_mu,
                                         sub_chol, sub_logdet, sublogw, gidx,
                                         key_zb, half_d_log2pi, sublabels);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

extern "C" int sub_assign_gauss_launch(const float* x, int n, int d,
                                       const int* labels, int K,
                                       const float* sub_mu,
                                       const float* sub_chol,
                                       const float* sub_logdet,
                                       const float* sublogw,
                                       const long long* gidx,
                                       const long long* key_zb,
                                       int* sublabels, void* stream) {
  using namespace repro_torch;
  if (n <= 0 || K <= 0 || d <= 0 || d > PANEL_D)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_SUB_CASE(KERNEL, THREADS, PB)                                 \
  return launch(KERNEL, THREADS, PB, x, n, d, labels, K, sub_mu, sub_chol, \
                sub_logdet, sublogw, gidx, key_zb, sublabels, s)
  if (d <= 4)
    REPRO_SUB_CASE(sub_assign_gauss_kernel<4>, NARROW_THREADS, NARROW_THREADS);
  if (d <= 8)
    REPRO_SUB_CASE(sub_assign_gauss_kernel<8>, NARROW_THREADS, NARROW_THREADS);
  if (d <= 16)
    REPRO_SUB_CASE(sub_assign_gauss_kernel<16>, NARROW_THREADS,
                   NARROW_THREADS);
  if (d <= 32)
    REPRO_SUB_CASE(sub_assign_gauss_kernel<32>, NARROW_THREADS,
                   NARROW_THREADS);
  if (d <= 64)
    REPRO_SUB_CASE(sub_assign_gauss_kernel<64>, NARROW_THREADS,
                   NARROW_THREADS);
  if (d <= WIDE_D)
    REPRO_SUB_CASE(sub_assign_gauss_wide_kernel, WIDE_THREADS,
                   WIDE_THREADS / WIDE_LANES);
  REPRO_SUB_CASE(sub_assign_gauss_warp_kernel, WARP_THREADS, WARP_PB);
#undef REPRO_SUB_CASE
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
