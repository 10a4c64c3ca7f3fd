// One-read fused Gibbs sweep for the full-covariance Gaussian family:
// steps (e) + (f) of the restricted sampler and the sub-cluster statistic
// fold, on an NVIDIA Hopper card (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sweep.py:sweep_gauss
// (_sweep_gauss_kernel). What it computes, per point i with global index
// gidx[i]:
//   (e) z_i  = first argmax_k [ 0.5 (logdet_k - |F_k^T (x_i - mu_k)|^2)
//                               - 0.5 d log(2 pi) + logw_k  (-1e30 if the
//                               slot is inactive) + Gumbel(key_z, gidx_i,
//                               slots_k) ]
//   (f) zb_i = first argmax_s of the same form over the two sub-clusters
//              of cluster z_i, with Gumbel(key_zb, gidx_i, s)
//   and, per STATS_BLOCK of points, the (K, 2) partials n / sx / sxx over
//   segments 2 z + zb (block_stats.cuh).
//
// Design. The TPU grid (point blocks, phase, K tiles) ran in order and
// carried the running (max, argmax) from one K tile to the next in
// scratch. Here one thread block owns one STATS_BLOCK of points and loops
// over the K tiles itself: a tile of bk Cholesky factors is staged in
// shared memory, every thread folds its points against it with a strict
// `>` (first max wins, as in the reference), and the running best lives in
// shared memory between tiles. Step (f) reads each point's own (2, d, d)
// factors straight from global memory (they stay in L1/L2). The stats of
// the block are then folded without float atomics, so the per-STATS_BLOCK
// partials are (nsb, K, 2, ...) and never the per-(point block, K block)
// layout of the TPU kernel.
//
// What bounds it. Step (e) is 2 N K d^2 FLOP of fp32 FMA over the K live
// slots (33 GFLOP at N = 1e6, K = 16, d = 32; inactive slots of the
// compact slab are skipped) against N d 4 B of x, so it is bound by the
// CUDA cores' fp32 rate, not by memory: about 0.5 ms at the H100 SXM's
// 67 TFLOP/s. This first version keeps each point's whitened difference in
// registers and broadcasts the factor rows from shared memory (one 16-byte
// shared load per four FMAs); tensor cores (TF32 wgmma for F^T diff) and
// TMA staging of x are left for a later version.
//
// Limits: d <= 64 (the register arrays are sized to d rounded up to a
// power of two, at least 4), 1 <= K <= 2048 (segment offsets live in
// shared memory).
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_stats.cuh"
#include "threefry.cuh"

namespace repro_torch {

constexpr int SWEEP_THREADS = 256;
constexpr float NEG_INF = -1e30f;
// Shared-memory budget of one staged tile of cluster factors.
constexpr int TILE_FLOATS = 8192;

template <int DP>
__device__ __forceinline__ void load_row(const float* __restrict__ src, int d,
                                         float (&r)[DP]) {
#pragma unroll
  for (int a = 0; a < DP; ++a) r[a] = a < d ? __ldg(src + a) : 0.f;
}

template <int DP>
__global__ void __launch_bounds__(SWEEP_THREADS) sweep_gauss_kernel(
    const float* __restrict__ x, int n, int d,
    const float* __restrict__ mu, const float* __restrict__ chol,
    const float* __restrict__ logdet, const float* __restrict__ logw,
    const int* __restrict__ active, const int* __restrict__ slots, int K,
    int bk_max, const float* __restrict__ sub_mu,
    const float* __restrict__ sub_chol, const float* __restrict__ sub_logdet,
    const float* __restrict__ sublogw, const float* __restrict__ valid,
    const long long* __restrict__ gidx, const long long* __restrict__ key_z,
    const long long* __restrict__ key_zb, float half_d_log2pi,
    int* __restrict__ labels, int* __restrict__ sublabels,
    float* __restrict__ n2, float* __restrict__ sx2,
    float* __restrict__ sxx2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = 2 * K;
  float* t_f = reinterpret_cast<float*>(smem);        // bk_max * DP * DP
  float* t_mu = t_f + bk_max * DP * DP;               // bk_max * DP
  float* t_ld = t_mu + bk_max * DP;                   // bk_max
  float* t_lw = t_ld + bk_max;                        // bk_max
  int* t_act = reinterpret_cast<int*>(t_lw + bk_max);  // bk_max
  int* t_slot = t_act + bk_max;                       // bk_max
  float* best = reinterpret_cast<float*>(t_slot + bk_max);  // STATS_BLOCK
  int* lab = reinterpret_cast<int*>(best + STATS_BLOCK);    // STATS_BLOCK
  int* seg = lab + STATS_BLOCK;                             // STATS_BLOCK
  int* idx = seg + STATS_BLOCK;                             // STATS_BLOCK
  int* start = idx + STATS_BLOCK;                           // S + 1
  int* cursor = start + S + 1;                              // S

  const size_t base = (size_t)blockIdx.x * STATS_BLOCK;
  const long long rest = (long long)n - (long long)base;
  const int np = rest < STATS_BLOCK ? (int)rest : STATS_BLOCK;
  const float* xb = x + base * d;
  const uint32_t kz0 = (uint32_t)key_z[0], kz1 = (uint32_t)key_z[1];
  const uint32_t kb0 = (uint32_t)key_zb[0], kb1 = (uint32_t)key_zb[1];

  for (int p = threadIdx.x; p < np; p += SWEEP_THREADS) {
    best[p] = NEG_INF;
    lab[p] = 0;
  }

  // ---- step (e): running first-max over the K tiles ----------------------
  for (int kt = 0; kt < K; kt += bk_max) {
    const int bk = min(bk_max, K - kt);
    __syncthreads();
    for (int i = threadIdx.x; i < bk * DP * DP; i += SWEEP_THREADS) {
      const int kk = i / (DP * DP), r = (i / DP) % DP, c = i % DP;
      t_f[i] = (r < d && c < d)
                   ? chol[((size_t)(kt + kk) * d + r) * d + c] : 0.f;
    }
    for (int i = threadIdx.x; i < bk * DP; i += SWEEP_THREADS) {
      const int kk = i / DP, c = i % DP;
      t_mu[i] = c < d ? mu[(size_t)(kt + kk) * d + c] : 0.f;
    }
    for (int i = threadIdx.x; i < bk; i += SWEEP_THREADS) {
      t_ld[i] = logdet[kt + i];
      t_lw[i] = logw[kt + i];
      t_act[i] = active[kt + i];
      t_slot[i] = slots[kt + i];
    }
    __syncthreads();
    for (int p = threadIdx.x; p < np; p += SWEEP_THREADS) {
      float xr[DP];
      load_row<DP>(xb + (size_t)p * d, d, xr);
      const uint32_t g = (uint32_t)gidx[base + p];
      float b = best[p];
      int l = lab[p];
      for (int kk = 0; kk < bk; ++kk) {
        // an inactive slot's logit is the mask whatever its likelihood,
        // so its whitening product is skipped (a branch uniform over the
        // block: every thread is at the same slot)
        float t = NEG_INF;
        if (t_act[kk] != 0) {
          const float* f = t_f + kk * DP * DP;
          const float* m = t_mu + kk * DP;
          float y[DP];
#pragma unroll
          for (int c = 0; c < DP; ++c) y[c] = 0.f;
#pragma unroll
          for (int r = 0; r < DP; ++r) {
            const float dv = xr[r] - m[r];
#pragma unroll
            for (int c = 0; c < DP; c += 4) {
              const float4 fr =
                  *reinterpret_cast<const float4*>(f + r * DP + c);
              y[c] = fmaf(dv, fr.x, y[c]);
              y[c + 1] = fmaf(dv, fr.y, y[c + 1]);
              y[c + 2] = fmaf(dv, fr.z, y[c + 2]);
              y[c + 3] = fmaf(dv, fr.w, y[c + 3]);
            }
          }
          float maha = 0.f;
#pragma unroll
          for (int c = 0; c < DP; ++c) maha = fmaf(y[c], y[c], maha);
          t = 0.5f * (t_ld[kk] - maha) - half_d_log2pi;
          t = t + t_lw[kk];
        }
        t = t + gumbel(kz0, kz1, g, (uint32_t)t_slot[kk]);
        if (t > b) {
          b = t;
          l = kt + kk;
        }
      }
      best[p] = b;
      lab[p] = l;
    }
  }

  // ---- step (f): own cluster's two sub-clusters ---------------------------
  for (int p = threadIdx.x; p < np; p += SWEEP_THREADS) {
    const int l = lab[p];
    float xr[DP];
    load_row<DP>(xb + (size_t)p * d, d, xr);
    const uint32_t g = (uint32_t)gidx[base + p];
    float t2[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const size_t ks = (size_t)l * 2 + s;
      const float* f = sub_chol + ks * d * d;
      const float* m = sub_mu + ks * d;
      float y[DP];
#pragma unroll
      for (int c = 0; c < DP; ++c) y[c] = 0.f;
#pragma unroll
      for (int r = 0; r < DP; ++r) {
        if (r < d) {
          const float dv = xr[r] - __ldg(m + r);
#pragma unroll
          for (int c = 0; c < DP; ++c)
            if (c < d) y[c] = fmaf(dv, __ldg(f + r * d + c), y[c]);
        }
      }
      float maha = 0.f;
#pragma unroll
      for (int c = 0; c < DP; ++c) maha = fmaf(y[c], y[c], maha);
      float t = 0.5f * (__ldg(sub_logdet + ks) - maha) - half_d_log2pi;
      t = t + __ldg(sublogw + ks);
      t2[s] = t + gumbel(kb0, kb1, g, (uint32_t)s);
    }
    const int zb = t2[1] > t2[0] ? 1 : 0;
    labels[base + p] = l;
    sublabels[base + p] = zb;
    seg[p] = valid[base + p] != 0.f ? 2 * l + zb : -1;
  }
  __syncthreads();

  // ---- stat fold of this STATS_BLOCK -------------------------------------
  sort_by_segment(seg, np, S, start, cursor, idx);
  const size_t blk = blockIdx.x;
  accumulate_segments(xb, valid + base, d, S, start, idx, n2 + blk * S,
                      sx2 + blk * S * d, sxx2 + blk * S * d * d);
}

template <int DP>
int launch(const float* x, int n, int d, const float* mu, const float* chol,
           const float* logdet, const float* logw, const int* active,
           const int* slots, int K, const float* sub_mu,
           const float* sub_chol, const float* sub_logdet,
           const float* sublogw, const float* valid, const long long* gidx,
           const long long* key_z, const long long* key_zb, int* labels,
           int* sublabels, float* n2, float* sx2, float* sxx2,
           cudaStream_t stream) {
  const int bk_max = max(1, min(K, TILE_FLOATS / (DP * DP)));
  const size_t smem =
      sizeof(float) * ((size_t)bk_max * DP * DP + (size_t)bk_max * DP +
                       4 * (size_t)bk_max + 4 * (size_t)STATS_BLOCK +
                       (size_t)4 * K + 1);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_gauss_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nsb = (n + STATS_BLOCK - 1) / STATS_BLOCK;
  const float half_d_log2pi = (float)(0.5 * d * 1.8378770664093453);
  sweep_gauss_kernel<DP><<<nsb, SWEEP_THREADS, smem, stream>>>(
      x, n, d, mu, chol, logdet, logw, active, slots, K, bk_max, sub_mu,
      sub_chol, sub_logdet, sublogw, valid, gidx, key_z, key_zb,
      half_d_log2pi, labels, sublabels, n2, sx2, sxx2);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

extern "C" int sweep_gauss_launch(
    const float* x, int n, int d, const float* mu, const float* chol,
    const float* logdet, const float* logw, const int* active,
    const int* slots, int K, const float* sub_mu, const float* sub_chol,
    const float* sub_logdet, const float* sublogw, const float* valid,
    const long long* gidx, const long long* key_z, const long long* key_zb,
    int* labels, int* sublabels, float* n2, float* sx2, float* sxx2,
    void* stream) {
  using namespace repro_torch;
  if (n <= 0 || K <= 0 || K > 2048 || d <= 0 || d > 64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_SWEEP_CASE(DP)                                                 \
  return launch<DP>(x, n, d, mu, chol, logdet, logw, active, slots, K,      \
                    sub_mu, sub_chol, sub_logdet, sublogw, valid, gidx,      \
                    key_z, key_zb, labels, sublabels, n2, sx2, sxx2, s)
  if (d <= 4) REPRO_SWEEP_CASE(4);
  if (d <= 8) REPRO_SWEEP_CASE(8);
  if (d <= 16) REPRO_SWEEP_CASE(16);
  if (d <= 32) REPRO_SWEEP_CASE(32);
  REPRO_SWEEP_CASE(64);
#undef REPRO_SWEEP_CASE
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
