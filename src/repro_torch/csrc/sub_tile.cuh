// Step (f) of the full-covariance Gaussian family from staged operands,
// shared by the one-read sweep (sweep_gauss.cu, grouped by label within a
// STATS_BLOCK) and the standalone sub_assign_gauss.cu (grouped by label
// across the whole batch, narrow layout): a present label's two
// sub-components are staged in shared memory once, and every point of the
// label runs maha_narrow / maha_wide (assign_tile.cuh) on them, then
// sub_logit and its Gumbel. Both kernels compile this arithmetic, so their
// sub-labels agree bit for bit.
#pragma once

#include <stdint.h>

#include "assign_tile.cuh"

namespace repro_torch {

// Stage the two sub-components of labels list[0..nb) into slots 2 r + s of
// tile t (factors zero-padded to DP x DP, means to DP, sub_logdet in ld,
// sublogw in lw), between two barriers: the arithmetic of step (f) then
// reads its operands from shared memory, as step (e) does (a zero row or
// column adds exact zeros to a sum of squares).
template <int DP>
__device__ void stage_sub_labels(const GaussTile<DP>& t, const int* list,
                                 int nb, int d,
                                 const float* __restrict__ sub_mu,
                                 const float* __restrict__ sub_chol,
                                 const float* __restrict__ sub_logdet,
                                 const float* __restrict__ sublogw) {
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * nb; i += blockDim.x) {
    const size_t ks = 2 * (size_t)list[i >> 1] + (i & 1);
    t.ld[i] = sub_logdet[ks];
    t.lw[i] = sublogw[ks];
  }
  if ((d & 3) == 0 && ((uintptr_t)sub_chol & 15) == 0) {
    constexpr int Q = DP / 4;
    for (int i = threadIdx.x; i < 2 * nb * DP * Q; i += blockDim.x) {
      const int kk = i / (DP * Q), r = (i / Q) % DP, c = 4 * (i % Q);
      const size_t ks = 2 * (size_t)list[kk >> 1] + (kk & 1);
      *reinterpret_cast<float4*>(t.f + (size_t)kk * DP * DP + r * DP + c) =
          (r < d && c < d)
              ? __ldg(reinterpret_cast<const float4*>(
                    sub_chol + (ks * d + r) * d + c))
              : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = threadIdx.x; i < 2 * nb * DP * DP; i += blockDim.x) {
      const int kk = i / (DP * DP), r = (i / DP) % DP, c = i % DP;
      const size_t ks = 2 * (size_t)list[kk >> 1] + (kk & 1);
      t.f[i] = (r < d && c < d) ? __ldg(sub_chol + (ks * d + r) * d + c)
                                : 0.f;
    }
  }
  for (int i = threadIdx.x; i < 2 * nb * DP; i += blockDim.x) {
    const int kk = i / DP, c = i % DP;
    const size_t ks = 2 * (size_t)list[kk >> 1] + (kk & 1);
    t.mu[i] = c < d ? __ldg(sub_mu + ks * d + c) : 0.f;
  }
  __syncthreads();
}

// Step (f)'s logit of sub-cluster slot k of a staged tile: the parent
// kernels' expression, 0.5 (sub_logdet - maha) - 0.5 d log(2 pi), then
// + sublogw (the caller adds the Gumbel).
template <int DP>
__device__ __forceinline__ float sub_logit(const GaussTile<DP>& t, int k,
                                           float maha, float half_d_log2pi) {
  float v = 0.5f * (t.ld[k] - maha) - half_d_log2pi;
  v = v + t.lw[k];
  return v;
}

}  // namespace repro_torch
