// Step (e) alone for the linear-likelihood families (multinomial, Poisson,
// diagonal Gaussian), on an NVIDIA Hopper card (sm_90a): labels of a batch
// of points under a model, the posterior draw DPMMEngine.sample serves.
//
// Replaces the TPU kernel src/repro/kernels/assign.py:assign_linear
// (_assign_linear_kernel). Each family packs its log-likelihood as a
// linear form of per-point features f (its ``assign_pack``). Per point i
// with Gumbel counter gidx[i]:
//   z_i = first argmax_k [ (f_i . w_k + const_k) + logw_k  (-1e30 if slot
//                          k is inactive) + Gumbel(key_z, gidx_i, slots_k) ]
//
// Design. The TPU kernel's grid (point blocks, K tiles) carried the running
// (max, argmax) across K tiles in VMEM scratch; here a thread block owns PT
// = 256 points and runs step (e) on them (assign_tile.cuh, linear_assign,
// whose chains sweep_linear.cu keeps): 32-feature chunks of the
// points and of the tile's active weight rows staged with cp.async, an
// 8 x 8 register block of dot products per thread in feature order, the
// inactive slots' noise drawn all the same, and a strict-`>` first max.
// The (N, K) logits never exist in device memory.
//
// What bounds it. 2 N K_live d' FLOP of fp32 FMA against N d' 4 bytes of
// features: at a serving step (N = 8192, d' = 128, 16 live slots) 34 MFLOP
// against 4 MB, about 1.2 us of memory traffic at 3.35 TB/s, so it is
// bound by bytes, and at that size mostly by launch latency; at the
// 20newsgroups width (d' = 20,000) by bytes as well.
//
// Limits: 1 <= d' <= 65536, 1 <= K.
#include <cuda_runtime.h>
#include <stdint.h>

#include "assign_tile.cuh"

namespace repro_torch {

__global__ void __launch_bounds__(LIN_THREADS, 2) assign_linear_kernel(
    const float* __restrict__ feats, int n, int dp,
    const float* __restrict__ w, const float* __restrict__ cst,
    const float* __restrict__ logw, const int* __restrict__ active,
    const int* __restrict__ slots, int K, const long long* __restrict__ gidx,
    const long long* __restrict__ key_z, int* __restrict__ labels) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* words = reinterpret_cast<float*>(smem);
  float* best = words + linear_assign_words();
  int* lab = reinterpret_cast<int*>(best + PT);
  const size_t base = (size_t)blockIdx.x * PT;
  const int np = min((long long)PT, (long long)n - (long long)base);
  const bool vec = (dp & 3) == 0 &&
                   (((uintptr_t)feats | (uintptr_t)w) & 15) == 0;
  linear_assign(feats + base * dp, np, dp, gidx + base, w, cst, logw, active,
                slots, K, (uint32_t)key_z[0], (uint32_t)key_z[1], vec, words,
                best, lab);
  for (int p = threadIdx.x; p < np; p += LIN_THREADS) labels[base + p] = lab[p];
}

}  // namespace repro_torch

extern "C" int assign_linear_launch(const float* feats, int n, int dp,
                                    const float* w, const float* cst,
                                    const float* logw, const int* active,
                                    const int* slots, int K,
                                    const long long* gidx,
                                    const long long* key_z, int* labels,
                                    void* stream) {
  using namespace repro_torch;
  if (n <= 0 || dp <= 0 || dp > 65536 || K <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (linear_assign_words() + 2 * (size_t)PT);
  cudaError_t err = cudaFuncSetAttribute(
      assign_linear_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + PT - 1) / PT;
  assign_linear_kernel<<<blocks, LIN_THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      feats, n, dp, w, cst, logw, active, slots, K, gidx, key_z, labels);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
