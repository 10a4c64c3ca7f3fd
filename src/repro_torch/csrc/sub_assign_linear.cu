// Step (f) alone for the linear-likelihood families (multinomial, Poisson,
// diagonal Gaussian), on an NVIDIA Hopper card (sm_90a): the sub-label of
// every point under its own cluster, the second pass of the three-pass
// sweep (gibbs.sweep_tile with fused=False, ComponentFamily.sweep_ref).
//
// Replaces the TPU kernel src/repro/kernels/assign.py:sub_assign_linear
// (_sub_assign_linear_kernel). Each family packs its sub-cluster
// log-likelihoods as a linear form of per-point features f (its
// ``assign_pack``). Per point i with label l = labels[i] and Gumbel counter
// gidx[i]:
//   zb_i = first argmax_s [ (f_i . subw_ls + subconst_ls) + sublogw_ls
//                           + Gumbel(key_zb, gidx_i, s) ],  s in {0, 1}
// A label outside [0, K) gets sub-label 0.
//
// Design. The TPU kernel kept the (K, 2, d') sub-weights resident in VMEM
// and gathered each point's two rows with a one-hot matmul on the matrix
// unit. Here a thread block owns PT = 256 points and runs the one-read
// sweep's step (f) on them (assign_tile.cuh, linear_sub_assign, shared with
// sweep_linear.cu): one warp per point, the lanes striding its feature row
// and its own cluster's two sub-weight rows (read from L2), a shuffle-down
// tree for each sum, then the Gumbel draws and the choice for 32 points at
// once. So the sub-labels equal the sweep's bit for bit on the same labels,
// and a repeat launch gives the same bits.
//
// What bounds it. It reads N d' 4 bytes of features once (plus labels and
// indices) and does 2 N 2 d' FLOP: at the multinomial fit's shape
// (N = 1e6, d' = 128) 512 MB against 0.5 GFLOP, about 0.15 ms at
// 3.35 TB/s, so it is bound by bytes; at the 20newsgroups width (d' =
// 20,000) by bytes as well.
//
// Limits: 1 <= d' <= 65536, 1 <= K.
#include <cuda_runtime.h>
#include <stdint.h>

#include "assign_tile.cuh"

namespace repro_torch {

// linear_sub_assign's output step: the sub-label alone.
struct PutSub {
  int* sub;
  __device__ void operator()(int p, int zb) const { sub[p] = zb; }
};

__global__ void __launch_bounds__(LIN_THREADS) sub_assign_linear_kernel(
    const float* __restrict__ feats, int n, int dp,
    const int* __restrict__ labels, int K, const float* __restrict__ subw,
    const float* __restrict__ subconst, const float* __restrict__ sublogw,
    const long long* __restrict__ gidx, const long long* __restrict__ key_zb,
    int* __restrict__ sublabels) {
  const size_t base = (size_t)blockIdx.x * PT;
  const int np = min((long long)PT, (long long)n - (long long)base);
  const bool vec = (dp & 3) == 0 &&
                   (((uintptr_t)feats | (uintptr_t)subw) & 15) == 0;
  linear_sub_assign<true>(feats + base * dp, np, dp, gidx + base,
                          labels + base, K, subw, subconst, sublogw,
                          (uint32_t)key_zb[0], (uint32_t)key_zb[1], vec,
                          PutSub{sublabels + base});
}

}  // namespace repro_torch

extern "C" int sub_assign_linear_launch(const float* feats, int n, int dp,
                                        const int* labels, int K,
                                        const float* subw,
                                        const float* subconst,
                                        const float* sublogw,
                                        const long long* gidx,
                                        const long long* key_zb,
                                        int* sublabels, void* stream) {
  using namespace repro_torch;
  if (n <= 0 || dp <= 0 || dp > 65536 || K <= 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + PT - 1) / PT;
  sub_assign_linear_kernel<<<blocks, LIN_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      feats, n, dp, labels, K, subw, subconst, sublogw, gidx, key_zb,
      sublabels);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
