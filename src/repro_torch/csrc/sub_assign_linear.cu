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
// unit. Here a block runs step (f) of the one-read sweep_linear.cu on a
// tile of BM points under the caller's labels: the device function
// linear_tile.cuh with step (e) switched off. Up to d' = 32 a thread a
// (point, sub-cluster) runs the 32 lane chains and the shuffle tree
// itself; above, each warp takes a run of up to 32 consecutive points in
// windows of LF_FW (the loads of a window's points in flight together;
// a sub-weight row comes from L1 or L2), lane q of the run keeps point
// q's two sums, and every lane of the run draws and chooses for its own
// point. Nothing grows with K. The sub-labels equal the sweep's bit for
// bit on the same labels (the same lane chains and tree), and a repeat
// launch gives the same bits. Each route is a kernel of its own, so the
// warp route keeps its registers to its own code and reads each point's
// label and Gumbel counter where it needs them (nothing staged, no
// barrier). The tile fills the card: the largest of 128, 64 and 32
// points that gives LE_BLOCKS blocks, or on the warp route 256 where that
// gives LF_BM256_BLOCKS (four waves of four blocks an SM: fewer tiles of
// 256 leave a wave's tail half empty), chosen by the wrapper
// (kernels/assign.py linear_sub_plan); the launcher refuses any other plan.
//
// What bounds it. It reads N d' 4 bytes of features once (plus labels and
// indices) and does 2 N 2 d' FLOP: at the multinomial fit's shape
// (N = 1e6, d' = 128) 512 MB against 0.5 GFLOP, about 0.16 ms at
// 3.35 TB/s, so it is bound by bytes; at the 20newsgroups width (d' =
// 20,000) by bytes as well.
//
// Limits: 1 <= N < 2^31, 1 <= d' <= 65536, 1 <= K < 2^31.
#include <cuda_runtime.h>
#include <stdint.h>

#include "linear_tile.cuh"

namespace repro_torch {

// The warp route's window of points and the blocks an SM its registers
// allow (tools/ablate_linear.py times the other choices); the thread
// route runs four blocks an SM.
constexpr int LF_FW = 4;
constexpr int LF_MINB = 4;

constexpr int LF_BM256_BLOCKS = 8 * LE_BLOCKS;

// Step (f) on BM points a block, on ROUTE (F_THREAD or F_WARP).
template <int BM, int ROUTE>
__global__ void __launch_bounds__(LE_THREADS,
                                  ROUTE == F_THREAD ? 4 : LF_MINB)
    sub_assign_linear_kernel(LinearTileArgs a) {
  extern __shared__ __align__(16) float af_smem[];
  linear_tile<BM, 1, false, true, LF_FW, ROUTE>(a, af_smem);
}

// The plan's tile (kernels/assign.py linear_sub_plan).
__host__ inline int lf_tile(int n, bool f_thread) {
  const long long m = n;
  return !f_thread && (m + 255) / 256 >= LF_BM256_BLOCKS ? 256
         : (m + 127) / 128 >= LE_BLOCKS ? 128
         : (m + 63) / 64 >= LE_BLOCKS ? 64 : 32;
}

template <int BM, int ROUTE>
int launch_f(int smem, const LinearTileArgs& a, cudaStream_t stream) {
  const unsigned grid = (unsigned)(((long long)a.n + BM - 1) / BM);
  sub_assign_linear_kernel<BM, ROUTE><<<grid, LE_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// bm, f_thread and smem are the wrapper's linear_sub_plan.
extern "C" int sub_assign_linear_launch(const float* feats, int n, int dp,
                                        const int* labels, int K,
                                        const float* subw,
                                        const float* subconst,
                                        const float* sublogw,
                                        const long long* gidx,
                                        const long long* key_zb, int bm,
                                        int f_thread, int smem,
                                        int* sublabels, void* stream) {
  using namespace repro_torch;
  if (n <= 0 || dp <= 0 || dp > 65536 || K <= 0)
    return (int)cudaErrorInvalidValue;
  if (f_thread != (dp <= LF_THREAD_DP ? 1 : 0) ||
      bm != lf_tile(n, f_thread != 0) ||
      (size_t)smem != sizeof(float) * lt_smem_words(false, true, bm, 1, K))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  LinearTileArgs a{};
  a.feats = feats;
  a.n = n;
  a.dp = dp;
  a.K = K;
  a.subw = subw;
  a.subconst = subconst;
  a.sublogw = sublogw;
  a.gidx = gidx;
  a.key_zb = key_zb;
  // step (f)'s lane layout: 16-byte rows
  a.vec = (dp & 3) == 0 && (((uintptr_t)feats | (uintptr_t)subw) & 15) == 0;
  a.f_thread = f_thread;
  a.labels_in = labels;
  a.sublabels = sublabels;
  if (f_thread)
    return bm == 128 ? launch_f<128, F_THREAD>(smem, a, s)
           : bm == 64 ? launch_f<64, F_THREAD>(smem, a, s)
                      : launch_f<32, F_THREAD>(smem, a, s);
  return bm == 256 ? launch_f<256, F_WARP>(smem, a, s)
         : bm == 128 ? launch_f<128, F_WARP>(smem, a, s)
         : bm == 64 ? launch_f<64, F_WARP>(smem, a, s)
                    : launch_f<32, F_WARP>(smem, a, s);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
