// Step (e) alone for the full-covariance Gaussian family, on an NVIDIA
// Hopper card (sm_90a): labels of a batch of points under a model, the
// posterior draw DPMMEngine.sample serves and the first pass of the
// three-pass sweep (ComponentFamily.sweep_ref).
//
// Replaces the TPU kernel src/repro/kernels/assign.py:assign_gauss
// (_assign_gauss_kernel). Per point i with Gumbel counter gidx[i]:
//   z_i = first argmax_k [ 0.5 (logdet_k - |F_k^T (x_i - mu_k)|^2)
//                          - 0.5 d log(2 pi) + logw_k  (-1e30 if slot k is
//                          inactive) + Gumbel(key_z, gidx_i, slots_k) ]
//
// Design. The TPU kernel's grid (point blocks, K tiles) ran the K axis in
// order and carried the running (max, argmax) in VMEM scratch. Here the
// route is the wrapper's choice (kernels/assign.py gauss_plan, a function
// of the shape only):
//  - d <= 16: a thread block owns PB points and loops over K tiles of
//    factors staged in shared memory, with the sweep's in-block step (e)
//    (assign_tile.cuh gauss_assign_narrow, a thread a point);
//  - 16 < d <= 128: the register tile of the sweep's step (e)
//    (te_tile.cuh, the same device code as sweep_gauss.cu
//    sweep_assign_tiled) on a grid of 128-point tiles x slot groups, each
//    group a share of the live slots' column tiles, so a serving step of
//    a few thousand rows fills the card;
//  - d > 128: the panel layout (assign_tile.cuh gauss_panel), (X - mu_k)
//    F_k for each active slot as an output-stationary 8 x 8 register tile
//    fed by a cp.async ring of row slabs, on point tiles x slot groups
//    (kernels/assign.py panel_plan), any d.
// With more than one slot group, each group writes its (max, label) row to
// scratch the wrapper allocates and a second launch (assign_tile.cuh
// fold_groups) merges the rows by (max, least slot): the label of one walk
// over all slots, bit for bit, and no float atomics. Every route keeps the
// one-thread-a-point chains (te_tile.cuh, "Bits"), so a label equals the
// one the sweep would draw for the same inputs. The (N, K) logits never
// exist in device memory.
//
// What bounds it. 2 N K_live d (d + 1) FLOP of fp32 FMA against N d 4
// bytes of points and K d^2 4 bytes of factors: at a serving step
// (N = 8192, 17 live slots, d = 32) 0.29 GFLOP, about 4 us at 67 TFLOP/s,
// so it is bound by the CUDA cores' fp32 rate; at that size a launch is
// mostly latency. At the d = 256 fit's state (N = 4e5, 16 live slots of
// 32) it is 0.84 TFLOP, 12.6 ms at 67 TFLOP/s. No tensor cores and no
// TF32: at d = 256 a |y|^2 in the hundreds keeps about three digits in
// TF32, and label near-ties would become mismatches.
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

template <int DP>
__global__ void __launch_bounds__(TE_THREADS, 2) assign_gauss_tiled_kernel(
    const float* __restrict__ x, int n, int d, const float* __restrict__ mu,
    const float* __restrict__ chol, const float* __restrict__ logdet,
    const float* __restrict__ logw, const int* __restrict__ active,
    const int* __restrict__ slots, int K, const long long* __restrict__ gidx,
    const long long* __restrict__ key_z, float half_d_log2pi, int vec,
    float* __restrict__ best_out, int* __restrict__ lab_out) {
  extern __shared__ __align__(16) float te_smem[];
  te_tile<DP, true>(x, n, d, mu, chol, logdet, logw, active, slots, K, gidx,
                    (uint32_t)key_z[0], (uint32_t)key_z[1], half_d_log2pi,
                    vec != 0, te_smem, nullptr, best_out, lab_out);
}

template <int BM>
__global__ void __launch_bounds__(PanelTile<BM>::THREADS, 2)
    assign_gauss_panel_kernel(
        const float* __restrict__ x, int n, int d,
        const float* __restrict__ mu, const float* __restrict__ chol,
        const float* __restrict__ logdet, const float* __restrict__ logw,
        const int* __restrict__ active, const int* __restrict__ slots, int K,
        int per, const long long* __restrict__ gidx,
        const long long* __restrict__ key_z, float half_d_log2pi, int vec,
        float* __restrict__ best_out, int* __restrict__ lab_out) {
  extern __shared__ __align__(16) float panel_smem[];
  gauss_panel<BM, true>(x, n, d, mu, chol, logdet, logw, active, slots, K,
                        per, gidx, (uint32_t)key_z[0], (uint32_t)key_z[1],
                        half_d_log2pi, vec != 0, panel_smem, nullptr,
                        best_out, lab_out);
}

template <int DP>
int launch_narrow(const float* x, int n, int d, const float* mu,
                  const float* chol, const float* logdet, const float* logw,
                  const int* active, const int* slots, int K,
                  const long long* gidx, const long long* key_z, int* labels,
                  cudaStream_t stream) {
  const int bk_max = gauss_tile_slots(DP, K);
  const size_t smem =
      sizeof(float) * (gauss_tile_floats(DP, bk_max) + 2 * (size_t)PB);
  cudaError_t err = cudaFuncSetAttribute(
      assign_gauss_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + PB - 1) / PB;
  const float half_d_log2pi = (float)(0.5 * d * 1.8378770664093453);
  assign_gauss_kernel<DP><<<blocks, NARROW_THREADS, smem, stream>>>(
      x, n, d, mu, chol, logdet, logw, active, slots, K, bk_max, gidx, key_z,
      half_d_log2pi, labels);
  return (int)cudaGetLastError();
}

// The group rows of a launch with several slot groups: scratch holds
// groups x n floats (each group's running max) then groups x n ints (its
// label); one group writes the labels.
inline void group_rows(int groups, int n, float* scratch, int* labels,
                       float** best, int** lab) {
  *best = groups > 1 ? scratch : nullptr;
  *lab = groups > 1 ? reinterpret_cast<int*>(scratch + (size_t)groups * n)
                    : labels;
}

template <int DP>
int launch_tiled(const float* x, int n, int d, const float* mu,
                 const float* chol, const float* logdet, const float* logw,
                 const int* active, const int* slots, int K,
                 const long long* gidx, const long long* key_z, int groups,
                 int smem, float* scratch, int* labels, cudaStream_t stream) {
  if ((size_t)smem != te_smem_bytes<DP>(K)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      assign_gauss_tiled_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = ((long long)n + TE_BM - 1) / TE_BM;
  const float half_d_log2pi = (float)(0.5 * d * 1.8378770664093453);
  const int vec = (d & 3) == 0 && ((uintptr_t)chol & 15) == 0;
  float* best;
  int* lab;
  group_rows(groups, n, scratch, labels, &best, &lab);
  assign_gauss_tiled_kernel<DP><<<dim3((unsigned)tiles, groups), TE_THREADS,
                                  smem, stream>>>(
      x, n, d, mu, chol, logdet, logw, active, slots, K, gidx, key_z,
      half_d_log2pi, vec, best, lab);
  err = cudaGetLastError();
  if (err != cudaSuccess || groups == 1) return (int)err;
  return (int)launch_fold_groups(best, lab, n, groups, labels, stream);
}

template <int BM>
int launch_panel(const float* x, int n, int d, const float* mu,
                 const float* chol, const float* logdet, const float* logw,
                 const int* active, const int* slots, int K, int per,
                 int groups, int smem, const long long* gidx,
                 const long long* key_z, float* scratch, int* labels,
                 cudaStream_t stream) {
  using T = PanelTile<BM>;
  if (smem != T::SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      assign_gauss_panel_kernel<BM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = ((long long)n + BM - 1) / BM;
  const float half_d_log2pi = (float)(0.5 * d * 1.8378770664093453);
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(chol) % 16 == 0;
  float* best;
  int* lab;
  group_rows(groups, n, scratch, labels, &best, &lab);
  assign_gauss_panel_kernel<BM><<<dim3((unsigned)tiles, groups), T::THREADS,
                                  smem, stream>>>(
      x, n, d, mu, chol, logdet, logw, active, slots, K, per, gidx, key_z,
      half_d_log2pi, vec ? 1 : 0, best, lab);
  err = cudaGetLastError();
  if (err != cudaSuccess || groups == 1) return (int)err;
  return (int)launch_fold_groups(best, lab, n, groups, labels, stream);
}

}  // namespace repro_torch

// d <= 128: the launch is the wrapper's choice (kernels/assign.py
// gauss_plan, a function of the shape only): dp 0, the narrow layout
// (d <= 16, one group, smem 0), or the tile's padded width 32, 64 or 128
// (d <= 32, 32 < d <= 64, 64 < d <= 128) on `groups` slot groups with smem
// shared bytes, which must be that layout's. With groups > 1, scratch
// holds groups x n floats then groups x n ints.
extern "C" int assign_gauss_launch(const float* x, int n, int d,
                                   const float* mu, const float* chol,
                                   const float* logdet, const float* logw,
                                   const int* active, const int* slots, int K,
                                   const long long* gidx,
                                   const long long* key_z, int dp, int groups,
                                   int smem, float* scratch, int* labels,
                                   void* stream) {
  using namespace repro_torch;
  const bool width_ok = dp == 0    ? d <= 16
                        : dp == 32 ? d <= 32
                        : dp == 64 ? d > 32 && d <= 64
                        : dp == 128 ? d > 64 && d <= 128
                                    : false;
  if (n <= 0 || K <= 0 || d <= 0 || !width_ok || groups <= 0 ||
      groups > 65535 || (dp == 0 && (groups != 1 || smem != 0)) ||
      (groups > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dp == 0) {
    const auto narrow = d <= 4   ? &launch_narrow<4>
                        : d <= 8 ? &launch_narrow<8>
                                 : &launch_narrow<16>;
    return narrow(x, n, d, mu, chol, logdet, logw, active, slots, K, gidx,
                  key_z, labels, s);
  }
  const auto tiled = dp == 32   ? &launch_tiled<32>
                     : dp == 64 ? &launch_tiled<64>
                                : &launch_tiled<128>;
  return tiled(x, n, d, mu, chol, logdet, logw, active, slots, K, gidx,
               key_z, groups, smem, scratch, labels, s);
}

// d > 128: the launch is the wrapper's choice (kernels/assign.py
// panel_plan, a function of the shape only): bm points a block (32 or
// 128), per slots a group, groups = ceil(K / per) groups, and smem, which
// must be that tile's layout. With groups > 1, scratch holds groups x n
// floats (each group's running max) then groups x n ints (its argmax).
extern "C" int assign_gauss_panel_launch(
    const float* x, int n, int d, const float* mu, const float* chol,
    const float* logdet, const float* logw, const int* active,
    const int* slots, int K, const long long* gidx, const long long* key_z,
    int bm, int per, int groups, int smem, float* scratch, int* labels,
    void* stream) {
  using namespace repro_torch;
  if (n <= 0 || K <= 0 || d <= WIDE_D || per <= 0 || groups <= 0 ||
      groups > 65535 || (long long)groups * per < K ||
      (long long)(groups - 1) * per >= K ||
      (groups > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 128)
    return launch_panel<128>(x, n, d, mu, chol, logdet, logw, active, slots,
                             K, per, groups, smem, gidx, key_z, scratch,
                             labels, s);
  if (bm == 32)
    return launch_panel<32>(x, n, d, mu, chol, logdet, logw, active, slots,
                            K, per, groups, smem, gidx, key_z, scratch,
                            labels, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
