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
// order and carried the running (max, argmax) in VMEM scratch. Here, for
// d <= 128, a thread block owns PB points and loops over the K tiles
// itself, with the device code of the sweep's step (e) (assign_tile.cuh,
// gauss_assign_narrow for d <= 64 and gauss_assign_wide for d <= 128): the
// same tile staging, inactive-slot skip, Threefry counters and strict-`>`
// first max, so a label equals the one the sweep would draw for the same
// inputs. For d > 128 (no one-read sweep) the grid is point tiles x slot
// groups (kernels/assign.py panel_plan) and each block runs the panel
// layout of assign_tile.cuh (gauss_panel): (X - mu_k) F_k for each active
// slot as an output-stationary 8 x 8 register tile fed by a cp.async ring
// of row slabs, any d. With more than one group, each group writes its
// running (max, first argmax) to scratch the wrapper allocates and a
// second launch (panel_fold_groups) takes the groups in slot order with
// strict `>`: the label of one walk over all slots, bit for bit, and no
// float atomics. The (N, K) logits never exist in device memory.
//
// What bounds it. 2 N K_live d (d + 1) FLOP of fp32 FMA against N d 4
// bytes of points and K d^2 4 bytes of factors: at a serving step
// (N = 8192, 16 live slots, d = 32) 0.27 GFLOP, about 4 us at 67 TFLOP/s,
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
  // one group writes the labels; several write their (max, argmax) rows
  float* best = groups > 1 ? scratch : nullptr;
  int* lab = groups > 1
                 ? reinterpret_cast<int*>(scratch + (size_t)groups * n)
                 : labels;
  assign_gauss_panel_kernel<BM><<<dim3((unsigned)tiles, groups), T::THREADS,
                                  smem, stream>>>(
      x, n, d, mu, chol, logdet, logw, active, slots, K, per, gidx, key_z,
      half_d_log2pi, vec ? 1 : 0, best, lab);
  err = cudaGetLastError();
  if (err != cudaSuccess || groups == 1) return (int)err;
  panel_fold_groups<<<(unsigned)(((long long)n + PANEL_FOLD_THREADS - 1) /
                                 PANEL_FOLD_THREADS),
                      PANEL_FOLD_THREADS, 0, stream>>>(best, lab, n, groups,
                                                       labels);
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
  if (n <= 0 || K <= 0 || d <= 0 || d > WIDE_D)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
