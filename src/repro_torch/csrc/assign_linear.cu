// Step (e) alone for the linear-likelihood families (multinomial, Poisson,
// diagonal Gaussian), on an NVIDIA Hopper card (sm_90a): labels of a batch
// of points under a model, the posterior draw DPMMEngine.sample serves and
// the first pass of the three-pass sweep (gibbs.sweep_tile with
// fused=False, ComponentFamily.sweep_ref).
//
// Replaces the TPU kernel src/repro/kernels/assign.py:assign_linear
// (_assign_linear_kernel). Each family packs its log-likelihood as a
// linear form of per-point features f (its ``assign_pack``). Per point i
// with Gumbel counter gidx[i]:
//   z_i = first argmax_k [ (f_i . w_k + const_k) + logw_k  (-1e30 if slot
//                          k is inactive) + Gumbel(key_z, gidx_i, slots_k) ]
//
// Design. The TPU kernel's grid (point blocks, K tiles) carried the running
// (max, argmax) across K tiles in VMEM scratch. Here a block runs step (e)
// of the one-read sweep_linear.cu on a tile of BM points: the device
// function linear_tile.cuh with step (f) switched off (slot windows of at
// most 2048, the active slots listed by a block-wide scan and multiplied
// through a cp.async ring of feature chunks, an 8-slot x BM / 32-point
// register tile a thread, the draws a loop over (point, slot) pairs merged
// by a shared atomic max of packed (max, least slot) keys). So its labels
// are the sweep's bit for bit. The tile fills the card: 128 points where
// that gives LE_BLOCKS blocks, else 64, else 32 (an 8192-row serving step:
// 256 blocks), chosen by the wrapper (kernels/assign.py
// linear_assign_plan); the launcher refuses any other plan. (Slot groups
// that merged their keys in global memory, and a second launch to read
// the labels, lost to the smaller tile at every timed shape, PERF.md §6.)
//
// What bounds it. 2 N K_live d' FLOP of fp32 FMA against N d' 4 bytes of
// features: at a serving step (N = 8192, d' = 128, 17 live slots) 36 MFLOP
// against 4 MB, about 1.3 us of memory traffic at 3.35 TB/s, so it is
// bound by bytes, and at that size mostly by launch latency and the
// block's serial phases; at the 20newsgroups width (d' = 20,000) by bytes
// as well.
//
// Limits: 1 <= N < 2^31, 1 <= d' <= 65536, 1 <= K < 2^31.
#include <cuda_runtime.h>
#include <stdint.h>

#include "linear_tile.cuh"

namespace repro_torch {

// Step (e) on BM points a block, a ring of STAGES feature chunks, MINB
// blocks an SM.
template <int BM, int STAGES, int MINB>
__global__ void __launch_bounds__(LE_THREADS, MINB)
    assign_linear_kernel(LinearTileArgs a) {
  extern __shared__ __align__(16) float ae_smem[];
  linear_tile<BM, STAGES, true, false, LE_FW>(a, ae_smem);
}

// The plan's tile (kernels/assign.py linear_assign_plan).
__host__ inline int la_tile(int n) {
  const long long m = n;
  return (m + 127) / 128 >= LE_BLOCKS ? 128
         : (m + 63) / 64 >= LE_BLOCKS ? 64 : 32;
}

template <int BM, int MINB>
int launch_e(int smem, const LinearTileArgs& a, cudaStream_t stream) {
  const auto kernel = assign_linear_kernel<BM, le_stages(BM), MINB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)(((long long)a.n + BM - 1) / BM);
  kernel<<<grid, LE_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// bm and smem are the wrapper's linear_assign_plan.
extern "C" int assign_linear_launch(const float* feats, int n, int dp,
                                    const float* w, const float* cst,
                                    const float* logw, const int* active,
                                    const int* slots, int K,
                                    const long long* gidx,
                                    const long long* key_z, int bm, int smem,
                                    int* labels, void* stream) {
  using namespace repro_torch;
  if (n <= 0 || dp <= 0 || dp > 65536 || K <= 0)
    return (int)cudaErrorInvalidValue;
  if (bm != la_tile(n) ||
      (size_t)smem !=
          sizeof(float) * lt_smem_words(true, false, bm, le_stages(bm), K))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  LinearTileArgs a{};
  a.feats = feats;
  a.n = n;
  a.dp = dp;
  a.w = w;
  a.cst = cst;
  a.logw = logw;
  a.active = active;
  a.slots = slots;
  a.K = K;
  a.gidx = gidx;
  a.key_z = key_z;
  // the chunk copies: 16-byte rows
  a.vec = (dp & 3) == 0 && (((uintptr_t)feats | (uintptr_t)w) & 15) == 0;
  a.labels = labels;
  // 128 points: a two-chunk ring, three blocks an SM; 64: four chunks,
  // two; 32: four chunks, three
  return bm == 128 ? launch_e<128, 3>(smem, a, s)
         : bm == 64 ? launch_e<64, 2>(smem, a, s)
                    : launch_e<32, 3>(smem, a, s);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
