// Sufficient statistics from a dense responsibility matrix on an NVIDIA
// Hopper card (sm_90a): the dense oracle of the paper's per-stream stat
// accumulation (§4.4, §4.2's kernel comparison).
//
// Replaces the TPU kernel src/repro/kernels/suffstats.py:suffstats
// (_suffstats_kernel). Given x (N, d) and responsibilities r (N, K), both
// float32 and row-major, it writes
//
//   n[k]         = sum_i r_ik
//   sx[k][a]     = sum_i r_ik x_ia
//   sxx[k][a][b] = sum_i (r_ik x_ia) x_ib
//
// into one buffer laid out as n (K), sx (K, d), sxx (K, d, d).
//
// Design. The TPU kernel kept a (bk, d, d) output tile in VMEM and
// revisited it over the point axis in grid order, on the matrix unit. Here
// a thread owns one cluster k and a 4 x 4 tile (a, b) of its sxx, in
// registers (threads whose b tile is 0 also keep sx, the thread of tile
// (0, 0) also n); 256 consecutive (k, a tile, b tile) items make a thread
// block. The block walks a chunk of points, P at a time staged in shared
// memory (x rows zero-padded to a multiple of 4 columns, and the r columns
// of the block's clusters), each thread adding its 16 products per point
// in point order with fmaf. The point axis is cut into chunks (grid.y) so
// that the card fills when K d^2 is small; every chunk writes its own
// partial, and a second kernel folds the chunks left to right, one thread
// per output element. The chunk count depends on (N, K, d) only and no
// float atomics are used, so two launches give the same bits.
//
// What bounds it. 2 N K d^2 + 2 N K d operations against 4 (N d + N K + K
// + K d + K d^2) bytes: at N = 10^6, d = 32, K = 32 about 65 GFLOP against
// 260 MB, bound by fp32 arithmetic (no tensor cores: the reference sums in
// fp32). Each point's staged row is read from shared memory once per
// thread tile, 8 floats for 16 FMAs.
//
// Limits: 1 <= d <= 256 (the staged rows and the int tile index), K <=
// 8192, N < 2^31.
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int DENSE_THREADS = 256;
constexpr int DENSE_P = 32;          // points staged per step
constexpr int FOLD_THREADS = 256;

__global__ void __launch_bounds__(DENSE_THREADS) suffstats_dense_kernel(
    const float* __restrict__ x, const float* __restrict__ r, int n, int d,
    int K, int chunk, float* __restrict__ part) {
  extern __shared__ __align__(16) float smem_f[];
  const int dq = (d + 3) / 4, d4 = 4 * dq, tpk = dq * dq;
  const long long items = (long long)K * tpk;
  const long long i0 = (long long)blockIdx.x * DENSE_THREADS;
  const int k_lo = (int)(i0 / tpk);
  const long long i_last = i0 + DENSE_THREADS - 1 < items
                               ? i0 + DENSE_THREADS - 1 : items - 1;
  const int k_hi = (int)(i_last / tpk);
  const int nkb = k_hi - k_lo + 1;
  float* xs = smem_f;                      // DENSE_P x d4
  float* rs = xs + DENSE_P * d4;           // DENSE_P x nkb

  const long long item = i0 + threadIdx.x;
  const bool live = item < items;
  const int k = live ? (int)(item / tpk) : k_lo;
  const int rem = live ? (int)(item - (long long)k * tpk) : 0;
  const int ta = rem / dq, tb = rem - ta * dq;
  const int kk = k - k_lo;

  float acc[4][4], sx[4], nk = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sx[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  const int p_begin = blockIdx.y * chunk;
  const int p_end = p_begin + chunk < n ? p_begin + chunk : n;
  for (int p0 = p_begin; p0 < p_end; p0 += DENSE_P) {
    const int np = p_end - p0 < DENSE_P ? p_end - p0 : DENSE_P;
    __syncthreads();
    for (int e = threadIdx.x; e < DENSE_P * d4; e += DENSE_THREADS) {
      const int p = e / d4, a = e - p * d4;
      xs[e] = (p < np && a < d) ? x[(size_t)(p0 + p) * d + a] : 0.f;
    }
    for (int e = threadIdx.x; e < DENSE_P * nkb; e += DENSE_THREADS) {
      const int p = e / nkb, c = e - p * nkb;
      rs[e] = p < np ? r[(size_t)(p0 + p) * K + k_lo + c] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int p = 0; p < np; ++p) {
      const float w = rs[p * nkb + kk];
      const float4 xa = *reinterpret_cast<const float4*>(xs + p * d4 + 4 * ta);
      const float4 xb = *reinterpret_cast<const float4*>(xs + p * d4 + 4 * tb);
      const float wa[4] = {w * xa.x, w * xa.y, w * xa.z, w * xa.w};
      const float vb[4] = {xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wa[i], vb[j], acc[i][j]);
      }
      if (tb == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) sx[i] = __fadd_rn(sx[i], wa[i]);
        if (ta == 0) nk = __fadd_rn(nk, w);
      }
    }
  }
  if (!live) return;
  const size_t m = (size_t)K * (1 + d + (size_t)d * d);
  float* out = part + (size_t)blockIdx.y * m;
  float* out_sx = out + K;
  float* out_sxx = out_sx + (size_t)K * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = 4 * ta + i;
    if (a >= d) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = 4 * tb + j;
      if (b < d) out_sxx[((size_t)k * d + a) * d + b] = acc[i][j];
    }
    if (tb == 0) out_sx[(size_t)k * d + a] = sx[i];
  }
  if (ta == 0 && tb == 0) out[k] = nk;
}

// out[j] = (((0 + part[0][j]) + part[1][j]) + ...): the chunks in order.
__global__ void __launch_bounds__(FOLD_THREADS) fold_chunks_kernel(
    const float* __restrict__ part, long long m, int nc,
    float* __restrict__ out) {
  const long long j = (long long)blockIdx.x * FOLD_THREADS + threadIdx.x;
  if (j >= m) return;
  float s = 0.f;
  for (int c = 0; c < nc; ++c) s = __fadd_rn(s, part[(size_t)c * m + j]);
  out[j] = s;
}

}  // namespace repro_torch

// nc: the point chunks, from the wrapper (kernels/suffstats.py
// dense_chunks: about two waves of 132 SMs, a shape-only choice).
extern "C" int suffstats_dense_launch(const float* x, const float* r, int n,
                                      int d, int K, int nc, float* part,
                                      float* out, void* stream) {
  using namespace repro_torch;
  if (n <= 0 || d <= 0 || d > 256 || K <= 0 || K > 8192 || nc <= 0)
    return (int)cudaErrorInvalidValue;
  const int dq = (d + 3) / 4;
  const long long items = (long long)K * dq * dq;
  const long long gx = (items + DENSE_THREADS - 1) / DENSE_THREADS;
  const int chunk = (n + nc - 1) / nc;   // an empty last chunk adds zeros
  if (gx > 0x7fffffffLL || nc > 65535) return (int)cudaErrorInvalidValue;
  // the block's cluster span is at most DENSE_THREADS + 1 columns of r
  const size_t smem =
      sizeof(float) * DENSE_P * (4 * (size_t)dq + DENSE_THREADS + 1);
  cudaError_t err = cudaFuncSetAttribute(
      suffstats_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  suffstats_dense_kernel<<<dim3((unsigned)gx, nc), DENSE_THREADS, smem, s>>>(
      x, r, n, d, K, chunk, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long m = (long long)K * (1 + d + (long long)d * d);
  fold_chunks_kernel<<<(unsigned)((m + FOLD_THREADS - 1) / FOLD_THREADS),
                       FOLD_THREADS, 0, s>>>(part, m, nc, out);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
