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
// What bounds it. The function needs N K d (d + 1) + 2 N K d operations
// (sxx is symmetric: d (d + 1) / 2 products a point and cluster) against
// 4 (N d + N K + K + K d + K d^2) bytes: at N = 10^6, d = 32, K = 32 about
// 36 GFLOP against 260 MB, bound by fp32 arithmetic (no tensor cores and
// no TF32: the reference sums in fp32). This kernel does all d^2 products
// (it does not mirror), about twice the operations the bound counts; the
// design keeps the FMA units fed.
//
// Design. The work is one product per point chunk: rows (k, a) of the
// a-side factor r_ik x_ia against columns b of x_ib, summed over points.
// Each cluster owns W rows of that row space, W = d rounded up to the
// column tile BN (16, 32, 64 or 128, from d; W = ceil(d / 128) * 128 above
// 64), and a thread block owns a BM x BN tile of it (BM = 16384 / BN):
// for d <= 64 the whole d x d of 64, 16 or 4 clusters, above 64 one
// 128 x 128 tile of one cluster's sxx, so a cluster's x rows are staged
// ceil(d / 128)^2 times (4 at d = 256). Each of the 256 threads keeps an
// 8 x 8 register tile (two groups of 4 rows BM / 2 apart, two of 4
// columns BN / 2 apart, so a warp's float4 reads of shared memory do not
// conflict): for every staged point it reads 16 floats and does 64 FMAs,
// fmaf(w x_a, x_b, acc) in point order. W and BN are template parameters,
// so every shared-memory offset of the unrolled slab is an immediate.
//
// The a-side factor w x_a is formed once a slab for the block's BM rows
// (__fmul_rn, the one rounding of every product's a-side) into a shared
// P x BM array, not by each of the BN / 8 threads that share a row: that
// takes 8 multiplies and 2 loads out of every 80 issue slots of the FMA
// loop. The same pass adds it, in point order, to sx (the Gram column of
// ones: fmaf(w x_a, 1, acc) is the single rounding __fadd_rn(acc, w x_a))
// and w to n, in the blocks of the first column tile. Index arithmetic
// divides by compile-time constants wherever it can (a runtime integer
// division is some 20 instructions).
//
// Copies in flight: a block walks its point chunk in slabs of P points;
// each slab's x rows (16-byte cp.async where d % 4 == 0 and x is aligned,
// 4-byte otherwise) and its clusters' r values (4-byte cp.async) go into a
// ring of STAGES shared buffers, so slabs s + 1 and s + 2 are copied while
// slab s is multiplied. Points past the chunk are zero-filled by the copy
// and add nothing. Shared bytes: 4 (STAGES P (W + clusters a block) + P
// BM) (DenseTile), at most 161,792 (d <= 16) and 115,072 at d = 256; two
// blocks a SM above d = 16. The wrapper (kernels/suffstats.py dense_plan)
// chooses the tile and the chunks; the launcher takes them as given.
//
// Order. The point axis is cut into chunks (grid.y) so that the card
// fills; every chunk writes its own partial, and a second kernel folds the
// chunks left to right, one thread per output element. The chunk count
// depends on (N, d, K) only and no float atomics are used, so two
// launches give the same bits.
//
// Past d = 256 (PANEL): the staged row of a cluster would pass a block's
// shared memory, so a block stages only the two 128-column panels its
// tile needs: x columns [128 ta, 128 ta + 128) of its rows and [128 tb,
// 128 tb + 128) of its columns, side by side in a 256-float row; the grid
// is K ceil(d / 128)^2 tiles and the shared layout the d <= 256 one's.
// Every entry keeps the chain above: fmaf(w x_a, x_b, acc) over a chunk's
// points in order, the chunks folded left to right.
//
// Slot windows. One launch takes the responsibility columns of one window
// [k0, k0 + K) of k_all (K <= 8192, the launcher's grid rule) and writes
// the window's clusters of n, sx and sxx; the wrapper runs the windows of
// kernels/suffstats.py slot_windows in turn.
//
// Limits: any d, K <= 8192 a window, N < 2^31.
#include <cstdint>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr int DENSE_THREADS = 256;
constexpr int DENSE_TILE = 16384;    // Gram elements a block: 256 x 8 x 8
constexpr int DENSE_P = 32;          // points a slab
constexpr int DENSE_STAGES = 3;      // slabs in the shared ring
constexpr int FOLD_THREADS = 256;
constexpr int SMEM_LIMIT = 232448;   // a Hopper block's dynamic shared bytes

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One slab: points [p0, p0 + P) of the chunk ending at p_end, x columns
// [0, d) into rows of W floats, r columns [k_lo, k_lo + nk) into rows of
// NCL floats. Points at or past p_end are zero-filled. Where d == W and nk
// == NCL (every full-width block) the element indices divide by
// compile-time constants: a runtime division costs some 20 instructions a
// copy, a tenth of the slab's FMA issue slots at d = 256.
template <int W, int NCL>
__device__ __forceinline__ void load_slab(
    const float* __restrict__ x, const float* __restrict__ r, int d,
    long long ldr, int k_lo, int nk, int p0, int p_end, bool vec, float* xd,
    float* rd) {
  const int tid = threadIdx.x;
  const int left = p_end - p0;   // points of the chunk from p0 (p0 + p
                                 // may pass 2^31 - 1 at the last slab)
  if (vec && d == W) {
    constexpr int Q = W / 4, E = DENSE_P * Q;
#pragma unroll
    for (int i = 0; i < (E + DENSE_THREADS - 1) / DENSE_THREADS; ++i) {
      const int e = tid + i * DENSE_THREADS;
      if (E % DENSE_THREADS == 0 || e < E) {
        const int p = e / Q, c = e % Q;
        const bool ok = p < left;
        cp_async16(xd + p * W + 4 * c,
                   ok ? x + (size_t)(p0 + p) * W + 4 * c : x, ok ? 16 : 0);
      }
    }
  } else if (vec) {
    const int d4 = d >> 2;
    for (int e = tid; e < DENSE_P * d4; e += DENSE_THREADS) {
      const int p = e / d4, c = e - p * d4;
      const bool ok = p < left;
      cp_async16(xd + p * W + 4 * c,
                 ok ? x + (size_t)(p0 + p) * d + 4 * c : x, ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < DENSE_P * d; e += DENSE_THREADS) {
      const int p = e / d, c = e - p * d;
      const bool ok = p < left;
      cp_async4(xd + p * W + c, ok ? x + (size_t)(p0 + p) * d + c : x,
                ok ? 4 : 0);
    }
  }
  if (nk == NCL) {
    constexpr int E = DENSE_P * NCL;
#pragma unroll
    for (int i = 0; i < (E + DENSE_THREADS - 1) / DENSE_THREADS; ++i) {
      const int e = tid + i * DENSE_THREADS;
      if (E % DENSE_THREADS == 0 || e < E) {
        const int p = e / NCL, c = e % NCL;
        const bool ok = p < left;
        cp_async4(rd + p * NCL + c,
                  ok ? r + (size_t)(p0 + p) * ldr + k_lo + c : r,
                  ok ? 4 : 0);
      }
    }
  } else {
    for (int e = tid; e < DENSE_P * nk; e += DENSE_THREADS) {
      const int p = e / nk, c = e - p * nk;
      const bool ok = p < left;
      cp_async4(rd + p * NCL + c,
                ok ? r + (size_t)(p0 + p) * ldr + k_lo + c : r, ok ? 4 : 0);
    }
  }
}

// One slab of the panel layout (d > 256): for points [p0, p0 + P), x
// columns [a_lo, a_lo + 128) into floats 0..127 of a 256-float row and
// [b_lo, b_lo + 128) into floats 128..255 (zero past d), and the one
// cluster's r value.
__device__ __forceinline__ void load_panel(
    const float* __restrict__ x, const float* __restrict__ r, int d,
    long long ldr, int k_lo, int a_lo, int b_lo, int p0, int p_end, bool vec,
    float* xd, float* rd) {
  constexpr int SW = 256, H = 128;
  const int tid = threadIdx.x;
  const int left = p_end - p0;
  if (vec) {
    constexpr int Q = SW / 4, E = DENSE_P * Q;
#pragma unroll
    for (int i = 0; i < E / DENSE_THREADS; ++i) {
      const int e = tid + i * DENSE_THREADS;
      const int p = e / Q, cs = 4 * (e % Q);
      const int c = cs < H ? a_lo + cs : b_lo + cs - H;
      const bool ok = p < left && c < d;
      cp_async16(xd + p * SW + cs, ok ? x + (size_t)(p0 + p) * d + c : x,
                 ok ? 16 : 0);
    }
  } else {
    constexpr int E = DENSE_P * SW;
#pragma unroll 4
    for (int i = 0; i < E / DENSE_THREADS; ++i) {
      const int e = tid + i * DENSE_THREADS;
      const int p = e / SW, cs = e % SW;
      const int c = cs < H ? a_lo + cs : b_lo + cs - H;
      const bool ok = p < left && c < d;
      cp_async4(xd + p * SW + cs, ok ? x + (size_t)(p0 + p) * d + c : x,
                ok ? 4 : 0);
    }
  }
  if (tid < DENSE_P) {
    const bool ok = tid < left;
    cp_async4(rd + tid, ok ? r + (size_t)(p0 + tid) * ldr + k_lo : r,
              ok ? 4 : 0);
  }
}

// The block tile of column tile BN and cluster width W, and its shared
// layout: a ring of STAGES slabs of P points (W x floats and NCL r values
// a point), then the slab's a-side factors, P x BM floats.
template <int BN, int W>
struct DenseTile {
  static constexpr int BM = DENSE_TILE / BN;          // Gram rows a block
  static constexpr int NBT = W / BN;                  // column tiles
  static constexpr int NCL = BM / W > 0 ? BM / W : 1; // clusters a block
  static constexpr int SMEM = (int)sizeof(float) *
      (DENSE_STAGES * DENSE_P * (W + NCL) + DENSE_P * BM);
  static_assert(W % BN == 0 && (NCL == 1 || BM % W == 0), "tile");
  static_assert(SMEM <= SMEM_LIMIT, "a Hopper block's shared memory");
};

// K: the window's clusters, r its first responsibility column, ldr the
// row stride of r; PANEL (W = 256, BN = 128, d > 256): nt = ceil(d / 128)
// column tiles a side.
template <int BN, int W, bool PANEL>
__global__ void __launch_bounds__(DENSE_THREADS, 2) suffstats_dense_kernel(
    const float* __restrict__ x, const float* __restrict__ r, int n, int d,
    int K, long long ldr, int nt, int chunk, int vec,
    float* __restrict__ part) {
  using T = DenseTile<BN, W>;
  constexpr int BM = T::BM, NCL = T::NCL;
  static_assert(!PANEL || (BN == 128 && W == 256), "the panel tile");
  const int NBT = PANEL ? nt : T::NBT;
  constexpr int TXN = BN / 8;                    // threads along columns
  constexpr int RPT = (BM + DENSE_THREADS - 1) / DENSE_THREADS;
  // two threads a row in the a-side pass: faster at d > 128 (10.2 against
  // 10.8 ms at 10^5 x 256, K = 32), slower at d <= 128 (4.95 against 4.83
  // ms at 2 10^5 x 128, where every block also sums sx), on an H100 80GB
  // HBM3 at 700 W
  constexpr bool SPLIT = 2 * BM == DENSE_THREADS && (PANEL || T::NBT > 1);
  extern __shared__ __align__(16) float smem_f[];
  float* xs = smem_f;                              // STAGES x P x W
  float* rs = xs + DENSE_STAGES * DENSE_P * W;     // STAGES x P x NCL
  float* wx = rs + DENSE_STAGES * DENSE_P * NCL;   // P x BM: w x_a
  const int tid = threadIdx.x;
  const int bt = blockIdx.x % NBT;
  // the cluster's row space: W rows, or nt 128-row tiles in panels
  const int vw = PANEL ? nt * BM : W;
  const long long r0 = (long long)(blockIdx.x / NBT) * BM;
  const int k_lo = (int)(r0 / vw);
  const int a_lo = (int)(r0 - (long long)k_lo * vw);  // 0, 128, ..
  const int nk = K - k_lo < NCL ? K - k_lo : NCL;
  // where this block's a-side rows and b-side columns sit in a staged row
  const int xa = PANEL ? 0 : a_lo, xc = PANEL ? 128 - bt * BN : 0;

  // this thread's Gram rows (block-local): two groups of 4, BM / 2 apart;
  // its columns: two groups of 4, BN / 2 apart
  const int tx = tid % TXN, ty = tid / TXN;
  const int g0 = 4 * ty, g1 = g0 + BM / 2;
  const int c0 = bt * BN + 4 * tx, c1 = c0 + BN / 2;   // output columns
  // rows past the last cluster (a block of fewer clusters, d <= 64) do no
  // work: whole warps of them skip the FMAs at small K. A block of one
  // cluster (d > 64) is all live.
  const bool live = NCL == 1 || k_lo + g0 / W < K;

  float acc[8][8], sx[RPT], nn[RPT];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
#pragma unroll
  for (int q = 0; q < RPT; ++q) sx[q] = nn[q] = 0.f;

  // x columns [d, W) and r columns [nk, NCL) stay zero: the copies write
  // below d and nk only
  for (int e = tid; e < DENSE_STAGES * DENSE_P * (W + NCL);
       e += DENSE_THREADS)
    smem_f[e] = 0.f;
  __syncthreads();

  // in 64 bits: nc chunks of whole slabs may end past 2^31 - 1 while n
  // does not
  const long long p_lo = (long long)blockIdx.y * chunk;
  const int p_begin = (int)p_lo;
  const int p_end = (int)(p_lo + chunk < n ? p_lo + chunk : n);
  const int ns = p_end > p_begin ? (p_end - p_begin + DENSE_P - 1) / DENSE_P
                                 : 0;
  const bool v = vec != 0;
  auto load = [&](int s, int b) {
    if constexpr (PANEL)
      load_panel(x, r, d, ldr, k_lo, a_lo, bt * BN, p_begin + s * DENSE_P,
                 p_end, v, xs + b * DENSE_P * W, rs + b * DENSE_P * NCL);
    else
      load_slab<W, NCL>(x, r, d, ldr, k_lo, nk, p_begin + s * DENSE_P,
                        p_end, v, xs + b * DENSE_P * W,
                        rs + b * DENSE_P * NCL);
  };
#pragma unroll
  for (int s = 0; s < DENSE_STAGES - 1; ++s) {
    if (s < ns) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < ns; ++s) {
    cp_async_wait<DENSE_STAGES - 2>();   // slab s has landed (this thread)
    __syncthreads();                     // ... and every thread's; slab
                                         // s - 1's buffers and wx are free
    const int nxt = s + DENSE_STAGES - 1;
    if (nxt < ns) load(nxt, nxt % DENSE_STAGES);
    cp_async_commit();
    const int b = s % DENSE_STAGES;
    const float* xb = xs + b * DENSE_P * W;
    const float* rb = rs + b * DENSE_P * NCL;
    // the a-side factor of the block's rows, once a slab: wx[p][g] =
    // w x_a (__fmul_rn, the one rounding of every product's a-side); the
    // first column tile's blocks also add it to sx (the ones column:
    // fmaf(w x_a, 1, acc) == __fadd_rn(acc, w x_a)) and w to n, in point
    // order. With SPLIT two threads share a row, each half the slab's
    // points; the first adds the second half's to sx and n after the
    // barrier, so the order stays the points'.
    if (SPLIT) {
      const int g = tid % BM, h = tid / BM;
      const float* xr = xb + xa + g;
#pragma unroll 8
      for (int i = 0; i < DENSE_P / 2; ++i) {
        const int p = h * (DENSE_P / 2) + i;
        const float w = rb[p * NCL];
        const float f = __fmul_rn(w, xr[p * W]);
        wx[p * BM + g] = f;
        if (bt == 0 && h == 0) {
          sx[0] = __fadd_rn(sx[0], f);
          nn[0] = __fadd_rn(nn[0], w);
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const int g = tid + q * DENSE_THREADS;
        if (g < BM && (NCL == 1 || g / W < nk)) {
          const int kk = (a_lo + g) / W, a = a_lo + g - kk * W;
          const float* xr = xb + a;
          const float* rr = rb + kk;
          if (bt == 0) {
#pragma unroll 8
            for (int p = 0; p < DENSE_P; ++p) {
              const float w = rr[p * NCL];
              const float f = __fmul_rn(w, xr[p * W]);
              wx[p * BM + g] = f;
              sx[q] = __fadd_rn(sx[q], f);
              nn[q] = __fadd_rn(nn[q], w);
            }
          } else {
#pragma unroll 8
            for (int p = 0; p < DENSE_P; ++p)
              wx[p * BM + g] = __fmul_rn(rr[p * NCL], xr[p * W]);
          }
        }
      }
    }
    __syncthreads();
    if (SPLIT && bt == 0 && tid < BM) {
#pragma unroll 8
      for (int p = DENSE_P / 2; p < DENSE_P; ++p) {
        sx[0] = __fadd_rn(sx[0], wx[p * BM + tid]);
        nn[0] = __fadd_rn(nn[0], rb[p * NCL]);
      }
    }
    if (!live) continue;
#pragma unroll
    for (int p = 0; p < DENSE_P; ++p) {
      const float4 va0 = *reinterpret_cast<const float4*>(wx + p * BM + g0);
      const float4 va1 = *reinterpret_cast<const float4*>(wx + p * BM + g1);
      const float4 vb0 =
          *reinterpret_cast<const float4*>(xb + p * W + xc + c0);
      const float4 vb1 =
          *reinterpret_cast<const float4*>(xb + p * W + xc + c1);
      const float wa[8] = {va0.x, va0.y, va0.z, va0.w,
                           va1.x, va1.y, va1.z, va1.w};
      const float vb[8] = {vb0.x, vb0.y, vb0.z, vb0.w,
                           vb1.x, vb1.y, vb1.z, vb1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(wa[i], vb[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();

  const size_t m = (size_t)K * (1 + d + (size_t)d * d);
  float* out = part + (size_t)blockIdx.y * m;
  float* out_sx = out + K;
  float* out_sxx = out_sx + (size_t)K * d;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int g = a_lo + (h == 0 ? g0 : g1);
    const int k = k_lo + g / vw, a_base = g % vw;
    if (k >= K) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int a = a_base + i;
      if (a >= d) break;
      float* row = out_sxx + ((size_t)k * d + a) * d;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int b = j < 4 ? c0 + j : c1 + j - 4;
        if (b < d) row[b] = acc[4 * h + i][j];
      }
    }
  }
  if (bt != 0) return;
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int g = tid + q * DENSE_THREADS;
    if (g >= BM) continue;
    const int k = k_lo + (a_lo + g) / vw, a = (a_lo + g) % vw;
    if (k >= K || a >= d) continue;
    out_sx[(size_t)k * d + a] = sx[q];
    if (a == 0) out[k] = nn[q];
  }
}

// out[j] = (((0 + part[0][j]) + part[1][j]) + ...): the chunks in order.
// part holds the window's K clusters' n (K), sx (K, d), sxx (K, d, d); out
// all k_all clusters', of which the window's start at cluster k0.
__global__ void __launch_bounds__(FOLD_THREADS) fold_chunks_kernel(
    const float* __restrict__ part, long long m, int nc, int K, int d,
    int k0, int k_all, float* __restrict__ out) {
  const long long j = (long long)blockIdx.x * FOLD_THREADS + threadIdx.x;
  if (j >= m) return;
  float s = 0.f;
  for (int c = 0; c < nc; ++c) s = __fadd_rn(s, part[(size_t)c * m + j]);
  const long long kd = (long long)K * d, dd = (long long)d * d;
  long long o;
  if (j < K)
    o = k0 + j;
  else if (j < K + kd)
    o = k_all + (long long)k0 * d + (j - K);
  else
    o = k_all + (long long)k_all * d + (long long)k0 * dd + (j - K - kd);
  out[o] = s;
}

template <int BN, int W, bool PANEL = false>
cudaError_t launch_dense(const float* x, const float* r, int n, int d, int K,
                         long long ldr, int chunk, int nc, int smem, bool vec,
                         float* part, cudaStream_t s) {
  using T = DenseTile<BN, W>;
  if ((PANEL ? d <= W : d > W) || smem != T::SMEM)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      suffstats_dense_kernel<BN, W, PANEL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int nt = (d + T::BM - 1) / T::BM;
  const long long gx =
      PANEL ? (long long)K * nt * nt
            : ((long long)K * W + T::BM - 1) / T::BM * T::NBT;
  if (gx > 0x7fffffffLL) return cudaErrorInvalidValue;
  suffstats_dense_kernel<BN, W, PANEL><<<dim3((unsigned)gx, nc),
                                         DENSE_THREADS, smem, s>>>(
      x, r, n, d, K, ldr, nt, chunk, vec ? 1 : 0, part);
  return cudaGetLastError();
}

}  // namespace repro_torch

// The launch is the wrapper's choice (kernels/suffstats.py dense_plan, a
// function of the shape only): the tile (bn, width), one of the five
// instantiated here, with width >= d, or the panel tile (128, 256) past
// d = 256; chunks of whole slabs, none empty; smem, which must be that
// tile's layout. One slot window [k0, k0 + K) of k_all clusters: r is the
// whole (n, k_all) responsibility matrix, part the window's chunk
// partials, out all k_all clusters' n, sx, sxx.
extern "C" int suffstats_dense_launch(const float* x, const float* r, int n,
                                      int d, int k_all, int k0, int K,
                                      int bn, int width, int chunk, int nc,
                                      int smem, float* part, float* out,
                                      void* stream) {
  using namespace repro_torch;
  if (n <= 0 || d <= 0 || K <= 0 || K > 8192 || k0 < 0 || k0 > k_all - K ||
      nc <= 0 || nc > 65535 || chunk <= 0 || chunk % DENSE_P != 0 ||
      (long long)nc * chunk < n || (long long)(nc - 1) * chunk >= n)
    return (int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<std::uintptr_t>(x) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rw = r + k0;
  const long long ldr = k_all;
  cudaError_t err;
  if (bn == 16 && width == 16)
    err = launch_dense<16, 16>(x, rw, n, d, K, ldr, chunk, nc, smem, vec,
                               part, s);
  else if (bn == 32 && width == 32)
    err = launch_dense<32, 32>(x, rw, n, d, K, ldr, chunk, nc, smem, vec,
                               part, s);
  else if (bn == 64 && width == 64)
    err = launch_dense<64, 64>(x, rw, n, d, K, ldr, chunk, nc, smem, vec,
                               part, s);
  else if (bn == 128 && width == 128)
    err = launch_dense<128, 128>(x, rw, n, d, K, ldr, chunk, nc, smem, vec,
                                 part, s);
  else if (bn == 128 && width == 256 && d <= 256)
    err = launch_dense<128, 256>(x, rw, n, d, K, ldr, chunk, nc, smem, vec,
                                 part, s);
  else if (bn == 128 && width == 256)
    err = launch_dense<128, 256, true>(x, rw, n, d, K, ldr, chunk, nc, smem,
                                       vec, part, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  const long long m = (long long)K * (1 + d + (long long)d * d);
  fold_chunks_kernel<<<(unsigned)((m + FOLD_THREADS - 1) / FOLD_THREADS),
                       FOLD_THREADS, 0, s>>>(part, m, nc, K, d, k0, k_all,
                                             out);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
