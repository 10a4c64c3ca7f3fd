// Left-to-right fold of per-STATS_BLOCK statistic partials into a running
// accumulator on an NVIDIA Hopper card (sm_90a), every field of a stat
// fold in one launch:
//
//   out_f[j] = (((acc_f[j] + p_f[0][j]) + p_f[1][j]) + ...) + p_f[nb - 1][j]
//
// for each field f of the family's stats (n, sx, sxx for the Gaussian; n
// and the first moments for the linear families). The reference folds the
// partials of its one-read megakernels and of its blocked label-stat pass
// this way (src/repro/core/family.py:224-226, a lax.scan of adds from the
// accumulator, and :110-126), in global point order. That order is what
// makes a tiled chain bitwise the resident chain: a tile's partials
// continue the same sum from the accumulator the previous tile left, so
// the float additions are the same at every tile size. A reduction over
// the block axis (a tree, or sum-then-add) is not. It is not a Pallas
// kernel of the reference; on the card it takes the place of nb separate
// adds a field (about 1,000 launches a field at N = 10^6).
//
// Design. The caller passes a table of fields (accumulator, partials,
// output, elements, and the partials' layout: block stride, row length and
// row stride, so the diagonal Gaussian's two halves of one moment array
// need no copy). The grid spans every field's elements in tiles of TW
// consecutive elements; a thread block takes one tile and walks the nb
// blocks in chunks of B = 2048 / TW blocks: all 256 threads copy a chunk's
// B x TW partials into shared memory with cp.async (16-byte copies where
// the field's rows allow), FOLD_STAGES - 1 chunks ahead of the adds, and
// the tile's TW threads each run one element's chain of __fadd_rn (no
// reassociation, no contraction) over the chunk's rows in block order.
// TW is the field's (the launcher's rule, from nb and its elements m): 32
// where nb > 32, so that a narrow field (the counts: 2k elements) still
// spreads over many blocks and SMs, whose copies keep its long chains
// fed, up to 256 where the blocks are few, so a tile still moves
// kilobytes; and 256 for a field of FOLD_WIDE_M elements or more (the
// sxx of a stat window of a wide Gaussian fit: 4-8 M elements over 31-63
// blocks), whose wide tiles fill the card many times over, so all 256
// threads add and a tile's chunks stream through the ring. No atomics: two launches give the same bits, and
// the bits are those of the plain loop of adds.
//
// What bounds it. It reads sum_f (nb m_f + m_f) floats and writes sum_f
// m_f: bound by device memory bytes. A field's tiles are independent of
// another's, so the narrow fields' latency hides under the wide field's
// bytes in the one launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int FOLD_THREADS = 256;
constexpr int FOLD_CHUNK = 2048;      // floats a chunk: B x TW
constexpr int FOLD_STAGES = 4;        // chunks in the shared ring
constexpr int FOLD_MAX_ROWS = 4;      // fields a launch
constexpr int FOLD_WORDS = 7;         // int64 words a field of the table
// elements from which a field takes 256-wide tiles whatever nb: 4096
// tiles, four waves of 7 blocks an SM on 132 SMs (the 10^6 x 32 fit's
// sxx, 131,072 elements, keeps its 32-wide tiles)
constexpr long long FOLD_WIDE_M = 1LL << 20;

struct FoldRow {
  const float* acc;      // m contiguous floats
  const float* parts;    // block b, element j: b bstride + (j / len)
                         // rstride + j % len
  float* out;            // m contiguous floats
  long long m, bstride, len, rstride;
  long long tile0;       // the field's first tile in the grid
  int tw;                // elements a tile (32, 64, 128 or 256)
  int vec;               // 16-byte copies (every run of 4 aligned)
};

struct FoldTable {
  FoldRow row[FOLD_MAX_ROWS];
  int nrows, nb;
};

__device__ __forceinline__ void fold_cp16(float* dst, const float* src,
                                          int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void fold_cp4(float* dst, const float* src,
                                         int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void fold_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void fold_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy chunk c (blocks c B ..) of this thread's copies into stage dst.
// off[i] is copy i's element offset in a block's partials (-1: past the
// tile's elements), bl[i] its block within the chunk; rows past nb are
// zero-filled and never read.
template <int NC, int W>
__device__ __forceinline__ void fold_issue(const FoldRow& r, int nb, int c,
                                           int B, const long long* off,
                                           const int* bl, float* dst) {
  const float* base = r.parts;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const long long b = (long long)c * B + bl[i];
    const bool ok = off[i] >= 0 && b < nb;
    const float* src = ok ? base + b * r.bstride + off[i] : base;
    float* d = dst + (threadIdx.x + i * FOLD_THREADS) * W;
    if (W == 4)
      fold_cp16(d, src, ok ? 16 : 0);
    else
      fold_cp4(d, src, ok ? 4 : 0);
  }
}

// NC copies of W floats a thread a chunk: (2, 4) or (8, 1).
template <int NC, int W>
__device__ void fold_tile(const FoldRow& r, int nb, long long e0, int ne,
                          float* ring) {
  const int tid = threadIdx.x;
  const int tw = r.tw, B = FOLD_CHUNK / tw, q = tw / W;
  long long off[NC];
  int bl[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    // copy c of the chunk: block c / q, elements W (c % q) ..; the stage
    // holds block rows of tw floats, so copy c lands at float W c
    const int c = tid + i * FOLD_THREADS;
    bl[i] = c / q;
    const int j = W * (c - bl[i] * q);
    const long long e = e0 + j;
    off[i] = j < ne ? (e / r.len) * r.rstride + e % r.len : -1;
  }
  const int nchunks = (nb + B - 1) / B;
#pragma unroll
  for (int s = 0; s < FOLD_STAGES - 1; ++s) {
    if (s < nchunks)
      fold_issue<NC, W>(r, nb, s, B, off, bl, ring + s * FOLD_CHUNK);
    fold_commit();
  }
  float acc = tid < ne ? r.acc[e0 + tid] : 0.f;
  for (int c = 0; c < nchunks; ++c) {
    fold_wait<FOLD_STAGES - 2>();
    __syncthreads();       // chunk c landed; chunk c - 1's stage is free
    const int cn = c + FOLD_STAGES - 1;
    if (cn < nchunks)
      fold_issue<NC, W>(r, nb, cn, B, off, bl,
                        ring + (cn % FOLD_STAGES) * FOLD_CHUNK);
    fold_commit();
    if (tid < ne) {
      const float* col = ring + (c % FOLD_STAGES) * FOLD_CHUNK + tid;
      const int rows = min(B, nb - c * B);
#pragma unroll 8
      for (int b = 0; b < rows; ++b) acc = __fadd_rn(acc, col[b * tw]);
    }
  }
  fold_wait<0>();
  if (tid < ne) r.out[e0 + tid] = acc;
}

__global__ void __launch_bounds__(FOLD_THREADS) fold_fields_kernel(
    const __grid_constant__ FoldTable t) {
  __shared__ __align__(16) float ring[FOLD_STAGES * FOLD_CHUNK];
  const long long tile = blockIdx.x;
  int f = 0;
  while (f + 1 < t.nrows && tile >= t.row[f + 1].tile0) ++f;
  const FoldRow& r = t.row[f];
  const long long e0 = (tile - r.tile0) * r.tw;
  const long long left = r.m - e0;
  const int ne = left < r.tw ? (int)left : r.tw;
  if (r.vec)
    fold_tile<FOLD_CHUNK / 4 / FOLD_THREADS, 4>(r, t.nb, e0, ne, ring);
  else
    fold_tile<FOLD_CHUNK / FOLD_THREADS, 1>(r, t.nb, e0, ne, ring);
}

// Elements a tile of a field of m elements folded over nb blocks: wide
// tiles where the blocks are few (so a tile still moves a chunk of bytes)
// or the field alone fills the card with them, 32 where a chunk holds 64
// blocks (so a narrow field spreads over many SMs).
__host__ inline int fold_tile_width(int nb, long long m) {
  if (m >= FOLD_WIDE_M) return 256;
  return nb > 32 ? 32 : nb > 16 ? 64 : nb > 8 ? 128 : 256;
}

}  // namespace repro_torch

// table: nrows fields of FOLD_WORDS int64 words each, (acc, parts, out,
// m, bstride, len, rstride), pointers as integers; every field's partials
// lead with nb blocks. The launcher picks each field's tile width
// (fold_tile_width, from nb and the field's m) and copy width (16 bytes where the partials pointer,
// block stride, row length and row stride are all multiples of 4 floats).
extern "C" int fold_fields_launch(const long long* table, int nrows, int nb,
                                  void* stream) {
  using namespace repro_torch;
  if (nrows < 1 || nrows > FOLD_MAX_ROWS || nb < 0)
    return (int)cudaErrorInvalidValue;
  FoldTable t;
  t.nrows = nrows;
  t.nb = nb;
  long long tiles = 0;
  for (int f = 0; f < nrows; ++f) {
    const long long* w = table + FOLD_WORDS * f;
    FoldRow& r = t.row[f];
    r.acc = reinterpret_cast<const float*>(w[0]);
    r.parts = reinterpret_cast<const float*>(w[1]);
    r.out = reinterpret_cast<float*>(w[2]);
    r.m = w[3];
    r.bstride = w[4];
    r.len = w[5];
    r.rstride = w[6];
    if (r.m <= 0 || r.len <= 0 || r.len > r.m || r.rstride < r.len ||
        r.bstride < 0)
      return (int)cudaErrorInvalidValue;
    const int tw = fold_tile_width(nb, r.m);
    r.tw = tw;
    r.vec = ((uintptr_t)r.parts & 15) == 0 && (r.bstride & 3) == 0 &&
            (r.len & 3) == 0 && (r.rstride & 3) == 0;
    r.tile0 = tiles;
    tiles += (r.m + tw - 1) / tw;
  }
  for (int f = nrows; f < FOLD_MAX_ROWS; ++f) t.row[f] = t.row[nrows - 1];
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fold_fields_kernel<<<(unsigned)tiles, FOLD_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(t);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
