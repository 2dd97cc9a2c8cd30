// Block-bitmap compressed matmul for Hopper (sm_90a): Y = X @ W.
//
// Two entries, one per Pallas TPU kernel of src/repro/kernels/bitmap_spmm.py:
//   bitmap_spmm_{f32,bf16}        replaces `_pipelined_kernel` (launched by
//                                 `_bitmap_spmm_pipelined`, the default path
//                                 of repro.kernels.ops.bitmap_spmm);
//   bitmap_spmm_naive_{f32,bf16}  replaces `_kernel` (launched by
//                                 `bitmap_spmm_pallas` with pipeline=False).
//
// Format (the B(N1)-B(K1)-None(N2,K2) bitmap, pre-decoded to CSC):
//   blocks  (nnzb, bn, bk) fp32  non-zero payload blocks, block-column major
//   counts  (K/bk,) int32        non-zero blocks in each block-column
//   offsets (K/bk,) int32        exclusive cumsum of counts
//   row_ids (nnzb,) int32        block-row of each stored block
// x (M, N) is fp32 or bf16 and is converted to fp32 exactly; y (M, K) fp32.
//
// Design.  Each thread block owns one TM x tk output tile (tk <= 64 divides
// bk, so a tile lies in one block-column kj) and keeps it in registers,
// 4 x 4 values per thread.  It reads its own counts[kj] / offsets[kj] /
// row_ids and walks ONLY the non-zero blocks of its column, in the stored
// order.  Within a block it reduces over bn in chunks of BC rows staged in
// shared memory (x slice and payload slice), masking the ragged last chunk
// (bn need not be a multiple of BC: 856 = 26*32 + 24) and the ragged M edge
// (decode runs M = batch).  counts[kj] == 0 writes zeros.  No atomics, so
// the result is deterministic.  The format block is NOT the CUDA tile:
// planned blocks are up to 1024 x 13696 (56 MB in fp32), far beyond shared
// memory, so the output is tiled independently of the block shape.
//
// The naive entry reads the TPU grid (M/bm, K/bk, t_max) for what it does:
// its sequential third axis becomes a loop over t < t_max inside the thread
// block, with the STATIC bound t_max (a kernel argument, the caller's
// max-over-layers bound) instead of counts[kj].  Every step reads the block
// at min(offsets[kj] + t, nnzb - 1) and its row id, as the TPU BlockSpec
// index maps fetch it (so nothing reads past nnzb; density 0 stores one
// padded zero block with all counts 0), and a step with t >= counts[kj]
// runs no FMA.  Live steps are exactly t < counts[kj] and come first, so
// both entries are one template: the naive instance walks the live steps
// with kernel 1's loop (same tiling, BC chunking and FMA order: at fp32
// the two entries are bit-identical, as the reference pins its two TPU
// kernels) and then, under `if constexpr`, reads the masked steps'
// blocks.  No branch sits in the FMA loop nest: versions with one (a
// shared step function, or an `if (live)` around the FMAs) compiled to 48
// registers with spills and ran the affected entry at twice kernel 1's
// decode time.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s fp32 without tensor
// cores): bytes = stored payload (nnz blocks * bn * bk * 4) + metadata
// + x + y, against 2 * M * (nnz blocks * bn * bk) FLOPs -- the same work
// for both entries.  Decode (M = 4) is bound by the payload bytes; prefill
// (M = 512) by the fp32 FLOPs.  The static bound costs the naive entry
// (t_max - counts[kj]) extra block reads per output tile, FMAs skipped:
// nothing where every column holds t_max blocks, up to t_max / counts[kj]
// times the payload traffic of a short column.
//
// What the simple design leaves on the table: every M tile re-streams the
// payload (M = 512 reads it 8 times), loads are scalar and synchronous (no
// cp.async / TMA double-buffering), decode leaves 60 of 64 tile rows idle,
// and fp32 FMAs on CUDA cores run at 1/15 of the bf16 tensor-core rate
// (wgmma with bf16 payload is the later step).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;        // output rows per thread block
constexpr int TK = 64;        // output columns per thread block (tk <= TK)
constexpr int BC = 32;        // reduction rows staged per step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// NAIVE = false is kernel 1; NAIVE = true adds the naive entry's masked
// steps after the same walk over the live steps (a compile-time switch,
// so no branch enters the FMA loop nest).  nnzb and t_max are read only
// by the naive instance.
template <typename T, bool NAIVE>
__global__ void __launch_bounds__(THREADS)
bitmap_spmm_kernel(const T* __restrict__ x, const float* __restrict__ blocks,
                   const int* __restrict__ counts,
                   const int* __restrict__ row_ids,
                   const int* __restrict__ offsets, float* __restrict__ y,
                   int m, int n, int k, int bn, int bk, int tk, int nnzb,
                   int t_max) {
  __shared__ float xs[TM][BC + 1];
  __shared__ float ws[BC][TK];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * tk;          // first output column of the tile
  const int m0 = blockIdx.y * TM;          // first output row of the tile
  const int kj = k0 / bk;                  // block-column of the tile
  const int kb = k0 - kj * bk;             // column offset inside the block
  const int cnt = counts[kj];
  const int off = offsets[kj];

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < cnt; ++t) {
    const size_t xcol = (size_t)row_ids[off + t] * bn;
    const float* wblk = blocks + (size_t)(off + t) * bn * bk + kb;
    for (int c0 = 0; c0 < bn; c0 += BC) {
      for (int e = tid; e < TM * BC; e += THREADS) {
        const int i = e / BC, c = e % BC;
        float v = 0.f;
        if (m0 + i < m && c0 + c < bn)
          v = to_f32(x[(size_t)(m0 + i) * n + xcol + c0 + c]);
        xs[i][c] = v;
      }
      for (int e = tid; e < BC * TK; e += THREADS) {
        const int c = e / TK, j = e % TK;
        float v = 0.f;
        if (c0 + c < bn && j < tk) v = wblk[(size_t)(c0 + c) * bk + j];
        ws[c][j] = v;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < BC; ++c) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[ty + 16 * i][c];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ws[c][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  if constexpr (NAIVE) {
    // steps counts[kj] <= t < t_max, masked on the TPU: the block at the
    // clamped index is still read, as the TPU index maps fetch it, and no
    // FMA runs
    for (int t = cnt; t < t_max; ++t) {
      const int at = min(off + t, nnzb - 1);
      const size_t xcol = (size_t)row_ids[at] * bn;
      const float* wblk = blocks + (size_t)at * bn * bk + kb;
      for (int c0 = 0; c0 < bn; c0 += BC) {
        for (int e = tid; e < TM * BC; e += THREADS) {
          const int i = e / BC, c = e % BC;
          if (m0 + i < m && c0 + c < bn)
            xs[i][c] = to_f32(x[(size_t)(m0 + i) * n + xcol + c0 + c]);
        }
        for (int e = tid; e < BC * TK; e += THREADS) {
          const int c = e / TK, j = e % TK;
          if (c0 + c < bn && j < tk)
            ws[c][j] = wblk[(size_t)(c0 + c) * bk + j];
        }
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      if (col < tk) y[(size_t)row * k + k0 + col] = acc[i][j];
    }
  }
}

bool bad_shape(int m, int n, int k, int bn, int bk, int tk) {
  return m <= 0 || n <= 0 || k <= 0 || bn <= 0 || bk <= 0 || tk <= 0 ||
         tk > TK || bk % tk || k % bk || n % bn;
}

template <typename T, bool NAIVE>
int launch(const void* x, const void* blocks, const void* counts,
           const void* row_ids, const void* offsets, void* y, int m, int n,
           int k, int bn, int bk, int tk, int nnzb, int t_max, void* stream) {
  if (bad_shape(m, n, k, bn, bk, tk) || (NAIVE && (nnzb < 1 || t_max < 1)))
    return (int)cudaErrorInvalidValue;
  dim3 grid(k / tk, (m + TM - 1) / TM);
  bitmap_spmm_kernel<T, NAIVE><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)blocks, (const int*)counts,
      (const int*)row_ids, (const int*)offsets, (float*)y, m, n, k, bn, bk,
      tk, nnzb, t_max);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bitmap_spmm_f32(const void* x, const void* blocks,
                               const void* counts, const void* row_ids,
                               const void* offsets, void* y, int m, int n,
                               int k, int bn, int bk, int tk, void* stream) {
  return launch<float, false>(x, blocks, counts, row_ids, offsets, y, m, n,
                              k, bn, bk, tk, 0, 0, stream);
}

extern "C" int bitmap_spmm_bf16(const void* x, const void* blocks,
                                const void* counts, const void* row_ids,
                                const void* offsets, void* y, int m, int n,
                                int k, int bn, int bk, int tk, void* stream) {
  return launch<__nv_bfloat16, false>(x, blocks, counts, row_ids, offsets, y,
                                      m, n, k, bn, bk, tk, 0, 0, stream);
}

extern "C" int bitmap_spmm_naive_f32(const void* x, const void* blocks,
                                     const void* counts, const void* row_ids,
                                     const void* offsets, void* y, int m,
                                     int n, int k, int bn, int bk, int tk,
                                     int nnzb, int t_max, void* stream) {
  return launch<float, true>(x, blocks, counts, row_ids, offsets, y, m, n, k,
                             bn, bk, tk, nnzb, t_max, stream);
}

extern "C" int bitmap_spmm_naive_bf16(const void* x, const void* blocks,
                                      const void* counts, const void* row_ids,
                                      const void* offsets, void* y, int m,
                                      int n, int k, int bn, int bk, int tk,
                                      int nnzb, int t_max, void* stream) {
  return launch<__nv_bfloat16, true>(x, blocks, counts, row_ids, offsets, y,
                                     m, n, k, bn, bk, tk, nnzb, t_max,
                                     stream);
}
