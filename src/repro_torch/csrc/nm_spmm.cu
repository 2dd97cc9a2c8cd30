// N:M structured sparse matmul for Hopper (sm_90a): Y = X @ expand(V, I).
//
// Two entries, one per Pallas TPU kernel of src/repro/kernels/nm_spmm.py:
//   nm_spmm_{f32,bf16}        replaces `_pipelined_kernel` with
//                             `_decode_tile` (launched by
//                             `_nm_spmm_pipelined`, the default path of
//                             repro.kernels.ops.nm_spmm);
//   nm_spmm_naive_{f32,bf16}  replaces `_kernel` with `_decode_tile`
//                             (launched by `nm_spmm_pallas` with
//                             pipeline=False).
//
// Format: along N (the reduction dim) every group of m_group rows keeps
// n_sel values.  values (N*n_sel/m_group, K) fp32 and indices (same shape,
// int8, position in [0, m_group)) list them group by group.  x (M, N) is
// fp32 or bf16, converted to fp32 exactly; y (M, K) fp32.  Any
// n_sel:m_group with m_group <= 32 (plans serve 2:4 and 1:4).
//
// Design.  Each thread block owns one TM x TK output tile in registers
// (4 x 4 values per thread) and loops over the groups along N in runs of
// gc = 32 / m_group groups.  For each run it stages the x slice (TM rows x
// gc*m_group columns) and the (values, indices) rows of the run in shared
// memory, then decodes next to the FMA: a kept value at position p of
// group g multiplies x[row, g*m_group + p], read from shared memory.  The
// TPU kernel expands each tile to a dense operand by compares only to feed
// its matrix unit a dense tile; CUDA cores need no dense operand, so the
// port skips the zeros instead of multiplying them.  Out-of-range
// positions contribute nothing (as with the reference's compare-expand).
// No atomics: deterministic.
//
// The naive entry is the TPU naive kernel's design read for the card: the
// same output tiles and runs of gc groups (the TPU's N stripes), but each
// run's (values, indices) rows are EXPANDED into a dense shared-memory tile
// of gc*m_group rows by position compares -- dense[g*m + p][j] = sum over
// the group's n_sel entries of (index == p ? value : 0), the TPU
// `_decode_tile` -- and the tile is then multiplied densely, zeros
// included, in ascending n.  A kept value times x plus exact zeros gives
// the pipelined entry's sum bit for bit on finite inputs (indices are
// stored in ascending position order), as the reference pins its two TPU
// kernels equal.  Its cost is the TPU design's: m_group / n_sel times the
// FMAs (2x at 2:4, 4x at 1:4) plus the expansion.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s fp32 without tensor
// cores): bytes = values (4 B) + indices (1 B) per kept entry + x + y,
// against 2 * M * (kept entries) FLOPs -- the same useful work for both
// entries.  Decode (M = 4) is bound by the payload bytes; prefill
// (M = 512) by the fp32 FLOPs.
//
// What the simple design leaves on the table: the payload is re-streamed
// once per 64-row M tile, loads are scalar and synchronous, the indices
// travel as int8 instead of 2-bit fields, the data-dependent shared-memory
// reads of x can bank-conflict, and 2:4 in bf16 could run on the sparse
// tensor cores (mma.sp) after a repack of the indices at compress time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;        // output rows per thread block
constexpr int TK = 64;        // output columns per thread block
constexpr int XC = 32;        // x columns (and compressed rows) per run
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
nm_spmm_kernel(const T* __restrict__ x, const float* __restrict__ values,
               const int8_t* __restrict__ indices, float* __restrict__ y,
               int m, int n, int k, int n_sel, int m_group) {
  __shared__ float xs[TM][XC + 1];
  __shared__ float vs[XC][TK];
  __shared__ int8_t is[XC][TK];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * TK;
  const int m0 = blockIdx.y * TM;
  const int groups = n / m_group;
  const int gc = XC / m_group;             // groups per staged run

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int g0 = 0; g0 < groups; g0 += gc) {
    const int gcur = min(gc, groups - g0);
    const int xw = gcur * m_group;         // x columns of this run
    const int vr = gcur * n_sel;           // compressed rows of this run
    const size_t xbase = (size_t)g0 * m_group;
    const size_t vbase = (size_t)g0 * n_sel;
    for (int e = tid; e < TM * XC; e += THREADS) {
      const int i = e / XC, c = e % XC;
      float v = 0.f;
      if (m0 + i < m && c < xw) v = to_f32(x[(size_t)(m0 + i) * n + xbase + c]);
      xs[i][c] = v;
    }
    for (int e = tid; e < XC * TK; e += THREADS) {
      const int q = e / TK, j = e % TK;
      float v = 0.f;
      int8_t p = 0;
      if (q < vr && k0 + j < k) {
        const size_t at = (vbase + q) * (size_t)k + k0 + j;
        v = values[at];
        p = indices[at];
      }
      vs[q][j] = v;
      is[q][j] = p;
    }
    __syncthreads();
    for (int q = 0; q < vr; ++q) {
      const int base = (q / n_sel) * m_group;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = is[q][tx + 16 * j];
        const bool ok = (unsigned)p < (unsigned)m_group;
        const float b = ok ? vs[q][tx + 16 * j] : 0.f;
        const int col = ok ? base + p : 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[i][j] = fmaf(xs[ty + 16 * i][col], b, acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      if (col < k) y[(size_t)row * k + col] = acc[i][j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
nm_spmm_naive_kernel(const T* __restrict__ x,
                     const float* __restrict__ values,
                     const int8_t* __restrict__ indices,
                     float* __restrict__ y, int m, int n, int k, int n_sel,
                     int m_group) {
  __shared__ float xs[TM][XC + 1];
  __shared__ float vs[XC][TK];
  __shared__ int8_t is[XC][TK];
  __shared__ float ws[XC][TK];             // the run's expanded dense tile
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * TK;
  const int m0 = blockIdx.y * TM;
  const int groups = n / m_group;
  const int gc = XC / m_group;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int g0 = 0; g0 < groups; g0 += gc) {
    const int gcur = min(gc, groups - g0);
    const int xw = gcur * m_group;
    const int vr = gcur * n_sel;
    const size_t xbase = (size_t)g0 * m_group;
    const size_t vbase = (size_t)g0 * n_sel;
    for (int e = tid; e < TM * XC; e += THREADS) {
      const int i = e / XC, c = e % XC;
      float v = 0.f;
      if (m0 + i < m && c < xw) v = to_f32(x[(size_t)(m0 + i) * n + xbase + c]);
      xs[i][c] = v;
    }
    for (int e = tid; e < XC * TK; e += THREADS) {
      const int q = e / TK, j = e % TK;
      float v = 0.f;
      int8_t p = 0;
      if (q < vr && k0 + j < k) {
        const size_t at = (vbase + q) * (size_t)k + k0 + j;
        v = values[at];
        p = indices[at];
      }
      vs[q][j] = v;
      is[q][j] = p;
    }
    __syncthreads();
    // _decode_tile: dense[g*m + p][j] = sum_s (index == p) * value
    for (int e = tid; e < XC * TK; e += THREADS) {
      const int r = e / TK, j = e % TK;
      float w = 0.f;
      if (r < xw) {
        const int g = r / m_group, p = r - g * m_group;
        for (int s = 0; s < n_sel; ++s) {
          const int q = g * n_sel + s;
          w += is[q][j] == p ? vs[q][j] : 0.f;
        }
      }
      ws[r][j] = w;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < xw; ++c) {           // ascending n, zeros included
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      if (col < k) y[(size_t)row * k + col] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* x, const void* values, const void* indices, void* y,
           int m, int n, int k, int n_sel, int m_group, bool naive,
           void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || m_group < 1 || m_group > XC ||
      n_sel < 1 || n_sel > m_group || n % m_group)
    return (int)cudaErrorInvalidValue;
  dim3 grid((k + TK - 1) / TK, (m + TM - 1) / TM);
  if (naive)
    nm_spmm_naive_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)x, (const float*)values, (const int8_t*)indices, (float*)y,
        m, n, k, n_sel, m_group);
  else
    nm_spmm_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const T*)x, (const float*)values, (const int8_t*)indices, (float*)y,
        m, n, k, n_sel, m_group);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nm_spmm_f32(const void* x, const void* values,
                           const void* indices, void* y, int m, int n, int k,
                           int n_sel, int m_group, void* stream) {
  return launch<float>(x, values, indices, y, m, n, k, n_sel, m_group, false,
                       stream);
}

extern "C" int nm_spmm_bf16(const void* x, const void* values,
                            const void* indices, void* y, int m, int n,
                            int k, int n_sel, int m_group, void* stream) {
  return launch<__nv_bfloat16>(x, values, indices, y, m, n, k, n_sel,
                               m_group, false, stream);
}

extern "C" int nm_spmm_naive_f32(const void* x, const void* values,
                                 const void* indices, void* y, int m, int n,
                                 int k, int n_sel, int m_group,
                                 void* stream) {
  return launch<float>(x, values, indices, y, m, n, k, n_sel, m_group, true,
                       stream);
}

extern "C" int nm_spmm_naive_bf16(const void* x, const void* values,
                                  const void* indices, void* y, int m, int n,
                                  int k, int n_sel, int m_group,
                                  void* stream) {
  return launch<__nv_bfloat16>(x, values, indices, y, m, n, k, n_sel,
                               m_group, true, stream);
}
