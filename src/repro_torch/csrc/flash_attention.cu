// Flash attention forward for Hopper (sm_90a): O = softmax(Q K^T / sqrt(D)) V.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py,
// `_kernel` (launched by `flash_attention_pallas`, the kernel behind
// repro.kernels.ops.flash_attention).
//
// Operands: q (BH, Sq, D), k / v (BH, Skv, D), all fp32 or all bf16,
// contiguous, batch and heads flattened (a GQA repeat is the caller's);
// o (BH, Sq, D) in q's type.  Semantics are the TPU kernel's:
//   * scores s = (q . k) * (1/sqrt(D)) accumulated in fp32;
//   * causal mask aligned TOP-LEFT: key j visible to query i iff j <= i;
//     masked scores are NEG_INF = -1e30 (finite, not -inf);
//   * online softmax with running max m, running sum l (fp32, of the
//     unrounded p) and accumulator acc (fp32): p = exp(s - m_new),
//     corr = exp(m - m_new), l = l*corr + sum p, acc = acc*corr + P V;
//   * P is rounded to v's type before the PV product (a no-op for fp32);
//   * o = acc / max(l, 1e-30), rounded to q's type.
//
// Design (simple and correct first).  One thread block of 256 threads per
// (bh, 64-row query tile).  The query tile stays in shared memory (fp32,
// rows padded by one word so the column reads of the score product do not
// conflict); the KV axis streams through one shared tile of 64 keys that
// holds K for the score product and is then overwritten with V for the PV
// product, which keeps the footprint at 83 KB for D = 128 (dynamic shared
// memory, set with cudaFuncSetAttribute) so two blocks fit on an SM.  Each
// thread owns 4 query rows (ty + 16 i) x 4 key columns of the score tile
// and the same 4 rows x ceil(D/16) columns of the accumulator, so the
// running (m, l) of its rows live in its registers; row max and row sum
// reduce over the 16 lanes of a half-warp with shuffles.  With the causal
// mask the KV loop stops at the tile holding the query tile's last row:
// tiles wholly above the diagonal are skipped, as the TPU kernel skips
// them.  Ragged Sq / Skv edges are masked, so any lengths work; the TPU
// wrapper's divisibility rule on its own tiles is checked by the Python
// wrapper only to accept the same calls.  D <= 256.
//
// Bound on an H100 SXM: bytes = q + k + v + o, each once, over 3.35 TB/s,
// against 4 * BH * Sq * Skv * D FLOPs (two products), halved when causal,
// over 989 TFLOP/s for bf16 inputs (tensor cores) or 67 TFLOP/s for fp32.
// Every shape served here is bound by the FLOPs.  This kernel computes in
// fp32 FMAs on CUDA cores for both types, so for bf16 it cannot come
// within ~15x of the tensor-core bound: mma.sync / wgmma on bf16 tiles,
// cp.async or TMA double-buffering of the KV tiles and larger query tiles
// per SM are the later steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per thread block
constexpr int BKV = 64;       // keys per KV tile
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
// P in v's type: rounding to bf16 for bf16 operands, nothing for fp32
__device__ __forceinline__ float round_p(float p, float) { return p; }
__device__ __forceinline__ float round_p(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(p));
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// DJ: accumulator columns per thread; the kernel takes D <= 16 * DJ.
template <int DJ>
__host__ __device__ constexpr int row_words() { return 16 * DJ + 1; }

template <int DJ>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)(BQ + BKV) * row_words<DJ>() +
                          (size_t)BQ * (BKV + 1));
}

// Stage rows [r0, r0 + nrows) of a (rows, d) matrix into dst (nrows x LD),
// zero-filling rows past `rows` and columns past d.
template <typename T, int DJ>
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const T* __restrict__ src, int r0,
                                      int nrows, int rows, int d) {
  constexpr int DP = 16 * DJ, LD = row_words<DJ>();
  for (int e = threadIdx.x; e < nrows * DP; e += THREADS) {
    const int r = e / DP, c = e % DP;
    float v = 0.f;
    if (r0 + r < rows && c < d) v = to_f32(src[(size_t)(r0 + r) * d + c]);
    dst[r * LD + c] = v;
  }
}

template <typename T, int DJ>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int sq,
                       int skv, int d, float scale, int causal) {
  constexpr int LD = row_words<DJ>();
  extern __shared__ float smem[];
  float* qs = smem;                        // BQ x LD
  float* kvs = qs + BQ * LD;               // BKV x LD: K, then V
  float* ps = kvs + BKV * LD;              // BQ x (BKV + 1)
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const size_t bh = blockIdx.y;
  const T* qb = q + bh * sq * d;
  const T* kb = k + bh * skv * d;
  const T* vb = v + bh * skv * d;

  stage<T, DJ>(qs, qb, q0, BQ, sq, d);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // causal: keys past the tile's last query row are masked for every row
  const int kv_end = causal ? min(skv, q0 + BQ) : skv;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();                       // previous PV done with kvs / ps
    stage<T, DJ>(kvs, kb, kv0, BKV, skv, d);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = kvs[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = kv0 + tx + 16 * j;
        float sv = s[i][j] * scale;
        if (kpos >= skv || (causal && kpos > qpos)) sv = NEG_INF;
        s[i][j] = sv;
        mx = fmaxf(mx, sv);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[(ty + 16 * i) * (BKV + 1) + tx + 16 * j] = round_p(p, T());
      }
      l[i] = l[i] * corr + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();                       // scores done with K; P written
    stage<T, DJ>(kvs, vb, kv0, BKV, skv, d);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * (BKV + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = kvs[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

  T* ob = o + bh * sq * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = tx + 16 * j;
      if (col < d) store(&ob[(size_t)row * d + col], acc[i][j] / den);
    }
  }
}

template <typename T, int DJ>
int launch_dj(const void* q, const void* k, const void* v, void* o, int bh,
              int sq, int skv, int d, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<DJ>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = (float)(1.0 / sqrt((double)d));
  dim3 grid((sq + BQ - 1) / BQ, bh);
  flash_attention_kernel<T, DJ><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, skv, d, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int sq, int skv, int d, int causal, void* stream) {
  if (bh <= 0 || bh > 65535 || sq <= 0 || skv <= 0 || d <= 0 || d > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= 32) return launch_dj<T, 2>(q, k, v, o, bh, sq, skv, d, causal, s);
  if (d <= 64) return launch_dj<T, 4>(q, k, v, o, bh, sq, skv, d, causal, s);
  if (d <= 128) return launch_dj<T, 8>(q, k, v, o, bh, sq, skv, d, causal, s);
  return launch_dj<T, 16>(q, k, v, o, bh, sq, skv, d, causal, s);
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int bh, int sq,
                                   int skv, int d, int causal, void* stream) {
  return launch<float>(q, k, v, o, bh, sq, skv, d, causal, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int bh, int sq,
                                    int skv, int d, int causal,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, bh, sq, skv, d, causal, stream);
}
