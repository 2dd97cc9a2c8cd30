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
// Bound on an H100 SXM: bytes = q + k + v + o, each once, over 3.35 TB/s,
// against 4 * BH * Sq * Skv * D FLOPs (two products), halved when causal,
// over 989 TFLOP/s for bf16 inputs (tensor cores) or 67 TFLOP/s for fp32.
// A query row does 4 Skv D operations on 8 D bytes of its own, so every
// shape served here is bound by the operations.  Two entries; the Python
// wrapper picks one on the host (kernels/flash_attention.py::select_entry).
//
// Tensor-core entry, flash_attention_bf16_tc: bf16 operands with D = 64 or
// 128, every base 16-byte aligned.  Its bound is the tensor cores' 989
// TFLOP/s, reached only by wgmma, and the design keeps them fed:
//   * one block per (bh, 128-row query tile), 1-D grid: the bh in groups
//     whose K and V fit in 24 MB of L2, so a group's query tiles read them
//     from L2; within a group the heaviest (causal: last) tiles first;
//   * three warpgroups.  A producer (setmaxnreg 40) has one thread stream
//     128-key K and V tiles with TMA into a two-stage ring in shared
//     memory, bf16, 64-column panels with the 128-byte swizzle, against
//     full / empty mbarriers, K and V in separate buffers.  Two consumers
//     (setmaxnreg 232) own 64 query rows each;
//   * S = Q K^T is wgmma m64n128k16 with Q and K read from shared memory
//     (K-major descriptors) into fp32 accumulators; the softmax runs on the
//     accumulator fragments (row max by quad shuffles, the row sum kept per
//     thread), exp as ex2 of one FFMA with 1/sqrt(D) log2(e) folded in;
//   * P is rounded to bf16 once, against the running max, and packed from
//     the accumulator fragments into the A fragments of P V: wgmma
//     m64nDk16 with A from registers and V as the MN-major B operand.
//     P never leaves the registers;
//   * S of tile j is issued with P V of tile j - 1, which runs during the
//     softmax of tile j, and the two consumers take turns to issue (named
//     barriers), so one's softmax overlaps the other's products;
//   * causal: the tile loop stops at the query tile's last row; only the
//     tiles that cross the diagonal or the end of the keys are masked.
//     TMA reads rows past Sq / Skv as zeros; stores past Sq are masked.
// 160 KB of shared memory at D = 128: one block an SM.
//
// FMA entry, flash_attention_f32 / flash_attention_bf16: every other call
// (fp32 operands, where tensor-core TF32 would break the 1e-4 bound; bf16
// with another D or unaligned operands).  Both products are dense fp32
// products on the CUDA cores, 67 TFLOP/s at most; a warp's 16-byte shared
// load costs the SM about 4 cycles (tools/lds_bench.cu), in which it can
// issue 16 warp-FFMAs, so each loaded value has to feed several FFMAs:
//   * one block of TY x TX threads per (bh, BQ-row query tile), on the
//     tensor-core entry's 1-D grid and order: the bh in groups whose K and
//     V stay in L2, the heaviest (causal: last) query tiles first;
//   * Q (once per block) and each BKV-key tile of K are staged as fp32
//     panels of 4 columns (element (r, c) of an R-row tile at
//     (c / 4) 4R + 4r + c % 4), V row-major: every operand of both products
//     is read as 16-byte loads of 4 consecutive values, and a 16-byte copy
//     from a row lands in 16 contiguous bytes, so nothing is transposed and
//     the copies meet no bank conflict;
//   * register-blocked outer products: thread (ty, tx) owns query rows
//     ty + TY i (i < RM) x keys tx + TX j (j < RS) of the score tile (a
//     4-column panel step: RM + RS loads for 4 RM RS FFMAs) and the same
//     rows x 4-column chunks tx + TX g (g < RC) of the accumulator (a 4-key
//     step of P V: RM + 4 RC loads for 16 RM RC FFMAs), so the running
//     (m, l) of its rows live in its registers; the row max reduces over
//     the TX lanes of a row by shuffles, the row sum once at the end;
//   * P (rounded to v's type) goes through shared memory in passes of PH
//     keys, its rows padded by 4 floats;
//   * K / V copies overlap the products, fp32 by cp.async (16-byte copies
//     where D % 4 == 0 and the operands are 16-byte aligned, else 4-byte
//     ones), bf16 by register loads issued before the products and widened
//     to fp32 into shared memory after them (no inner loop widens): either
//     a two-stage ring (tile j + 1 copied while tile j is multiplied) or
//     one K and one V buffer copied in turn (K of tile j + 1 during tile
//     j's softmax and P V, V during tile j + 1's score product);
//   * p = 2^(s * scale * log2 e - m): one FFMA and ex2 against the running
//     max m in log2 units;
//   * causal: the tile loop stops at the query tile's last row; only tiles
//     that cross the diagonal or the end of the keys are masked.  Rows past
//     Sq / Skv and columns past D are staged as zeros.
// One tile per class of D (<= 32, 64, 128, 256) and operand type
// (fma_entry::F32Tile32 ... Bf16Tile256).  fp32 at D <= 128: 128 x 128
// tiles, 16 x 16 threads (8 x 8 scores and 8 x 8 outputs a thread), one K
// and one V buffer, P V in two passes of 64 keys, 226 KB of shared memory,
// one block an SM.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
// P in v's type: rounding to bf16 for bf16 operands, nothing for fp32
__device__ __forceinline__ float round_p(float p, float) { return p; }
__device__ __forceinline__ float round_p(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(p));
}

}  // namespace

// ---------------------------------------------------------------------------
// Tensor-core entry: bf16 operands, D in {64, 128}
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BQ = 128;        // query rows of a block: two warpgroups of 64
constexpr int BKV = 128;       // keys of a K / V tile
constexpr int STAGES = 2;      // K / V ring depth
constexpr int THREADS = 384;   // producer warpgroup + two consumer ones
// registers a thread of the producer / consumer warpgroups keeps
// (setmaxnreg; 128 x 40 + 256 x 232 of the SM's 65,536)
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

template <int D>
struct Cfg {
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;   // one stage of K or V
  // tiles from a 1024-byte boundary (the swizzle's period), then the
  // mbarriers
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 1024 + 128;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Block blockIdx.x of the 1-D grid -> (query tile, bh).  The bh are taken
// in groups of `group`, whose K and V stay in L2 while all their query
// tiles run; within a group the query tiles go from the last to the first,
// the heaviest under the causal mask first.
__device__ __forceinline__ void block_tile(int n_qtiles, int n_bh, int group,
                                           int& qt, int& bh) {
  const int b = blockIdx.x, per = group * n_qtiles;
  const int first = b / per * group, r = b % per;
  const int size = min(group, n_bh - first);
  qt = n_qtiles - 1 - r / size;
  bh = first + r % size;
}

// bh per group: as many as keep their K and V within 24 MB of the 50 MB L2
inline int bh_group(int bh, int skv, int d) {
  const long long kv = 4ll * skv * d;            // K and V of one bh, bf16
  return (int)std::max(1ll, std::min<long long>(bh, (24ll << 20) / kv));
}

// "+f" operands of a wgmma accumulator d[]
#define D_OUT4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define D_OUT16(i) D_OUT4(i), D_OUT4(i + 4), D_OUT4(i + 8), D_OUT4(i + 12)
#define D_OUT32 D_OUT16(0), D_OUT16(16)
#define D_OUT64 D_OUT16(0), D_OUT16(16), D_OUT16(32), D_OUT16(48)

// d (64 x 128, fp32) += A (64 x 16) B (16 x 128), A and B in shared memory,
// both K-major (descriptors)
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : D_OUT64
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 fragments in registers) B (16 x
// 64), B in shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D_OUT32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// d (64 x 128, fp32) += A (64 x 16, bf16 fragments in registers) B (16 x
// 128), B in shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : D_OUT64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// pins registers that a wgmma reads or writes: plain code that touches
// them is not moved across the wgmma or its wait
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// named barriers 1 and 2: the consumer warpgroups' turns to issue
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
// one box (64 columns x rows) of a (BH, S, D) bf16 tensor into a 128-byte
// swizzled panel; rows past S arrive as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(map), "r"(col), "r"(row), "r"(bh), "r"(bar)
      : "memory");
}

// One consumer warpgroup's share of a tile, on its wgmma fragments:
// s[4 j + 2 h + e] is row row_t + 8 h, key kv0 + 8 j + 2 t + e, and acc
// the same with column 8 j + 2 t + e.  Shared-memory tiles are panels of
// 64 columns (128-byte rows, the 16-byte chunk c of row r at c ^ (r % 8)),
// as TMA writes them with the 128-byte swizzle.
template <int D>
struct Tile {
  static constexpr int NS = BKV / 2, NA = BKV / 16, NO = D / 2;

  // S = Q K^T, issued, not waited for: both operands K-major, a 16-column
  // step moves 32 bytes along the row
  static __device__ __forceinline__ void issue_s(float* s, uint32_t q,
                                                 uint32_t k) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t step = (kk % 4) * 32;
      wgmma_ss_n128(s, smem_desc(q + (kk / 4) * (BQ * 128) + step, 16, 1024),
                    smem_desc(k + (kk / 4) * (BKV * 128) + step, 16, 1024),
                    1);
    }
  }
  // O += P V, issued: V is the MN-major B operand, its 64-column panels
  // BKV * 128 bytes apart
  static __device__ __forceinline__ void issue_pv(float* acc,
                                                  uint32_t (*a)[4],
                                                  uint32_t v) {
#pragma unroll
    for (int kk = 0; kk < NA; ++kk) {
      const uint64_t desc = smem_desc(v + kk * (16 * 128), BKV * 128, 1024);
      if constexpr (D == 64)
        wgmma_rs_n64(acc, a[kk], desc, 1);
      else
        wgmma_rs_n128(acc, a[kk], desc, 1);
    }
  }
  // masks the keys past skv and, causal, past each row (only tiles that
  // cross the diagonal or the end of the keys); then the online softmax:
  // p = 2^(s * scale * log2 e - m) in s, the running sum l of the
  // unrounded p, and corr, which rescales the accumulator
  static __device__ __forceinline__ void softmax(float* s, float* m,
                                                 float* l, float* corr,
                                                 int kv0, int skv, int causal,
                                                 int row_lo, int row_t, int t,
                                                 float scale_log2) {
    if (kv0 + BKV > skv || (causal && kv0 + BKV - 1 > row_lo)) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int kpos = kv0 + 8 * (i / 4) + 2 * t + (i & 1);
        const int qpos = row_t + 8 * ((i / 2) & 1);
        if (kpos >= skv || (causal && kpos > qpos)) s[i] = NEG_INF;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx * scale_log2);
      corr[h] = ex2(m[h] - m_new);
      m[h] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          s[i] = ex2(fmaf(s[i], scale_log2, -m_new));
          rs += s[i];
        }
      l[h] = l[h] * corr[h] + rs;
    }
  }
  // P rounded to bf16 once, from the accumulator fragments straight into
  // the A fragments of P V (a 16 x 8 pair's C layout is the A layout)
  static __device__ __forceinline__ void pack(const float* s,
                                              uint32_t (*a)[4]) {
#pragma unroll
    for (int kk = 0; kk < NA; ++kk) {
      a[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  }
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          __nv_bfloat16* __restrict__ o, int sq, int skv,
                          float scale_log2, int causal, int n_qtiles,
                          int n_bh, int group) {
  using C = Cfg<D>;
  using T = Tile<D>;
  constexpr int PANELS = D / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t qs = base, ks = qs + C::Q_BYTES,
                 vs = ks + STAGES * C::KV_BYTES;
  const uint32_t bars = vs + STAGES * C::KV_BYTES;
  // full_q, then per stage: full_k, full_v, empty_k, empty_v
  const uint32_t full_q = bars;
  auto full_k = [&](int st) { return bars + 8 + 32 * st; };
  auto full_v = [&](int st) { return bars + 16 + 32 * st; };
  auto empty_k = [&](int st) { return bars + 24 + 32 * st; };
  auto empty_v = [&](int st) { return bars + 32 + 32 * st; };
  int qt, bh;
  block_tile(n_qtiles, n_bh, group, qt, bh);
  const int q0 = qt * BQ;
  // causal: the tiles past the query tile's last row are skipped; with
  // BQ == BKV none of the others lies wholly above a warpgroup's rows
  const int kv_end = causal ? min(skv, q0 + BQ) : skv;
  const int n_tiles = (kv_end + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty_k(st), 256);
      mbar_init(empty_v(st), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {                  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        PRODUCER_REGS));
    if (threadIdx.x == 256) {
      mbar_expect_tx(full_q, C::Q_BYTES);
      for (int p = 0; p < PANELS; ++p)
        tma_load(qs + p * (BQ * 128), &tm_q, full_q, 64 * p, q0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES, use = it / STAGES;
        if (it >= STAGES) mbar_wait(empty_k(st), (use - 1) & 1);
        mbar_expect_tx(full_k(st), C::KV_BYTES);
        for (int p = 0; p < PANELS; ++p)
          tma_load(ks + st * C::KV_BYTES + p * (BKV * 128), &tm_k, full_k(st),
                   64 * p, it * BKV, bh);
        if (it >= STAGES) mbar_wait(empty_v(st), (use - 1) & 1);
        mbar_expect_tx(full_v(st), C::KV_BYTES);
        for (int p = 0; p < PANELS; ++p)
          tma_load(vs + st * C::KV_BYTES + p * (BKV * 128), &tm_v, full_v(st),
                   64 * p, it * BKV, bh);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      CONSUMER_REGS));
  const int wg = threadIdx.x / 128, w = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row_lo = q0 + 64 * wg;               // this warpgroup's rows
  const int row_t = row_lo + 16 * w + g;         // this thread's (and + 8)
  const uint32_t q_wg = qs + wg * (64 * 128);    // its Q rows in each panel
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, corr[2];
  float acc[T::NO], s[T::NS];
  uint32_t a[T::NA][4];
#pragma unroll
  for (int i = 0; i < T::NO; ++i) acc[i] = 0.f;
  mbar_wait(full_q, 0);

  // S of tile it is issued together with P V of tile it - 1, whose product
  // runs while this warpgroup takes the softmax of tile it; the two
  // warpgroups take turns to issue (named barrier 1 + wg is this one's
  // turn), so one's softmax overlaps the other's products.  No branch lies
  // between a wgmma and its wait: ptxas serialises the wgmmas otherwise.
  if (wg == 1) named_arrive(1);                  // warpgroup 0 goes first
#pragma unroll
  for (int i = 0; i < T::NS; ++i) s[i] = 0.f;
  mbar_wait(full_k(0), 0);
  fence_regs<T::NS>(s);
  named_sync(1 + wg);
  wgmma_fence();
  T::issue_s(s, q_wg, ks);
  wgmma_commit();
  named_arrive(2 - wg);
  wgmma_wait_all();
  fence_regs<T::NS>(s);
  mbar_arrive(empty_k(0));
  T::softmax(s, m, l, corr, 0, skv, causal, row_lo, row_t, t, scale_log2);
  T::pack(s, a);
  for (int it = 1; it < n_tiles; ++it) {
    const int st = it % STAGES, ph = (it / STAGES) & 1;
    const int pst = (it - 1) % STAGES, pph = ((it - 1) / STAGES) & 1;
#pragma unroll
    for (int i = 0; i < T::NS; ++i) s[i] = 0.f;
    mbar_wait(full_k(st), ph);
    mbar_wait(full_v(pst), pph);
    fence_regs<T::NS>(s);
    fence_regs<T::NO>(acc);
    named_sync(1 + wg);
    wgmma_fence();
    T::issue_s(s, q_wg, ks + st * C::KV_BYTES);
    wgmma_commit();
    T::issue_pv(acc, a, vs + pst * C::KV_BYTES);
    wgmma_commit();
    named_arrive(2 - wg);
    wgmma_wait_one();                            // S of tile it
    fence_regs<T::NS>(s);
    mbar_arrive(empty_k(st));
    T::softmax(s, m, l, corr, it * BKV, skv, causal, row_lo, row_t, t,
               scale_log2);
    wgmma_wait_all();                            // P V of tile it - 1
    fence_regs<T::NO>(acc);
    fence_regs<4 * T::NA>(&a[0][0]);
    mbar_arrive(empty_v(pst));
#pragma unroll
    for (int i = 0; i < T::NO; ++i) acc[i] *= corr[(i / 2) & 1];
    T::pack(s, a);
  }
  const int st = (n_tiles - 1) % STAGES;
  mbar_wait(full_v(st), ((n_tiles - 1) / STAGES) & 1);
  fence_regs<T::NO>(acc);
  wgmma_fence();
  T::issue_pv(acc, a, vs + st * C::KV_BYTES);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs<T::NO>(acc);
  if (wg == 0) named_sync(1);        // warpgroup 1's last turn, unwaited

  __nv_bfloat16* ob = o + (size_t)bh * sq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float den = fmaxf(sum, 1e-30f);
    const int row = row_t + 8 * h;
    if (row >= sq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * D + 8 * j +
                                         2 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] / den,
                                acc[4 * j + 2 * h + 1] / den);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found once through the runtime (no
// link against libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = (EncodeTiled)p;
  }
  return fn;
}

// (BH, rows, D) bf16 as a 3-D tensor map of boxes (64 columns, box_rows, 1)
// with the 128-byte swizzle; out-of-range rows read as zeros
int make_map(CUtensorMap* map, const void* ptr, int bh, int rows, int d,
             int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                      const_cast<void*>(ptr), dims, strides, box, elem,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int sq, int skv, int causal, cudaStream_t stream) {
  const int n_qtiles = (sq + BQ - 1) / BQ;
  if ((long long)n_qtiles * bh > 0x7fffffff) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, bh, sq, D, BQ);
  if (!err) err = make_map(&tk, k, bh, skv, D, BKV);
  if (!err) err = make_map(&tv, v, bh, skv, D, BKV);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_tc_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::SMEM);
  if (e != cudaSuccess) return (int)e;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  flash_attention_tc_kernel<D><<<n_qtiles * bh, THREADS, Cfg<D>::SMEM,
                                 stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, sq, skv, scale_log2, causal, n_qtiles,
      bh, bh_group(bh, skv, D));
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// FMA entry: fp32 operands, and bf16 off the tensor-core shapes
// ---------------------------------------------------------------------------

namespace fma_entry {

constexpr bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

// A block's tiles: BQ query rows x BKV keys a KV tile, TY x TX threads, the
// head dimension padded to DP, STAGES of K and V, P in passes of PH keys,
// MIN_BLOCKS a SM for the register cap.  A thread owns RM rows x RS keys of
// the score tile and RM rows x RC 4-column chunks of the accumulator.
// STAGES = 2: a ring, tile j + 1's K and V copied while tile j is
// multiplied.  STAGES = 1: one K and one V buffer, each copied while the
// other is read: K of tile j + 1 during tile j's softmax and P V, V of
// tile j + 1 during tile j + 1's score product.
template <int BQ_, int BKV_, int TY_, int TX_, int DP_, int STAGES_, int PH_,
          int MIN_BLOCKS_>
struct FTile {
  static constexpr int BQ = BQ_, BKV = BKV_, TY = TY_, TX = TX_, DP = DP_;
  static constexpr int STAGES = STAGES_, PH = PH_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int NT = TY * TX, RM = BQ / TY, RS = BKV / TX;
  static constexpr int RC = DP / (4 * TX);
  // P rows padded by 4 floats: the rows of a warp's lanes fall in other
  // banks
  static constexpr int LDP = PH + 4;
  // floats: Q, then STAGES K tiles, STAGES V tiles, then P
  static constexpr int Q_F = BQ * DP, KV_F = BKV * DP;
  static constexpr int SMEM = 4 * (Q_F + 2 * STAGES * KV_F + BQ * LDP);

  static_assert(pow2(BQ) && pow2(BKV) && pow2(DP) && pow2(TY) && pow2(TX),
                "tile sizes are powers of two (staging indexes by shifts)");
  static_assert(TX <= 32 && RM >= 1 && RS >= 1 && RC >= 1,
                "a row's TX lanes lie in one warp; every thread owns work");
  static_assert(BKV % PH == 0 && PH % TX == 0 && PH % 4 == 0,
                "P passes of whole 4-key steps, the same keys each thread");
  static_assert(KV_F % (8 * NT) == 0 && Q_F % (8 * NT) == 0,
                "every thread copies whole 16-byte pieces and bf16 pairs");
  static_assert(STAGES == 1 || STAGES == 2, "one or two stages");
  static_assert(SMEM <= 232448, "at most 227 KB of shared memory a block");
};

// The tile of each class of D, per operand type, as tools/flash_sweep.py
// chose them.  bf16 keeps the next tile in registers, so its larger tiles
// take the ring: 128 x 128 and 64 x 64 with one stage spill there.
using F32Tile32 = FTile<128, 64, 16, 8, 32, 2, 64, 2>;
using F32Tile64 = FTile<128, 64, 16, 16, 64, 2, 64, 1>;
using F32Tile128 = FTile<128, 128, 16, 16, 128, 1, 64, 1>;
using F32Tile256 = FTile<64, 64, 16, 16, 256, 1, 64, 1>;
using Bf16Tile32 = FTile<128, 64, 16, 8, 32, 2, 64, 2>;
using Bf16Tile64 = FTile<128, 64, 16, 16, 64, 2, 64, 1>;
using Bf16Tile128 = FTile<128, 64, 16, 16, 128, 2, 64, 1>;
using Bf16Tile256 = FTile<64, 32, 16, 16, 256, 2, 32, 1>;

// 16 / 4 bytes global -> shared without a register; fewer `bytes` fill
// zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Row r and column c of float e of a staged R x DP tile: Q and K as DP / 4
// panels of R rows x 4 columns (PANELS), V row-major.  R and DP are powers
// of two, so these are shifts and masks.
template <int R, int DP, bool PANELS>
__device__ __forceinline__ void coords(unsigned e, int& r, int& c) {
  if constexpr (PANELS) {
    r = (int)(e / 4 % R);
    c = (int)(e / (4 * R) * 4 + e % 4);
  } else {
    r = (int)(e / DP);
    c = (int)(e % DP);
  }
}

// fp32: rows [r0, r0 + R) of a (rows, d) matrix into an R x DP tile by
// cp.async, 16-byte copies if `vec` (d % 4 == 0, 16-byte aligned), else
// 4-byte ones; rows past `rows` and columns past d are zeros.
template <int R, int DP, bool PANELS, int NT>
__device__ __forceinline__ void stage_async(float* dst, const float* src,
                                            int r0, int rows, int d,
                                            bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < R * DP / (4 * NT); ++i) {
      const unsigned e = 4 * (threadIdx.x + NT * i);
      int r, c;
      coords<R, DP, PANELS>(e, r, c);
      const bool in = r0 + r < rows && c < d;
      cp_async16(dst + e, in ? src + (size_t)(r0 + r) * d + c : src,
                 in ? 16 : 0);
    }
  } else {
#pragma unroll 8
    for (int i = 0; i < R * DP / NT; ++i) {
      const unsigned e = threadIdx.x + NT * i;
      int r, c;
      coords<R, DP, PANELS>(e, r, c);
      const bool in = r0 + r < rows && c < d;
      cp_async4(dst + e, in ? src + (size_t)(r0 + r) * d + c : src,
                in ? 4 : 0);
    }
  }
}

// bf16: the same tile through registers.  load() reads a thread's share
// 2 bytes at a time (any alignment) into bf16 pairs; store() widens it to
// fp32 into shared memory.  A tile loaded before the products and stored
// after them is copied while they run.
template <int R, int DP, bool PANELS, int NT>
struct Bf16Stage {
  static constexpr int N = R * DP / NT;   // values a thread copies
  uint32_t w[N / 2];

  __device__ __forceinline__ void load(const __nv_bfloat16* src, int r0,
                                       int rows, int d) {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      int r, c;
      coords<R, DP, PANELS>(threadIdx.x + NT * i, r, c);
      const uint32_t h =
          r0 + r < rows && c < d ? s[(size_t)(r0 + r) * d + c] : 0u;
      w[i / 2] = i % 2 ? w[i / 2] | h << 16 : h;
    }
  }
  __device__ __forceinline__ void store(float* dst) const {
#pragma unroll
    for (int i = 0; i < N; ++i)
      dst[threadIdx.x + NT * i] =
          __uint_as_float(i % 2 ? w[i / 2] & 0xffff0000u : w[i / 2] << 16);
  }
};

// One block: query tile qt of bh (tc::block_tile's order).  `vec`: fp32
// operands staged by 16-byte copies.
template <class C, typename T>
__global__ void __launch_bounds__(C::NT, C::MIN_BLOCKS)
flash_attention_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int sq, int skv, int d, float scale_log2,
                           int causal, int vec, int n_qtiles, int n_bh,
                           int group) {
  constexpr int BQ = C::BQ, BKV = C::BKV, TY = C::TY, TX = C::TX;
  constexpr int RM = C::RM, RS = C::RS, RC = C::RC, DP = C::DP, NT = C::NT;
  constexpr int PH = C::PH, LDP = C::LDP, KV_F = C::KV_F;
  constexpr bool F32 = std::is_same_v<T, float>, RING = C::STAGES == 2;
  extern __shared__ float4 smem4[];
  float* const qs = reinterpret_cast<float*>(smem4);
  float* const ks = qs + C::Q_F;
  float* const vs = ks + C::STAGES * KV_F;
  float* const ps = vs + C::STAGES * KV_F;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  int qt, bh;
  tc::block_tile(n_qtiles, n_bh, group, qt, bh);
  const int q0 = qt * BQ;
  const T* const qb = q + (size_t)bh * sq * d;
  const T* const kb = k + (size_t)bh * skv * d;
  const T* const vb = v + (size_t)bh * skv * d;
  // causal: keys past the tile's last query row are masked for every row
  const int kv_end = causal ? min(skv, q0 + BQ) : skv;
  const int n_tiles = (kv_end + BKV - 1) / BKV;
  const int nc4 = (d + 3) / 4;                 // panels holding columns < d

  // K or V of KV tile `it` into stage `st`: fp32 copies issued (commit
  // groups are the caller's), bf16 loaded into kpre / vpre, stored by put
  Bf16Stage<BKV, DP, true, NT> kpre;
  Bf16Stage<BKV, DP, false, NT> vpre;
  auto fetch_k = [&](int it, int st) {
    if constexpr (F32)
      stage_async<BKV, DP, true, NT>(ks + st * KV_F, kb, it * BKV, skv, d,
                                     vec);
    else
      kpre.load(kb, it * BKV, skv, d);
  };
  auto fetch_v = [&](int it, int st) {
    if constexpr (F32)
      stage_async<BKV, DP, false, NT>(vs + st * KV_F, vb, it * BKV, skv, d,
                                      vec);
    else
      vpre.load(vb, it * BKV, skv, d);
  };
  auto put_k = [&](int st) {
    if constexpr (!F32) kpre.store(ks + st * KV_F);
  };
  auto put_v = [&](int st) {
    if constexpr (!F32) vpre.store(vs + st * KV_F);
  };
  auto commit = [&]() {
    if constexpr (F32) cp_async_commit();
  };

  // Q and tile 0: one copy group with the ring, Q + K and V apart without
  if constexpr (F32) {
    stage_async<BQ, DP, true, NT>(qs, qb, q0, sq, d, vec);
  } else {
    Bf16Stage<BQ, DP, true, NT> qpre;
    qpre.load(qb, q0, sq, d);
    qpre.store(qs);
  }
  fetch_k(0, 0);
  if constexpr (!RING) commit();
  fetch_v(0, 0);
  commit();
  put_k(0);
  put_v(0);

  float m[RM], l[RM], acc[RM][4 * RC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * RC; ++j) acc[i][j] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int st = RING ? it & 1 : 0;
    const bool next = it + 1 < n_tiles;
    // tile it's K (with the ring: and V) has landed; nothing reads the
    // other stage or P any more
    if constexpr (F32) cp_async_wait<RING ? 0 : 1>();
    __syncthreads();
    if constexpr (RING) {
      if (next) {
        fetch_k(it + 1, st ^ 1);
        fetch_v(it + 1, st ^ 1);
        commit();
      }
    }

    // S = Q K^T over the panels holding columns < d
    float s[RM][RS];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RS; ++j) s[i][j] = 0.f;
    const float4* const qp = reinterpret_cast<const float4*>(qs) + ty;
    const float4* const kp =
        reinterpret_cast<const float4*>(ks + st * KV_F) + tx;
#pragma unroll 2
    for (int c4 = 0; c4 < nc4; ++c4) {
      float4 b[RS];
#pragma unroll
      for (int j = 0; j < RS; ++j) b[j] = kp[c4 * BKV + TX * j];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 a = qp[c4 * BQ + TY * i];
#pragma unroll
        for (int j = 0; j < RS; ++j) {
          s[i][j] = fmaf(a.x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a.y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a.z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a.w, b[j].w, s[i][j]);
        }
      }
    }
    if constexpr (!RING) {
      __syncthreads();                         // K read by all
      if (next) fetch_k(it + 1, 0);
      commit();
      if (it > 0) put_v(0);                    // bf16: this tile's V
    }

    // mask the keys past skv and, causal, past each row (only in tiles
    // that cross the diagonal or the end of the keys); then the online
    // softmax on the rows this thread owns: s becomes the unrounded p
    const int kv0 = it * BKV;
    if (kv0 + BKV > skv || (causal && kv0 + BKV - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RS; ++j) {
          const int kpos = kv0 + tx + TX * j;
          if (kpos >= skv || (causal && kpos > q0 + ty + TY * i))
            s[i][j] = NEG_INF;
        }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < RS; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx * scale_log2);
      const float corr = tc::ex2(m[i] - m_new);
      m[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < RS; ++j) {
        s[i][j] = tc::ex2(fmaf(s[i][j], scale_log2, -m_new));
        rs += s[i][j];
      }
      l[i] = l[i] * corr + rs;                 // this thread's keys only
#pragma unroll
      for (int j = 0; j < 4 * RC; ++j) acc[i][j] *= corr;
    }

    // acc += P V in passes of PH keys through P, four keys a step
    float* const pr = ps + ty * LDP + tx;      // P[ty + TY i][tx + TX j]
    const float4* const pp = reinterpret_cast<const float4*>(ps) +
                             ty * (LDP / 4);
    const float4* const vp =
        reinterpret_cast<const float4*>(vs + st * KV_F) + tx;
#pragma unroll
    for (int h = 0; h < BKV / PH; ++h) {
      if (h > 0) __syncthreads();              // the last pass read P
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < PH / TX; ++j)
          pr[TY * i * LDP + TX * j] = round_p(s[i][h * (PH / TX) + j], T());
      if constexpr (F32 && !RING)
        if (h == 0) cp_async_wait<1>();        // this tile's V
      __syncthreads();                         // P (and V) written
#pragma unroll 2
      for (int k4 = 0; k4 < PH / 4; ++k4) {
        float4 p[RM];
#pragma unroll
        for (int i = 0; i < RM; ++i) p[i] = pp[TY * i * (LDP / 4) + k4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float4 w[RC];
#pragma unroll
          for (int g = 0; g < RC; ++g)
            w[g] = vp[(h * PH + 4 * k4 + kk) * (DP / 4) + TX * g];
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float pv = kk == 0 ? p[i].x : kk == 1 ? p[i].y
                           : kk == 2 ? p[i].z : p[i].w;
#pragma unroll
            for (int g = 0; g < RC; ++g) {
              acc[i][4 * g] = fmaf(pv, w[g].x, acc[i][4 * g]);
              acc[i][4 * g + 1] = fmaf(pv, w[g].y, acc[i][4 * g + 1]);
              acc[i][4 * g + 2] = fmaf(pv, w[g].z, acc[i][4 * g + 2]);
              acc[i][4 * g + 3] = fmaf(pv, w[g].w, acc[i][4 * g + 3]);
            }
          }
        }
      }
    }
    if constexpr (RING) {
      if (next) {                              // bf16: the next tile
        put_k(st ^ 1);
        put_v(st ^ 1);
      }
    } else {
      if (next) put_k(0);                      // bf16: the next tile's K
      __syncthreads();                         // V and P read by all
      if (next) fetch_v(it + 1, 0);
      commit();
    }
  }

  // the row sums over the TX lanes (every lane shuffles before any stores)
  float den[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float sum = l[i];
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    den[i] = fmaxf(sum, 1e-30f);
  }
  T* const ob = o + (size_t)bh * sq * d;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + TY * i;
    if (row >= sq) continue;
#pragma unroll
    for (int g = 0; g < RC; ++g) {
      const int col = 4 * (tx + TX * g);
      T* const out = ob + (size_t)row * d + col;
      if (F32 && vec) {
        if (col < d)
          *reinterpret_cast<float4*>(out) = make_float4(
              acc[i][4 * g] / den[i], acc[i][4 * g + 1] / den[i],
              acc[i][4 * g + 2] / den[i], acc[i][4 * g + 3] / den[i]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < d) store(out + e, acc[i][4 * g + e] / den[i]);
      }
    }
  }
}

template <class C, typename T>
int launch_tile(const void* q, const void* k, const void* v, void* o, int bh,
                int sq, int skv, int d, int causal, cudaStream_t stream) {
  const int n_qtiles = (sq + C::BQ - 1) / C::BQ;
  if ((long long)n_qtiles * bh > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_fma_kernel<C, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int vec = std::is_same_v<T, float> && d % 4 == 0 &&
                  ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  // bh a group: as many as keep their K and V within 24 MB of the 50 MB L2
  const long long kv = 2ll * skv * d * (long long)sizeof(T);
  const int group =
      (int)std::max(1ll, std::min<long long>(bh, (24ll << 20) / kv));
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)d));
  flash_attention_fma_kernel<C, T><<<n_qtiles * bh, C::NT, C::SMEM,
                                     stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, skv, d, scale_log2,
      causal, vec, n_qtiles, bh, group);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int sq, int skv, int d, int causal, void* stream) {
  if (bh <= 0 || bh > 65535 || sq <= 0 || skv <= 0 || d <= 0 || d > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  constexpr bool F32 = std::is_same_v<T, float>;
  using T32 = std::conditional_t<F32, F32Tile32, Bf16Tile32>;
  using T64 = std::conditional_t<F32, F32Tile64, Bf16Tile64>;
  using T128 = std::conditional_t<F32, F32Tile128, Bf16Tile128>;
  using T256 = std::conditional_t<F32, F32Tile256, Bf16Tile256>;
  if (d <= 32)
    return launch_tile<T32, T>(q, k, v, o, bh, sq, skv, d, causal, s);
  if (d <= 64)
    return launch_tile<T64, T>(q, k, v, o, bh, sq, skv, d, causal, s);
  if (d <= 128)
    return launch_tile<T128, T>(q, k, v, o, bh, sq, skv, d, causal, s);
  return launch_tile<T256, T>(q, k, v, o, bh, sq, skv, d, causal, s);
}

}  // namespace fma_entry

extern "C" int flash_attention_bf16_tc(const void* q, const void* k,
                                       const void* v, void* o, int bh, int sq,
                                       int skv, int d, int causal,
                                       void* stream) {
  if (bh <= 0 || sq <= 0 || skv <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 64) return tc::launch<64>(q, k, v, o, bh, sq, skv, causal, s);
  if (d == 128) return tc::launch<128>(q, k, v, o, bh, sq, skv, causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int bh, int sq,
                                   int skv, int d, int causal, void* stream) {
  return fma_entry::launch<float>(q, k, v, o, bh, sq, skv, d, causal,
                                  stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int bh, int sq,
                                    int skv, int d, int causal,
                                    void* stream) {
  return fma_entry::launch<__nv_bfloat16>(q, k, v, o, bh, sq, skv, d,
                                          causal, stream);
}
