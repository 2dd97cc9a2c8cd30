// N:M structured sparse matmul for Hopper (sm_90a): Y = X @ expand(V, I).
//
// Two kernels, one per Pallas TPU kernel of src/repro/kernels/nm_spmm.py:
//   nm_spmm_{f32,bf16}          replace `_pipelined_kernel` with
//   nm_spmm_small_m_{f32,bf16}  `_decode_tile` (launched by
//                               `_nm_spmm_pipelined`, the default path of
//                               repro.kernels.ops.nm_spmm): the first at
//                               prefill, the second at decode;
//   nm_spmm_naive_{f32,bf16}    replaces `_kernel` with `_decode_tile`
//                               (launched by `nm_spmm_pallas` with
//                               pipeline=False): a decode kernel at M <= 16
//                               and K % 4 == 0, a prefill one else.
// The wrapper (repro_torch/kernels/nm_spmm.py) picks the entry and the
// summation order; the entries only refuse what they cannot run.
//
// Format: along N (the reduction dim) every group of m_group rows keeps
// n_sel values.  values (N*n_sel/m_group, K) fp32 and indices (same shape,
// int8, position in [0, m_group)) list them group by group.  x (M, N) is
// fp32 or bf16, converted to fp32 exactly; y (M, K) fp32.  Any
// n_sel:m_group with m_group <= 32 (plans serve 2:4 and 1:4).
//
// Summation order, shared by both kernels (the host function
// repro_torch.kernels.nm_spmm.split_plan picks S and L and passes them in):
// the groups along N are cut into S consecutive slices of L groups, the
// last one ragged; L is a multiple of gc = 32 / m_group, so a slice
// boundary falls on a run boundary.  Each output's slice partial is summed
// from 0 in ascending n over the slice's kept entries (stored in ascending
// position), and the partials are added left to right, s = 0 .. S-1, by
// nm_reduce_kernel from a workspace (S, M, K) fp32 that the wrapper
// allocates.  S = 1 at prefill (M > 16, or K not a multiple of 4): one
// slice, written straight to y, no partials.  No atomics: deterministic.
//
// Pipelined prefill entry (nm_spmm_*): nm_spmm_prefill_kernel.  At M = 512
// the work is fp32 FMAs, one per kept entry and row.  The TPU kernel expands
// each tile to a dense operand only to feed its matrix unit; CUDA cores need
// no dense operand, so the port skips the zeros and gathers x per kept
// entry.  A gathered x value feeds one FMA and is never reused from a
// register, so what bounds the kernel is shared memory delivering x: one
// 16-byte shared load per warp costs the SM about 4 cycles when its lanes
// touch 4 or more distinct 16-byte words (tools/lds_bench.cu), against 4
// warp FMAs a cycle.  The design therefore packs as many rows as it can
// into each load:
// - x is staged column-major in its own type.  nm_transpose_x_kernel first
//   copies x into the workspace as (N, mp), mp = M rounded up to PF_MT,
//   padded rows zero, so a staged x column is TM contiguous elements and one
//   16-byte load holds 4 fp32 or 8 bf16 rows.  bf16 halves the bytes per
//   FMA; each value is widened exactly (its 16 bits in the high half of a
//   word), one integer instruction per value.
// - A lane owns one output column x R rows in registers and the 32 lanes of
//   a warp own adjacent columns.  For each kept row (ascending n) a lane
//   reads its value and index once (masking an out-of-range position to
//   value 0 at the group's first column, as the earlier entry did), then
//   its column's R rows of x as R/4 (fp32) or R/8 (bf16) 16-byte loads.
//   The lanes of a warp walk the same kept row, so they touch at most
//   m_group x columns; a staged column is TM elements plus 16 bytes, so
//   those columns start in different banks.
// - Tiles (BigTile, SmallTile): R = 32 rows a lane, 4 x 2 warps, 128 x 64
//   outputs a block; grids of fewer than 132 such blocks (K = 256 at
//   M = 512) take R = 8, one warp row, 8 x 64 outputs, so the card fills.
// - Staging is asynchronous and double-buffered: runs of PF_XC / m_group
//   groups (64 x columns, 32 kept rows at 2:4) are copied by 16-byte
//   cp.async into one of two shared-memory stages (dynamic: 86 KB in all
//   for fp32 x at 2:4, 54 KB for bf16) while the FMAs read the other; one
//   barrier per run.  Operands the 16-byte copies cannot take (K % 16 != 0,
//   values or indices not 16-byte aligned) are staged by plain loads: the
//   entry picks the way (template flag VEC) from the shape and pointers.
// - The grid is (M tiles, K tiles) with M fastest: the M tiles of one column
//   tile run side by side, so the payload comes from HBM about once and from
//   L2 for the others.
// The FMAs are the earlier entry's and the naive entry's: one fp32
// accumulator per output from 0, fmaf(x, value, acc) over the kept entries
// in ascending n, so the result is theirs bit for bit on finite inputs.
// Masks sit in the loads and the store, never around the FMAs.
//
// Non-finite x (both pipelined kernels).  The reference's kernels expand
// each group densely and multiply, so an x that is NaN or Inf at a position
// that an output column's group does not keep meets a zero there and makes
// that output NaN (a kept slot multiplies it itself).  The pipelined
// kernels skip the zeros, so they note whether x holds a non-finite value
// -- the decode kernel while it stages its slice (one block-wide vote), the
// prefill kernel from flags that nm_transpose_x_kernel writes for every
// 32 x 32 tile of x -- and only then run a second pass over the groups that
// writes NaN into those outputs (nan_pass_decode, nan_pass_prefill).  The
// result is the naive entry's: NaN where it has NaN, the same +-Inf and
// finite values elsewhere.  The pass is an out-of-line function called
// after the store, when the accumulators are dead: inlined, its code took
// 23 of the small-M kernel's 127 registers at MT = 4 and cost it 6 % at
// M = 4 (tools/nm_parent_bench.py --variants); out of line the kernels keep
// the parent's registers, and finite inputs pay the votes and the flags.
// A masked row at decode reads a column of zeros staged after the slice,
// so it never multiplies a staged x by its zero.
//
// Pipelined decode entry (nm_spmm_small_m_*, M <= 16, K % 4 == 0):
// nm_spmm_small_m_kernel.  At
// M = 4 the work is a stream of the payload with 8 FLOPs per kept entry,
// so the design is about bytes in flight.  The grid is (ceil(K/SK_TK), S):
// a block of SK_THREADS threads owns SK_TK output columns of one slice, and
// a thread owns 4 adjacent columns x all MT rows in registers, MT = M
// rounded up to 1, 2, 4, 8 or 16 (a template parameter: no dead rows in
// the FMA nest; padded rows of x are staged as zeros and masked at the
// store).  The block stages its slice of x once in shared memory as fp32,
// column-major ([column][MT]), so the MT values one kept entry needs are
// MT/4 16-byte shared loads; every lane of a warp reads the same kept row,
// so its at most m_group distinct x columns lie in one 32-word window:
// broadcast, no bank conflicts.  Per kept row a thread loads one float4 of
// values and one 32-bit word of four int8 indices (read-only path);
// neighbouring threads read neighbouring addresses, and SK_ROWS rows are
// loaded per batch, the next batch issued before the current one's FMAs.
// Ragged K and the tail of a slice are masked in the loads (a dead row is
// value 0 at an invalid position) and the store, never around the FMAs.
//
// Naive entry (nm_spmm_naive_*): replaces `_kernel` + `_decode_tile` of
// `nm_spmm_pallas` with pipeline=False (src/repro/kernels/nm_spmm.py:167).
// It stays the TPU design: each group of the payload is EXPANDED into a
// dense operand by position compares -- dense[p][j] = sum over the group's
// n_sel kept rows of (index == p ? value : 0), from 0, `_decode_tile` --
// and the dense operand is multiplied with x densely, zeros included, in
// ascending n.  `launch` picks one of two kernels from the shape alone, as
// for the pipelined entry:
// - decode (M <= 16, K % 4 == 0): nm_spmm_naive_small_m_kernel, on the
//   pipelined decode kernel's grid (ceil(K/SK_TK), S) with its threads (4
//   adjacent columns x MT rows each), its x slice (fp32, column-major) and
//   its slice partials.  A thread expands its 4 columns of each group's
//   dense rows in registers, where the TPU kernel keeps its dense operand
//   too ("at the VMEM->VREG boundary"), with selects, not branches; then
//   for each of the group's m_group positions it adds x[i][p] * w[j] to its
//   MT x 4 accumulators, reading x densely (every column of the slice in
//   order, one broadcast 16-byte shared load per 4 rows; no address comes
//   from an index).  The kept rows come as one float4 of values and one
//   word of four int8 indices each (VEC), or by plain loads for values off
//   16 bytes or indices off 4; NV_ROWS rows a batch (8 at MT <= 4, 4
//   above), the next batch in flight during the current one's FMAs.  The
//   served group shapes (2:4, 1:4) are compile-time bodies whose rows stay
//   in registers; any other shape takes a loop that re-reads a group's
//   rows for each position from L1 (a block's rows of one group: n_sel *
//   SK_TK * 5 bytes, 40 KB at most), so no shape spills.
// - prefill (M > 16, or K % 4 != 0; one slice): nm_transpose_x_kernel<T,
//   float> copies x column-major and widened to fp32 into the workspace
//   (N, mp), then nm_spmm_naive_prefill_kernel<NTile, float, VEC>.  The
//   expanded operand is a dense matrix, so the work is a dense SGEMM on
//   CUDA cores, zeros included: M * N * K fp32 FMAs (twice kernel 3's at
//   2:4; 208.8 GFLOP a chatglm3-6b layer at M = 512, 3.12 ms at the fp32
//   rate).  What paces it is shared memory feeding the FMAs (a warp's
//   16-byte shared load costs the SM about 4 cycles at 4 or more distinct
//   words, 2.65 at 2, tools/lds_bench.cu, against 16 cycles for a warp's 64
//   FMAs), so the design is the register-blocked outer product of an SGEMM,
//   and every other use of shared memory is kept small:
//   . A thread owns RM x RK = 8 x 8 outputs (rows RM ty + i, columns 4 tx +
//     4 TX g + j): per dense row it reads its 8 x rows and its 8 dense
//     values as two 16-byte loads each, 64 FMAs against 4 loads.  A warp is
//     2 x 16 threads, so its x loads touch 2 distinct words and its dense
//     loads 16 contiguous ones: no bank conflicts, no padding.  NaiveBig:
//     16 x 16 threads, 128 x 128 outputs, at most 128 registers (two blocks
//     an SM).  Where that grid has fewer than NV_MIN_GRID blocks (the K =
//     256 roles: 8 at M = 512), NaiveSmall: 16 x 8 threads of 2 x 4, 32 x
//     32 outputs.
//   . x is staged as fp32: widening bf16 once in the copy costs less than
//     widening it in every thread that reads it (16 threads read each x
//     row; one integer instruction per value and FMA row, 12.5 % of the
//     FMAs' issue slots), though the loop then reads twice the x bytes
//     (tools/nm_naive_prefill_sweep.py measures both).
//   . Runs of XC = 32 x columns (32 / m_group groups, zero columns past the
//     last group) are staged by 16-byte cp.async into a ring of three raw
//     stages (x: XC columns of TM rows, column-major; the run's kept rows of
//     values and indices over TK columns), or by plain loads where K % 16 !=
//     0 or values / indices are off 16 bytes (VEC).
//   . Each run is expanded once into a dense XC x TK shared tile, `_decode_
//     tile`'s compares: dense[r][j] = sum from 0 over the group's kept rows
//     s of (index == p ? value : 0), r = g * m_group + p.  The served shapes
//     (2:4, 1:4) are compile-time bodies, one item per group and four
//     columns: the group's kept rows are read once and its m_group dense
//     rows written as 16-byte stores (about 100 instructions a thread per
//     run against 2048 FMAs); other shapes take one item per dense row and
//     four columns, which re-reads the group's kept rows for each position.
//     Two dense tiles: run r+1 is expanded in the same barrier interval as
//     run r's FMAs, so one barrier per run.
//   . The grid is (M tiles, K tiles) with M fastest: the payload comes from
//     HBM about once and from L2 for the other M tiles.
// Both equal the pipelined entry bit for bit on finite inputs: a kept
// value is added to 0 and to exact zeros, so dense[p][j] is the value or
// zero, and fmaf(x, 0, acc) is acc, so the dense sum in ascending n is the
// pipelined sum over the kept entries in ascending n, slice by slice, and
// the same reduce adds the partials (-0 and +0 may differ; torch.equal
// takes them as equal).  The decode kernel's cost over the pipelined one is
// issue slots: per group and output column m_group * MT FMAs (zeros
// included) and m_group * n_sel compares, selects and adds, against n_sel *
// MT FMAs; at 2:4 and MT = 4 about 40 instructions per group and column
// (20 per kept entry), some 2 G thread instructions per chatglm3-6b layer:
// about 0.07 ms of the 132 SMs' issue slots, under the payload's 0.15 ms.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s fp32 without tensor
// cores): bytes = values (4 B) + indices (1 B) per kept entry + x + y,
// against 2 * M * (kept entries) FLOPs -- the same useful work for both
// entries.  Decode (M = 4) is bound by the payload bytes (509.9 MB per
// chatglm3-6b layer at 2:4: 0.152 ms); prefill (M = 512) by the fp32
// FLOPs.  The partials' round trip (2 * S * M * K * 4 bytes, mostly in L2)
// is kept under 10 % of the payload at decode.
//
// What the design leaves on the table: the decode loads are synchronous
// register loads, not cp.async/TMA rings; both naive kernels spend m_group
// / n_sel times the pipelined kernel's FMAs (the TPU design's cost: at 2:4
// the naive prefill kernel's floor is 3.12 ms a layer against kernel 3's
// 1.56), and group shapes other than 2:4 and 1:4 re-read their rows from
// L1 for each position at decode; the indices travel as int8 instead of
// 2-bit fields; the pipelined prefill entry spends a 16-byte shared load
// per 4 (fp32 x) or 8 (bf16 x) FMAs, plus for bf16 one integer widening per
// FMA, so it cannot pass about a quarter (fp32) or two fifths (bf16) of the
// fp32 rate; the naive prefill kernel's shared loads need about 84 % of
// its FMAs' issue time, so its FMA loop alone stops near two thirds of the
// fp32 rate, and the staging and the expansion, which share that memory,
// add about a third to its time; neither prefill kernel splits the
// reduction (their order is the naive entry's), so the K = 256 roles fill
// the card only with small tiles; and 2:4 in bf16 could run on the sparse
// tensor cores (mma.sp) after a repack of the indices at compress time, at
// another summation order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int XC = 32;        // naive prefill: x columns (dense rows) of a
                              // run; the largest group
constexpr int NV_MIN_GRID = 64;  // its big tile where that grid has at
                                 // least this many blocks

constexpr int PF_MT = 128;   // prefill: rows of the x copy, a multiple of it
constexpr int PF_XC = 64;    // x columns per staged run, at most

constexpr int SK_MAX_M = 16;             // largest M (MT) of the small-M entry
constexpr int SK_THREADS = 64;           // threads of a small-M block
constexpr int SK_TK = 4 * SK_THREADS;    // its output columns
constexpr int SK_ROWS = 8;               // kept rows per load batch
// the same, naive decode kernel: 8 where a thread owns at most 4 output
// rows, 4 above (fewer registers, and faster; tools/nm_naive_sweep.py)
template <int MT>
constexpr int NV_ROWS = MT <= 4 ? 8 : 4;
constexpr int SK_SMEM = 48 * 1024;       // its x slice, bytes at most
constexpr int RED_THREADS = 256;         // threads of a reduce block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Whether v is NaN or +-Inf: its exponent bits all set.
__device__ __forceinline__ bool nonfinite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) == 0x7f800000u;
}

// A quiet NaN, what the reference's dense product gives where a non-finite
// x meets a pruned (zero) slot.
__device__ __forceinline__ float quiet_nan() {
  return __uint_as_float(0x7fc00000u);
}

// 16 bytes global -> shared without a register; `bytes` 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
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

// xt[c * mp + i] = x[i, c] for i < m, 0 for m <= i < mp: the prefill
// kernels' column-major copy of x, in x's own type (U = T) or widened to
// fp32 (U = float), mp a multiple of PF_MT.  FLAGS (the pipelined entry):
// flags[blockIdx.y * gridDim.x + blockIdx.x] is set to whether the block's
// 32 x 32 tile of x holds a value that is not finite, every flag written.
template <typename T, typename U = T, bool FLAGS = false>
__global__ void __launch_bounds__(256)
nm_transpose_x_kernel(const T* __restrict__ x, U* __restrict__ xt, int m,
                      int mp, int n, int* __restrict__ flags) {
  __shared__ T t[32][33];
  const int c0 = blockIdx.x * 32, i0 = blockIdx.y * 32;
  bool bad = false;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int i = i0 + r, c = c0 + threadIdx.x;
    const T v = i < m && c < n ? x[(size_t)i * n + c] : T(0.f);
    t[r][threadIdx.x] = v;
    if constexpr (FLAGS) bad |= nonfinite(to_f32(v));
  }
  if constexpr (FLAGS) {
    const int any = __syncthreads_or(bad);
    if (threadIdx.x == 0 && threadIdx.y == 0)
      flags[blockIdx.y * gridDim.x + blockIdx.x] = any;
  } else {
    __syncthreads();
  }
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int c = c0 + r;
    if (c < n) {
      if constexpr (std::is_same_v<T, U>)
        xt[(size_t)c * mp + i0 + threadIdx.x] = t[threadIdx.x][r];
      else
        xt[(size_t)c * mp + i0 + threadIdx.x] = to_f32(t[threadIdx.x][r]);
    }
  }
}

// A prefill tile: WM x WK warps; a lane owns one output column x R rows,
// so a block owns TM = R * WM rows x TK = 32 * WK columns.  MIN_BLOCKS per
// SM caps the registers at 65536 / (NT * MIN_BLOCKS).
template <int R_, int WM_, int WK_, int MIN_BLOCKS_>
struct Tile {
  static constexpr int R = R_, WM = WM_, WK = WK_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int NT = 32 * WM * WK, TM = R * WM, TK = 32 * WK;
};
using BigTile = Tile<32, 4, 2, 2>;     // 128 x 64, 256 threads
using SmallTile = Tile<8, 1, 2, 8>;    // 8 x 64, 64 threads: small grids

// Elements of T in a staged x column: TM plus 16 bytes, so that column c
// starts 4c words (mod 32) into the banks and the <= 8 consecutive columns
// of one group fall in different banks.
template <class TT, typename T>
__host__ __device__ constexpr int x_stride() {
  return TT::TM + 16 / (int)sizeof(T);
}

// Bytes of one stage: x (PF_XC columns), values and indices of `rows` kept
// rows over TK columns; a block holds two.
template <class TT, typename T>
inline int prefill_stage_bytes(int xcols, int rows) {
  return xcols * x_stride<TT, T>() * (int)sizeof(T) + rows * TT::TK * 5;
}

// Issue the copies of run `g0` (gcur groups) into one stage: x columns
// [g0 * m_group, +xw) of the block's TM rows (column-major) and the run's
// kept rows of values / indices over the block's TK columns (row-major).
// VEC: 16-byte cp.async, columns past K zero-filled (K % 16 == 0 and
// 16-byte aligned rows); else plain loads.
template <class TT, typename T, bool VEC>
__device__ __forceinline__ void stage_run(
    T* __restrict__ xs, float* __restrict__ vs, int8_t* __restrict__ is,
    const T* __restrict__ xt, const float* __restrict__ values,
    const int8_t* __restrict__ indices, int mp, int k, int m0, int k0,
    int g0, int gcur, int n_sel, int m_group) {
  constexpr int TK = TT::TK, NT = TT::NT, EQ = 16 / (int)sizeof(T);
  constexpr int XQ = TT::TM / EQ, XS = x_stride<TT, T>();
  const int xw = gcur * m_group, rows = gcur * n_sel;
  const T* xsrc = xt + (size_t)g0 * m_group * mp + m0;
  for (int e = threadIdx.x; e < xw * XQ; e += NT) {
    const int c = e / XQ, r = e - c * XQ;
    cp_async16(xs + c * XS + EQ * r, xsrc + (size_t)c * mp + EQ * r, 16);
  }
  const size_t row0 = (size_t)g0 * n_sel * k;
  if constexpr (VEC) {
    constexpr int VQ = TK / 4, IQ = TK / 16;
    for (int e = threadIdx.x; e < rows * VQ; e += NT) {
      const int q = e / VQ, j = 4 * (e - q * VQ);
      const bool in = k0 + j < k;
      cp_async16(vs + q * TK + j,
                 values + row0 + (size_t)q * k + (in ? k0 + j : 0),
                 in ? 16 : 0);
    }
    for (int e = threadIdx.x; e < rows * IQ; e += NT) {
      const int q = e / IQ, j = 16 * (e - q * IQ);
      const bool in = k0 + j < k;
      cp_async16(is + q * TK + j,
                 indices + row0 + (size_t)q * k + (in ? k0 + j : 0),
                 in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < rows * TK; e += NT) {
      const int q = e / TK, j = e - q * TK;
      const bool in = k0 + j < k;
      const size_t at = row0 + (size_t)q * k + k0 + j;
      vs[e] = in ? values[at] : 0.f;
      is[e] = in ? indices[at] : (int8_t)0;
    }
  }
}

// acc[i] += x[i] * b over the 16 staged bytes of one x column at xc: four
// fp32 rows, or eight bf16 rows, each widened to fp32 exactly by placing
// its 16 bits in the high half of a word.
__device__ __forceinline__ void fma_strip(const float* xc, float b,
                                          float* acc) {
  const float4 t = *reinterpret_cast<const float4*>(xc);
  acc[0] = fmaf(t.x, b, acc[0]);
  acc[1] = fmaf(t.y, b, acc[1]);
  acc[2] = fmaf(t.z, b, acc[2]);
  acc[3] = fmaf(t.w, b, acc[3]);
}
__device__ __forceinline__ void fma_strip(const __nv_bfloat16* xc, float b,
                                          float* acc) {
  const uint4 t = *reinterpret_cast<const uint4*>(xc);
  const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    acc[2 * u] = fmaf(__uint_as_float(w[u] << 16), b, acc[2 * u]);
    acc[2 * u + 1] =
        fmaf(__uint_as_float(w[u] & 0xffff0000u), b, acc[2 * u + 1]);
  }
}

// Bit i set where x row i of the R values at xc (16-byte aligned; fp32,
// or bf16 as its 16 bits) is not finite.
template <int R>
__device__ __forceinline__ unsigned nonfinite_rows(const float* xc) {
  unsigned rows = 0;
#pragma unroll
  for (int i = 0; i < R; i += 4) {
    const float4 t = *reinterpret_cast<const float4*>(xc + i);
    rows |= (unsigned)nonfinite(t.x) << i |
            (unsigned)nonfinite(t.y) << (i + 1) |
            (unsigned)nonfinite(t.z) << (i + 2) |
            (unsigned)nonfinite(t.w) << (i + 3);
  }
  return rows;
}
template <int R>
__device__ __forceinline__ unsigned nonfinite_rows(const __nv_bfloat16* xc) {
  unsigned rows = 0;
#pragma unroll
  for (int i = 0; i < R; i += 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(xc + i);
    const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      rows |= (unsigned)((w[u] & 0x7f80u) == 0x7f80u) << (i + 2 * u);
      rows |= (unsigned)((w[u] & 0x7f800000u) == 0x7f800000u)
              << (i + 2 * u + 1);
    }
  }
  return rows;
}

// The prefill kernel's non-finite pass for one output column: for each
// group, the positions the column's kept entries (indices, row stride k)
// do not hold; rows whose x there (xt, the block's first row of the
// column-major copy) is not finite get NaN in y (row stride k).  Out of
// line, so the kernel's FMA nest is compiled as without it.
template <int R, typename T>
__device__ __noinline__ void nan_pass_prefill(
    const T* __restrict__ xt, const int8_t* __restrict__ indices, int mp,
    int k, int groups, int n_sel, int m_group, float* __restrict__ y,
    int rows) {
  unsigned nan_rows = 0;
  for (int g = 0; g < groups; ++g) {
    unsigned kept = 0;
    for (int s = 0; s < n_sel; ++s) {
      const unsigned p = (unsigned char)indices[(size_t)(g * n_sel + s) * k];
      kept |= p < (unsigned)m_group ? 1u << p : 0u;
    }
    for (int p = 0; p < m_group; ++p)
      if (!(kept >> p & 1u))
        nan_rows |= nonfinite_rows<R>(xt + (size_t)(g * m_group + p) * mp);
  }
  for (int i = 0; i < rows; ++i)
    if (nan_rows >> i & 1u) y[(size_t)i * k] = quiet_nan();
}

// Prefill entry: one TT::TM x TT::TK output tile per block, grid (M tiles,
// K tiles) with M fastest.  xt: nm_transpose_x_kernel's (N, mp) copy of x;
// flags its non-finite flags, one per 32 x 32 tile, flag_cols tiles a row.
// Warp (wm, wk) owns rows [R wm, +R) and columns [32 wk, +32) of the tile.
// Where a row of the block's tiles holds a non-finite x, a second pass
// makes output (i, c) NaN wherever such an x[i][g m_group + p] meets a
// position p that column c's group g does not keep, as the reference's
// dense expansion multiplies it by zero; finite inputs never take it.
template <class TT, typename T, bool VEC>
__global__ void __launch_bounds__(TT::NT, TT::MIN_BLOCKS)
nm_spmm_prefill_kernel(const T* __restrict__ xt,
                       const float* __restrict__ values,
                       const int8_t* __restrict__ indices,
                       float* __restrict__ y, int m, int mp, int n, int k,
                       int n_sel, int m_group, int run_groups,
                       const int* __restrict__ flags, int flag_cols) {
  constexpr int R = TT::R, TK = TT::TK, XS = x_stride<TT, T>();
  constexpr int EQ = 16 / (int)sizeof(T);          // rows per 16-byte load
  extern __shared__ float4 smem4[];
  char* const smem = reinterpret_cast<char*>(smem4);
  const int xbytes = run_groups * m_group * XS * (int)sizeof(T);
  const int rows_all = run_groups * n_sel;          // kept rows of a run
  const int stage_bytes = xbytes + rows_all * TK * 5;
  const int groups = n / m_group;
  const int runs = (groups + run_groups - 1) / run_groups;
  const int m0 = blockIdx.x * TT::TM, k0 = blockIdx.y * TK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col = (warp % TT::WK) * 32 + lane;
  const int r0 = (warp / TT::WK) * R;

  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;

  auto issue = [&](int run) {
    char* st = smem + (run & 1) * stage_bytes;
    float* vs = reinterpret_cast<float*>(st + xbytes);
    const int g0 = run * run_groups;
    stage_run<TT, T, VEC>(reinterpret_cast<T*>(st), vs,
                          reinterpret_cast<int8_t*>(vs + rows_all * TK), xt,
                          values, indices, mp, k, m0, k0, g0,
                          min(run_groups, groups - g0), n_sel, m_group);
  };
  issue(0);
  cp_async_commit();
  // the flags of the 32-row tiles the block's rows lie in
  int bad_x = 0;
  {
    const int tr0 = m0 / 32, trows = (TT::TM + 31) / 32;
    for (int e = threadIdx.x; e < trows * flag_cols; e += TT::NT)
      bad_x |= flags[(tr0 + e / flag_cols) * flag_cols + e % flag_cols];
  }
  for (int run = 0; run < runs; ++run) {
    cp_async_wait<0>();
    __syncthreads();       // the run has landed; the other stage is free
    if (run + 1 < runs) issue(run + 1);  // in flight during this run's FMAs
    cp_async_commit();
    const char* st = smem + (run & 1) * stage_bytes;
    const T* xb = reinterpret_cast<const T*>(st) + r0;
    const float* vs = reinterpret_cast<const float*>(st + xbytes);
    const unsigned char* is =
        reinterpret_cast<const unsigned char*>(vs + rows_all * TK);
    const int rows = min(run_groups, groups - run * run_groups) * n_sel;
    int base = 0, slot = 0;                // group column and slot of row q
#pragma unroll 2
    for (int q = 0; q < rows; ++q) {
      const unsigned p = is[q * TK + col];
      const bool ok = p < (unsigned)m_group;
      const float b = ok ? vs[q * TK + col] : 0.f;
      const T* xc = xb + (base + (ok ? (int)p : 0)) * XS;
#pragma unroll
      for (int i = 0; i < R / EQ; ++i) fma_strip(xc + EQ * i, b, acc + EQ * i);
      const bool next = ++slot == n_sel;   // row q+1 starts a group
      slot = next ? 0 : slot;
      base += next ? m_group : 0;
    }
  }

  const int c = k0 + col;
  if (c < k) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = m0 + r0 + i;
      if (row < m) y[(size_t)row * k + c] = acc[i];
    }
  }
  // the non-finite pass, after the store and out of line (acc is dead)
  if (__syncthreads_or(bad_x) && c < k)
    nan_pass_prefill<R>(xt + m0 + r0, indices + c, mp, k, groups, n_sel,
                        m_group, y + (size_t)(m0 + r0) * k + c,
                        min(R, m - m0 - r0));
}

template <class TT, typename T, bool VEC>
int launch_prefill(const T* xt, const void* values, const void* indices,
                   float* y, int m, int mp, int n, int k, int n_sel,
                   int m_group, int run_groups, const int* flags,
                   cudaStream_t st) {
  const int smem = 2 * prefill_stage_bytes<TT, T>(run_groups * m_group,
                                                  run_groups * n_sel);
  cudaError_t e = cudaFuncSetAttribute(
      nm_spmm_prefill_kernel<TT, T, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((m + TT::TM - 1) / TT::TM, (k + TT::TK - 1) / TT::TK);
  nm_spmm_prefill_kernel<TT, T, VEC><<<grid, TT::NT, smem, st>>>(
      xt, (const float*)values, (const int8_t*)indices, y, m, mp, n, k, n_sel,
      m_group, run_groups, flags, (n + 31) / 32);
  return (int)cudaGetLastError();
}

// The next SK_ROWS kept rows, of which `left` are in the slice: one float4
// of values and one word of four int8 indices each; vp / ip step to the
// row after.  Rows past the slice's end are masked here: value 0 at
// position 0xff, which no group has.
__device__ __forceinline__ void load_rows(const float4*& vp, const int*& ip,
                                          int step, int left,
                                          float4 (&v)[SK_ROWS],
                                          int (&p)[SK_ROWS]) {
#pragma unroll
  for (int u = 0; u < SK_ROWS; ++u) {
    v[u] = u < left ? __ldg(vp) : make_float4(0.f, 0.f, 0.f, 0.f);
    p[u] = u < left ? __ldg(ip) : -1;
    vp += step;
    ip += step;
  }
}

// The MT staged x values of one slice column.
template <int MT>
__device__ __forceinline__ void load_x(const float* xc, float (&xv)[MT]) {
  if constexpr (MT == 1) {
    xv[0] = xc[0];
  } else if constexpr (MT == 2) {
    const float2 t = *reinterpret_cast<const float2*>(xc);
    xv[0] = t.x;
    xv[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < MT; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(xc + i);
      xv[i] = t.x;
      xv[i + 1] = t.y;
      xv[i + 2] = t.z;
      xv[i + 3] = t.w;
    }
  }
}

// x columns [c0, c0 + xw) of the MT rows into xs[column][MT] as fp32, rows
// from m on as zeros; then a barrier.
template <typename T, int MT>
__device__ __forceinline__ void stage_x_slice(const T* __restrict__ x,
                                              float* __restrict__ xs, int m,
                                              int n, size_t c0, int xw) {
  for (int e = threadIdx.x; e < MT * xw; e += SK_THREADS) {
    const int i = e / xw, c = e - i * xw;
    xs[c * MT + i] = i < m ? to_f32(x[(size_t)i * n + c0 + c]) : 0.f;
  }
  __syncthreads();
}

// The pipelined decode kernel's staging: stage_x_slice's copy of the slice,
// then a column of zeros after it (column xw, which the masked rows read:
// a masked row multiplies 0 by 0, never a staged x), a barrier, and whether
// any staged x is not finite, the same answer in every thread.
template <typename T, int MT>
__device__ __forceinline__ bool stage_x_slice_checked(
    const T* __restrict__ x, float* __restrict__ xs, int m, int n,
    size_t c0, int xw) {
  bool bad = false;
  for (int e = threadIdx.x; e < MT * xw; e += SK_THREADS) {
    const int i = e / xw, c = e - i * xw;
    const float v = i < m ? to_f32(x[(size_t)i * n + c0 + c]) : 0.f;
    xs[c * MT + i] = v;
    bad |= nonfinite(v);
  }
  if (threadIdx.x < MT) xs[xw * MT + threadIdx.x] = 0.f;
  return __syncthreads_or(bad) != 0;
}

// Rows below m of a thread's 4 adjacent output columns at o (row stride k).
template <int MT>
__device__ __forceinline__ void store_cols(const float (&acc)[MT][4],
                                           float* __restrict__ o, int m,
                                           int k) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
    if (i < m)
      *reinterpret_cast<float4*>(o + (size_t)i * k) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

// The small-M kernel's non-finite pass for a thread's 4 output columns:
// for each of the slice's gcur groups, the positions the columns' kept
// entries (gp: one word of four int8 indices a kept row, step words a row)
// do not hold; rows whose staged x there (xs, [column][MT]) is not finite
// get NaN in the partial o (row stride k).  Out of line, so the kernel's
// FMA nest is compiled as without it.
template <int MT>
__device__ __noinline__ void nan_pass_decode(
    const float* __restrict__ xs, const int* __restrict__ gp, int step,
    int gcur, int n_sel, int m_group, float* __restrict__ o, int m, int k) {
  unsigned nan_rows[4] = {0u, 0u, 0u, 0u};   // rows (bits) of column j
  for (int g = 0; g < gcur; ++g) {
    unsigned kept[4] = {0u, 0u, 0u, 0u};
    for (int s = 0; s < n_sel; ++s) {
      const unsigned w = (unsigned)__ldg(gp + (size_t)(g * n_sel + s) * step);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned pj = (w >> (8 * j)) & 0xffu;
        kept[j] |= pj < (unsigned)m_group ? 1u << pj : 0u;
      }
    }
    for (int q = 0; q < m_group; ++q) {
      const float* xc = xs + (g * m_group + q) * MT;
      unsigned bad = 0;                      // rows whose x is not finite
#pragma unroll
      for (int i = 0; i < MT; ++i) bad |= (unsigned)nonfinite(xc[i]) << i;
#pragma unroll
      for (int j = 0; j < 4; ++j) nan_rows[j] |= kept[j] >> q & 1u ? 0u : bad;
    }
  }
  for (int i = 0; i < m; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (nan_rows[j] >> i & 1u) o[(size_t)i * k + j] = quiet_nan();
}

// Small-M entry (M <= SK_MAX_M): the partial of slice blockIdx.y over
// output columns [4 * thread, +4) of tile blockIdx.x, into out + slice *
// M * K (out is y itself when S = 1).  Needs K % 4 == 0, values 16-byte
// and indices 4-byte aligned, and MT (xw + 1) floats of shared memory.
// Where the slice's x holds a value that is not finite, a second pass
// over its groups makes the partial (i, j) NaN wherever such an x[i] sits
// at a position column j's group does not keep (the reference's dense
// expansion multiplies it by zero): the partial then carries the NaN
// through the ordered reduce.  Finite slices never take it.
template <typename T, int MT>
__global__ void __launch_bounds__(SK_THREADS)
nm_spmm_small_m_kernel(const T* __restrict__ x,
                       const float* __restrict__ values,
                       const int8_t* __restrict__ indices,
                       float* __restrict__ out, int m, int n, int k,
                       int n_sel, int m_group, int slice_groups) {
  extern __shared__ float4 xs4[];
  float* xs = reinterpret_cast<float*>(xs4);   // [slice column][MT], fp32
  const int groups = n / m_group;
  const int g0 = blockIdx.y * slice_groups;
  const int gcur = min(slice_groups, groups - g0);
  const int xw = gcur * m_group;               // x columns of this slice
  const int rows = gcur * n_sel;               // kept rows of this slice
  const int col = blockIdx.x * SK_TK + 4 * threadIdx.x;
  const int lcol = min(col, k - 4);            // dead columns read a live one
  const size_t at0 = (size_t)g0 * n_sel * k + lcol;
  const float4* vp = reinterpret_cast<const float4*>(values + at0);
  const int* ip = reinterpret_cast<const int*>(indices + at0);  // next row
  const int step = k / 4;                      // one row, in 16 B / 4 B units
  float4 v[SK_ROWS];
  int p[SK_ROWS];
  load_rows(vp, ip, step, rows, v, p);         // in flight while x is staged

  const bool bad_x =
      stage_x_slice_checked<T, MT>(x, xs, m, n, (size_t)g0 * m_group, xw);

  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  int grp = 0, slot = 0;                       // group and slot of row q0
  for (int q0 = 0; q0 < rows; q0 += SK_ROWS) {
    float4 vn[SK_ROWS];
    int pn[SK_ROWS];
    load_rows(vp, ip, step, rows - q0 - SK_ROWS, vn, pn);   // next batch
#pragma unroll
    for (int u = 0; u < SK_ROWS; ++u) {
      const int base = grp * m_group;
      const float b4[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned pj = ((unsigned)p[u] >> (8 * j)) & 0xffu;
        const bool ok = pj < (unsigned)m_group;
        const float b = ok ? b4[j] : 0.f;
        float xv[MT];
        load_x<MT>(xs + (ok ? base + (int)pj : xw) * MT, xv);
#pragma unroll
        for (int i = 0; i < MT; ++i) acc[i][j] = fmaf(xv[i], b, acc[i][j]);
      }
      const bool next = ++slot == n_sel;       // row q0+u+1 starts a group
      slot = next ? 0 : slot;
      grp += next;
    }
#pragma unroll
    for (int u = 0; u < SK_ROWS; ++u) {
      v[u] = vn[u];
      p[u] = pn[u];
    }
  }

  float* const o = out + (size_t)blockIdx.y * m * k + col;
  if (col < k) store_cols(acc, o, m, k);
  // the non-finite pass, after the store and out of line: acc is dead by
  // then, and the FMA nest keeps the registers it has without the pass
  if (bad_x && col < k)
    nan_pass_decode<MT>(xs, reinterpret_cast<const int*>(indices + at0),
                        step, gcur, n_sel, m_group, o, m, k);
}

// y = ws[0] + ws[1] + ... + ws[S-1], left to right, four outputs a thread.
__global__ void __launch_bounds__(RED_THREADS)
nm_reduce_kernel(const float4* __restrict__ ws, float4* __restrict__ y,
                 int slices, int mk4) {
  const int e = blockIdx.x * RED_THREADS + threadIdx.x;
  if (e >= mk4) return;
  float4 a = __ldg(ws + e);
#pragma unroll 8
  for (int s = 1; s < slices; ++s) {            // loads overlap, adds in order
    const float4 b = __ldg(ws + (size_t)s * mk4 + e);
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  y[e] = a;
}

// Kept rows q .. q+R-1 of a slice whose row 0 is at vp / ip (the thread's
// column), of which those below `rows` are loaded and the others masked:
// value 0 at position 0xff, which no group has.  VEC: one float4 of values
// and one word of four int8 indices a row; else plain loads, for values
// off 16 bytes or indices off 4.
template <bool VEC, int R>
__device__ __forceinline__ void naive_rows(const float* __restrict__ vp,
                                           const int8_t* __restrict__ ip,
                                           int k, int q, int rows,
                                           float4 (&v)[R], int (&p)[R]) {
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const bool in = q + u < rows;
    const size_t at = (size_t)(in ? q + u : 0) * k;
    if constexpr (VEC) {
      v[u] = in ? __ldg(reinterpret_cast<const float4*>(vp + at))
                : make_float4(0.f, 0.f, 0.f, 0.f);
      p[u] = in ? __ldg(reinterpret_cast<const int*>(ip + at)) : -1;
    } else {
      const float* a = vp + at;
      const unsigned char* b =
          reinterpret_cast<const unsigned char*>(ip) + at;
      v[u] = in ? make_float4(__ldg(a), __ldg(a + 1), __ldg(a + 2),
                              __ldg(a + 3))
                : make_float4(0.f, 0.f, 0.f, 0.f);
      p[u] = in ? (int)((unsigned)__ldg(b) | (unsigned)__ldg(b + 1) << 8 |
                        (unsigned)__ldg(b + 2) << 16 |
                        (unsigned)__ldg(b + 3) << 24)
                : -1;
    }
  }
}

// acc[i][j] += x[i] * w[j] over the MT staged x values at xc.
template <int MT>
__device__ __forceinline__ void fma_dense_row(const float* xc,
                                              const float (&w)[4],
                                              float (&acc)[MT][4]) {
  float xv[MT];
  load_x<MT>(xc, xv);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], w[j], acc[i][j]);
}

// The slice's groups of shape NS:MG (compile time), kept rows in
// registers: batches of R rows (R / NS whole groups), the next
// batch loaded during the current one's FMAs.  `stage` stages x once the
// first batch is in flight.  A group past the slice's end (the tail of the
// last batch) has w = 0 and reads the slice's last x columns: its FMAs add
// exact zeros.
template <int MT, bool VEC, int NS, int MG, class Stage>
__device__ __forceinline__ void naive_groups(const float* xs,
                                             const float* vp,
                                             const int8_t* ip, int k,
                                             int gcur, Stage stage,
                                             float (&acc)[MT][4]) {
  constexpr int R = NV_ROWS<MT>;
  static_assert(R % NS == 0, "a batch holds whole groups");
  const int rows = gcur * NS;
  float4 v[R];
  int p[R];
  naive_rows<VEC>(vp, ip, k, 0, rows, v, p);
  stage();
  for (int q0 = 0; q0 < rows; q0 += R) {
    float4 vn[R];
    int pn[R];
    naive_rows<VEC>(vp, ip, k, q0 + R, rows, vn, pn);         // next batch
#pragma unroll
    for (int gg = 0; gg < R / NS; ++gg) {
      const float* xg = xs + min(q0 / NS + gg, gcur - 1) * MG * MT;
      float b[NS][4];
      unsigned pos[NS][4];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float4 t = v[gg * NS + s];
        b[s][0] = t.x;
        b[s][1] = t.y;
        b[s][2] = t.z;
        b[s][3] = t.w;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pos[s][j] = ((unsigned)p[gg * NS + s] >> (8 * j)) & 0xffu;
      }
      // _decode_tile: dense row c of the group, then its FMAs, c ascending
#pragma unroll
      for (int c = 0; c < MG; ++c) {
        float w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          w[j] = 0.f;
#pragma unroll
          for (int s = 0; s < NS; ++s)
            w[j] += pos[s][j] == (unsigned)c ? b[s][j] : 0.f;
        }
        fma_dense_row<MT>(xg + c * MT, w, acc);
      }
    }
#pragma unroll
    for (int u = 0; u < R; ++u) {
      v[u] = vn[u];
      p[u] = pn[u];
    }
  }
}

// Any other group shape: the same expansion and FMAs with run-time loops;
// a group's rows are re-read for each position (from L1).
template <int MT, bool VEC, class Stage>
__device__ __forceinline__ void naive_groups_any(
    const float* xs, const float* vp, const int8_t* ip, int k, int gcur,
    int n_sel, int m_group, Stage stage, float (&acc)[MT][4]) {
  stage();
  const int rows = gcur * n_sel;
  for (int g = 0; g < gcur; ++g) {
    for (int c = 0; c < m_group; ++c) {
      float w[4] = {0.f, 0.f, 0.f, 0.f};
      for (int s = 0; s < n_sel; ++s) {
        float4 v[1];
        int p[1];
        naive_rows<VEC>(vp, ip, k, g * n_sel + s, rows, v, p);
        const float b[4] = {v[0].x, v[0].y, v[0].z, v[0].w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[j] += (((unsigned)p[0] >> (8 * j)) & 0xffu) == (unsigned)c
                      ? b[j]
                      : 0.f;
      }
      fma_dense_row<MT>(xs + (g * m_group + c) * MT, w, acc);
    }
  }
}

// Naive decode kernel (M <= SK_MAX_M, K % 4 == 0): the partial of slice
// blockIdx.y over output columns [4 * thread, +4) of tile blockIdx.x, into
// out + slice * M * K (out is y itself when S = 1), each group expanded to
// its dense rows and multiplied densely.
template <typename T, int MT, bool VEC>
__global__ void __launch_bounds__(SK_THREADS)
nm_spmm_naive_small_m_kernel(const T* __restrict__ x,
                             const float* __restrict__ values,
                             const int8_t* __restrict__ indices,
                             float* __restrict__ out, int m, int n, int k,
                             int n_sel, int m_group, int slice_groups) {
  extern __shared__ float4 xs4[];
  float* xs = reinterpret_cast<float*>(xs4);   // [slice column][MT], fp32
  const int groups = n / m_group;
  const int g0 = blockIdx.y * slice_groups;
  const int gcur = min(slice_groups, groups - g0);
  const int col = blockIdx.x * SK_TK + 4 * threadIdx.x;
  const size_t at0 = (size_t)g0 * n_sel * k + min(col, k - 4);  // dead
  const float* vp = values + at0;              // columns read a live one
  const int8_t* ip = indices + at0;
  auto stage = [&] {
    stage_x_slice<T, MT>(x, xs, m, n, (size_t)g0 * m_group, gcur * m_group);
  };

  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  if (n_sel == 2 && m_group == 4)
    naive_groups<MT, VEC, 2, 4>(xs, vp, ip, k, gcur, stage, acc);
  else if (n_sel == 1 && m_group == 4)
    naive_groups<MT, VEC, 1, 4>(xs, vp, ip, k, gcur, stage, acc);
  else
    naive_groups_any<MT, VEC>(xs, vp, ip, k, gcur, n_sel, m_group, stage,
                              acc);
  if (col < k) store_cols(acc, out + (size_t)blockIdx.y * m * k + col, m, k);
}

// A naive prefill tile: TY x TX threads, each owning RM x RK outputs, so a
// block owns TM = TY * RM rows x TK = TX * RK columns.  MIN_BLOCKS per SM
// caps the registers at 65536 / (NT * MIN_BLOCKS).
template <int TY_, int TX_, int RM_, int RK_, int MIN_BLOCKS_>
struct NTile {
  static constexpr int TY = TY_, TX = TX_, RM = RM_, RK = RK_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int NT = TY * TX, TM = TY * RM, TK = TX * RK;
};
using NaiveBig = NTile<16, 16, 8, 8, 2>;    // 128 x 128, 256 threads
using NaiveSmall = NTile<16, 8, 2, 4, 4>;   // 32 x 32, 128 threads

// Bytes of one raw stage: x (XC columns of TM rows) and `rows` kept rows of
// values and indices over TK columns.  A block holds three, then two dense
// XC x TK fp32 tiles.
template <class TT, typename T>
__host__ __device__ constexpr int naive_raw_bytes(int rows) {
  return XC * TT::TM * (int)sizeof(T) + rows * TT::TK * 5;
}
template <class TT, typename T>
inline int naive_prefill_smem(int rows) {
  return 3 * naive_raw_bytes<TT, T>(rows) + 2 * XC * TT::TK * 4;
}

// Issue the copies of one run of the naive prefill kernel into a raw stage:
// x columns [c0, c0 + xw) of the block's TM rows (column-major, the
// columns from xw to XC zero-filled) and the run's `rows` kept rows of
// values / indices over the block's TK columns (row-major).  VEC: 16-byte
// cp.async, columns past K zero-filled (K % 16 == 0 and 16-byte aligned
// rows); else plain loads.
template <class TT, typename T, bool VEC>
__device__ __forceinline__ void stage_naive_run(
    T* __restrict__ xs, float* __restrict__ vs, int8_t* __restrict__ is,
    const T* __restrict__ xt, const float* __restrict__ values,
    const int8_t* __restrict__ indices, int mp, int k, int m0, int k0,
    size_t c0, int xw, size_t row0, int rows) {
  constexpr int TM = TT::TM, TK = TT::TK, NT = TT::NT;
  constexpr int EQ = 16 / (int)sizeof(T), XQ = TM / EQ;
  for (int e = threadIdx.x; e < XC * XQ; e += NT) {
    const int c = e / XQ, f = e - c * XQ;
    const bool in = c < xw;
    cp_async16(xs + c * TM + EQ * f,
               in ? xt + (c0 + c) * mp + m0 + EQ * f : xt, in ? 16 : 0);
  }
  const float* const vsrc = values + row0 * k;
  const int8_t* const isrc = indices + row0 * k;
  if constexpr (VEC) {
    constexpr int VQ = TK / 4, IQ = TK / 16;
    for (int e = threadIdx.x; e < rows * VQ; e += NT) {
      const int q = e / VQ, j = 4 * (e - q * VQ);
      const bool in = k0 + j < k;
      cp_async16(vs + q * TK + j, vsrc + (size_t)q * k + (in ? k0 + j : 0),
                 in ? 16 : 0);
    }
    for (int e = threadIdx.x; e < rows * IQ; e += NT) {
      const int q = e / IQ, j = 16 * (e - q * IQ);
      const bool in = k0 + j < k;
      cp_async16(is + q * TK + j, isrc + (size_t)q * k + (in ? k0 + j : 0),
                 in ? 16 : 0);
    }
  } else {
    // one element at a time: the loads' registers stay few beside the
    // accumulators
#pragma unroll 1
    for (int e = threadIdx.x; e < rows * TK; e += NT) {
      const int q = e / TK, j = e - q * TK;
      const bool in = k0 + j < k;
      const size_t at = (size_t)q * k + k0 + j;
      vs[e] = in ? vsrc[at] : 0.f;
      is[e] = in ? isrc[at] : (int8_t)0;
    }
  }
}

// `_decode_tile` for one staged run: dense[r][j] for the XC dense rows r =
// g * m_group + p (zeros from xw on) and the TK columns, summed from 0 over
// the group's kept rows s, ascending, of (index == p ? value : 0); four
// adjacent columns a thread, one 16-byte load of values and one word of
// indices per kept row, one 16-byte store.
template <class TT>
__device__ __forceinline__ void expand_run(const float* __restrict__ vs,
                                           const unsigned* __restrict__ is4,
                                           float* __restrict__ dense, int xw,
                                           int n_sel, int m_group) {
  constexpr int TK = TT::TK, Q = TK / 4;
  for (int e = threadIdx.x; e < XC * Q; e += TT::NT) {
    const int r = e / Q, q = e - r * Q;
    float w[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < xw) {
      const int g = r / m_group;
      const unsigned p = (unsigned)(r - g * m_group);
      for (int s = g * n_sel; s < (g + 1) * n_sel; ++s) {
        const float4 v = *reinterpret_cast<const float4*>(vs + s * TK + 4 * q);
        const unsigned pk = is4[s * Q + q];
        const float b[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[j] += (pk >> (8 * j) & 0xffu) == p ? b[j] : 0.f;
      }
    }
    *reinterpret_cast<float4*>(dense + r * TK + 4 * q) =
        make_float4(w[0], w[1], w[2], w[3]);
  }
}

// The same for groups of shape NS:MG (compile time; XC / MG groups a
// run): one item per group and four adjacent columns reads the group's NS
// kept rows once (one 16-byte load of values and one word of indices each)
// and writes its MG dense rows; groups from gcur on are zeros.
template <class TT, int NS, int MG>
__device__ __forceinline__ void expand_groups(const float* __restrict__ vs,
                                              const unsigned* __restrict__ is4,
                                              float* __restrict__ dense,
                                              int gcur) {
  constexpr int TK = TT::TK, Q = TK / 4;
  for (int e = threadIdx.x; e < XC / MG * Q; e += TT::NT) {
    const int g = e / Q, q = e - g * Q;
    const bool live = g < gcur;
    float b[NS][4];
    unsigned pos[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float4 v =
          *reinterpret_cast<const float4*>(vs + (g * NS + s) * TK + 4 * q);
      b[s][0] = live ? v.x : 0.f;
      b[s][1] = live ? v.y : 0.f;
      b[s][2] = live ? v.z : 0.f;
      b[s][3] = live ? v.w : 0.f;
      pos[s] = is4[(g * NS + s) * Q + q];
    }
#pragma unroll
    for (int p = 0; p < MG; ++p) {
      float w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[j] = 0.f;
#pragma unroll
        for (int s = 0; s < NS; ++s)
          w[j] += (pos[s] >> (8 * j) & 0xffu) == (unsigned)p ? b[s][j] : 0.f;
      }
      *reinterpret_cast<float4*>(dense + (g * MG + p) * TK + 4 * q) =
          make_float4(w[0], w[1], w[2], w[3]);
    }
  }
}

// The R staged fp32 x rows at xc, R 2 or a multiple of 4: one 8-byte load
// or R / 4 16-byte loads.
template <int R>
__device__ __forceinline__ void load_x_rows(const float* xc, float (&a)[R]) {
  if constexpr (R == 2) {
    const float2 t = *reinterpret_cast<const float2*>(xc);
    a[0] = t.x;
    a[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < R; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(xc + i);
      a[i] = t.x;
      a[i + 1] = t.y;
      a[i + 2] = t.z;
      a[i + 3] = t.w;
    }
  }
}

// The FMAs of one run: for each of its XC dense rows c, ascending, the
// thread's RM x rows times its RK dense values, zeros included.  xs: the
// run's x at the thread's first row; ws: its dense tile at the thread's
// first column.
template <class TT, typename T>
__device__ __forceinline__ void fma_run(const T* __restrict__ xs,
                                        const float* __restrict__ ws,
                                        float (&acc)[TT::RM][TT::RK]) {
  constexpr int RM = TT::RM, RK = TT::RK;
#pragma unroll 8
  for (int c = 0; c < XC; ++c) {
    float a[RM], b[RK];
    load_x_rows<RM>(xs + c * TT::TM, a);
#pragma unroll
    for (int g = 0; g < RK / 4; ++g) {
      const float4 t =
          *reinterpret_cast<const float4*>(ws + c * TT::TK + 4 * TT::TX * g);
      b[4 * g] = t.x;
      b[4 * g + 1] = t.y;
      b[4 * g + 2] = t.z;
      b[4 * g + 3] = t.w;
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Naive prefill kernel (M > SK_MAX_M or K % 4 != 0; one slice): the TT::TM
// x TT::TK output tile (blockIdx.x, blockIdx.y) of y, each run of groups
// expanded to its dense rows and multiplied densely.  xt:
// nm_transpose_x_kernel's (N, mp) copy of x.  Thread (ty, tx) owns rows RM
// ty + i and columns 4 tx + 4 TX g + j of the tile.
template <class TT, typename T, bool VEC>
__global__ void __launch_bounds__(TT::NT, TT::MIN_BLOCKS)
nm_spmm_naive_prefill_kernel(const T* __restrict__ xt,
                             const float* __restrict__ values,
                             const int8_t* __restrict__ indices,
                             float* __restrict__ y, int m, int mp, int n,
                             int k, int n_sel, int m_group) {
  constexpr int TM = TT::TM, TK = TT::TK, RM = TT::RM, RK = TT::RK;
  extern __shared__ float4 smem4[];
  char* const smem = reinterpret_cast<char*>(smem4);
  const int run_groups = XC / m_group;
  const int rows_all = run_groups * n_sel;          // kept rows of a run
  const int xbytes = XC * TM * (int)sizeof(T);
  const int raw = naive_raw_bytes<TT, T>(rows_all);
  float* const dense = reinterpret_cast<float*>(smem + 3 * raw);
  const int groups = n / m_group;
  const int runs = (groups + run_groups - 1) / run_groups;
  const int m0 = blockIdx.x * TM, k0 = blockIdx.y * TK;
  const int tx = threadIdx.x % TT::TX, ty = threadIdx.x / TT::TX;

  auto stage = [&](int run) { return smem + (run % 3) * raw; };
  auto gcur = [&](int run) {
    return min(run_groups, groups - run * run_groups);
  };
  auto issue = [&](int run) {
    char* const st = stage(run);
    float* const vs = reinterpret_cast<float*>(st + xbytes);
    const size_t g0 = (size_t)run * run_groups;
    stage_naive_run<TT, T, VEC>(
        reinterpret_cast<T*>(st), vs,
        reinterpret_cast<int8_t*>(vs + rows_all * TK), xt, values, indices,
        mp, k, m0, k0, g0 * m_group, gcur(run) * m_group, g0 * n_sel,
        gcur(run) * n_sel);
  };
  // the served group shapes expand a group per item, others a dense row
  auto expand = [&](int run) {
    const float* const vs =
        reinterpret_cast<const float*>(stage(run) + xbytes);
    const unsigned* const is4 =
        reinterpret_cast<const unsigned*>(vs + rows_all * TK);
    float* const d = dense + (run & 1) * XC * TK;
    if (n_sel == 2 && m_group == 4)
      expand_groups<TT, 2, 4>(vs, is4, d, gcur(run));
    else if (n_sel == 1 && m_group == 4)
      expand_groups<TT, 1, 4>(vs, is4, d, gcur(run));
    else
      expand_run<TT>(vs, is4, d, gcur(run) * m_group, n_sel, m_group);
  };

  float acc[RM][RK];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RK; ++j) acc[i][j] = 0.f;

  issue(0);
  cp_async_commit();
  if (runs > 1) issue(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  expand(0);
  for (int run = 0; run < runs; ++run) {
    cp_async_wait<0>();
    // run + 1 has landed and run's dense tile is whole; run - 1's stage and
    // dense tile are free
    __syncthreads();
    if (run + 2 < runs) issue(run + 2);    // in flight during this run
    cp_async_commit();
    if (run + 1 < runs) expand(run + 1);
    fma_run<TT, T>(reinterpret_cast<const T*>(stage(run)) + RM * ty,
                   dense + (run & 1) * XC * TK + 4 * tx, acc);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = m0 + RM * ty + i;
    if (row >= m) continue;
    float* const yr = y + (size_t)row * k;
#pragma unroll
    for (int g = 0; g < RK / 4; ++g) {
      const int col = k0 + 4 * tx + 4 * TT::TX * g;
      if (k % 4 == 0) {
        if (col < k)
          *reinterpret_cast<float4*>(yr + col) =
              make_float4(acc[i][4 * g], acc[i][4 * g + 1],
                          acc[i][4 * g + 2], acc[i][4 * g + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < k) yr[col + j] = acc[i][4 * g + j];
      }
    }
  }
}

template <class TT, typename T, bool VEC>
int launch_naive_prefill(const T* xt, const void* values, const void* indices,
                         float* y, int m, int mp, int n, int k, int n_sel,
                         int m_group, cudaStream_t st) {
  const int smem = naive_prefill_smem<TT, T>(XC / m_group * n_sel);
  // two big blocks an SM need 2 x 110 KB at fp32 x and 2:4: all shared
  cudaError_t e = cudaFuncSetAttribute(
      nm_spmm_naive_prefill_kernel<TT, T, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(nm_spmm_naive_prefill_kernel<TT, T, VEC>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((m + TT::TM - 1) / TT::TM, (k + TT::TK - 1) / TT::TK);
  nm_spmm_naive_prefill_kernel<TT, T, VEC><<<grid, TT::NT, smem, st>>>(
      xt, (const float*)values, (const int8_t*)indices, y, m, mp, n, k, n_sel,
      m_group);
  return (int)cudaGetLastError();
}

enum Entry { PREFILL, SMALL_M, NAIVE };

// One decode launch (M <= SK_MAX_M, K % 4 == 0): the pipelined entry's
// small-M kernel, or the naive entry's decode kernel with 16-byte / 4-byte
// row loads (vec) or plain ones.  The small-M kernel's zero column takes
// its shared memory past 48 KB at a slice of SK_SMEM: the launch then
// raises the kernel's limit first.
template <typename T, int MT>
int launch_decode(Entry entry, bool vec, dim3 grid, int smem,
                  cudaStream_t st, const void* x, const void* values,
                  const void* indices, float* out, int m, int n, int k,
                  int n_sel, int m_group, int slice_groups) {
  auto go = entry == SMALL_M ? nm_spmm_small_m_kernel<T, MT>
            : vec            ? nm_spmm_naive_small_m_kernel<T, MT, true>
                             : nm_spmm_naive_small_m_kernel<T, MT, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        go, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  go<<<grid, SK_THREADS, smem, st>>>((const T*)x, (const float*)values,
                                     (const int8_t*)indices, out, m, n, k,
                                     n_sel, m_group, slice_groups);
  return 0;
}

// ws: the (slices, M, K) fp32 workspace when slices > 1; for the prefill
// kernels the (N, ceil(M / PF_MT) * PF_MT) column-major copy of x in x's
// type (the naive one's in fp32), the pipelined one's followed, after N mp
// fp32 elements, by its ceil(N / 32) x mp / 32 int non-finite flags;
// unused else.  Decode shapes (M <= SK_MAX_M, K % 4 == 0) take the
// small-M kernel (pipelined) or the naive decode kernel, on a grid of
// (ceil(K / SK_TK), slices); the others the prefill kernel (pipelined) or
// the naive prefill one, with one slice, after nm_transpose_x_kernel.
// Refuses (cudaErrorInvalidValue) a split a kernel cannot follow and, for
// the small-M kernel, other shapes, values off 16 bytes or indices off 4.
template <typename T>
int launch(const void* x, const void* values, const void* indices, void* y,
           void* ws, int m, int n, int k, int n_sel, int m_group, int slices,
           int slice_groups, Entry entry, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || m_group < 1 || m_group > XC ||
      n_sel < 1 || n_sel > m_group || n % m_group || slice_groups < 1)
    return (int)cudaErrorInvalidValue;
  const int groups = n / m_group;
  const bool decode = m <= SK_MAX_M && k % 4 == 0;
  if (slices != (groups + slice_groups - 1) / slice_groups ||
      (slices > 1 && (entry == PREFILL || !decode)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float* out = slices > 1 ? (float*)ws : (float*)y;
  const bool aligned =
      (uintptr_t)values % 16 == 0 && (uintptr_t)indices % 4 == 0;
  if (entry == SMALL_M || (entry == NAIVE && decode)) {
    const int mt = m <= 1 ? 1 : m <= 2 ? 2 : m <= 4 ? 4 : m <= 8 ? 8 : 16;
    const long smem =
        (long)mt * std::min(slice_groups, groups) * m_group * sizeof(float);
    if (!decode || smem > SK_SMEM || (entry == SMALL_M && !aligned))
      return (int)cudaErrorInvalidValue;
    dim3 grid((k + SK_TK - 1) / SK_TK, slices);
    int (*go)(Entry, bool, dim3, int, cudaStream_t, const void*,
              const void*, const void*, float*, int, int, int, int, int,
              int);
    switch (mt) {
      case 1: go = launch_decode<T, 1>; break;
      case 2: go = launch_decode<T, 2>; break;
      case 4: go = launch_decode<T, 4>; break;
      case 8: go = launch_decode<T, 8>; break;
      default: go = launch_decode<T, 16>;
    }
    const int e = go(entry, aligned, grid,
                     (int)smem + (entry == SMALL_M ? mt * (int)sizeof(float)
                                                   : 0),
                     st, x, values, indices, out, m, n, k, n_sel, m_group,
                     slice_groups);
    if (e) return e;
  } else {
    const int mp = (m + PF_MT - 1) / PF_MT * PF_MT;
    const bool vec = k % 16 == 0 && (uintptr_t)values % 16 == 0 &&
                     (uintptr_t)indices % 16 == 0;
    const dim3 tgrid((n + 31) / 32, mp / 32);
    int e;
    if (entry == NAIVE) {
      using XS = float;                      // x's type in the copy
      XS* xt = (XS*)ws;                      // (n, mp)
      nm_transpose_x_kernel<T, XS><<<tgrid, dim3(32, 8), 0, st>>>(
          (const T*)x, xt, m, mp, n, nullptr);
      // the big tile unless its grid has fewer than NV_MIN_GRID blocks
      const bool big = (long)((m + NaiveBig::TM - 1) / NaiveBig::TM) *
                           ((k + NaiveBig::TK - 1) / NaiveBig::TK) >=
                       NV_MIN_GRID;
      int (*go)(const XS*, const void*, const void*, float*, int, int, int,
                int, int, int, cudaStream_t) =
          big ? (vec ? launch_naive_prefill<NaiveBig, XS, true>
                     : launch_naive_prefill<NaiveBig, XS, false>)
              : (vec ? launch_naive_prefill<NaiveSmall, XS, true>
                     : launch_naive_prefill<NaiveSmall, XS, false>);
      e = go(xt, values, indices, (float*)y, m, mp, n, k, n_sel, m_group,
             st);
    } else {
      T* xt = (T*)ws;                        // (n, mp) in x's type
      int* flags = (int*)((float*)ws + (size_t)n * mp);
      nm_transpose_x_kernel<T, T, true><<<tgrid, dim3(32, 8), 0, st>>>(
          (const T*)x, xt, m, mp, n, flags);
      const int run_groups = std::max(1, PF_XC / m_group);
      // the big tile unless its grid has fewer blocks than the card's 132
      // SMs
      const bool big = (long)((m + BigTile::TM - 1) / BigTile::TM) *
                           ((k + BigTile::TK - 1) / BigTile::TK) >= 132;
      int (*go)(const T*, const void*, const void*, float*, int, int, int,
                int, int, int, int, const int*, cudaStream_t) =
          big ? (vec ? launch_prefill<BigTile, T, true>
                     : launch_prefill<BigTile, T, false>)
              : (vec ? launch_prefill<SmallTile, T, true>
                     : launch_prefill<SmallTile, T, false>);
      e = go(xt, values, indices, (float*)y, m, mp, n, k, n_sel, m_group,
             run_groups, flags, st);
    }
    if (e) return e;
  }
  int err = (int)cudaGetLastError();
  if (err || slices == 1) return err;
  const int mk4 = m * k / 4;
  nm_reduce_kernel<<<(mk4 + RED_THREADS - 1) / RED_THREADS, RED_THREADS, 0,
                     st>>>((const float4*)ws, (float4*)y, slices, mk4);
  return (int)cudaGetLastError();
}

}  // namespace

#define NM_ENTRY(name, T, entry)                                          \
  extern "C" int name(const void* x, const void* values, const void* indices, \
                      void* y, void* ws, int m, int n, int k, int n_sel,      \
                      int m_group, int slices, int slice_groups,              \
                      void* stream) {                                         \
    return launch<T>(x, values, indices, y, ws, m, n, k, n_sel, m_group,      \
                     slices, slice_groups, entry, stream);                    \
  }

NM_ENTRY(nm_spmm_f32, float, PREFILL)
NM_ENTRY(nm_spmm_bf16, __nv_bfloat16, PREFILL)
NM_ENTRY(nm_spmm_small_m_f32, float, SMALL_M)
NM_ENTRY(nm_spmm_small_m_bf16, __nv_bfloat16, SMALL_M)
NM_ENTRY(nm_spmm_naive_f32, float, NAIVE)
NM_ENTRY(nm_spmm_naive_bf16, __nv_bfloat16, NAIVE)
