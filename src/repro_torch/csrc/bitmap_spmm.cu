// Block-bitmap compressed matmul for Hopper (sm_90a): Y = X @ W.
//
// Two kernels, one per Pallas TPU kernel of src/repro/kernels/bitmap_spmm.py:
//   bitmap_spmm_{f32,bf16}          replace `_pipelined_kernel` (launched by
//   bitmap_spmm_small_m_{f32,bf16}  `_bitmap_spmm_pipelined`, the default
//   bitmap_spmm_tiled_{f32,bf16}    path of repro.kernels.ops.bitmap_spmm):
//                                   the first at prefill, the second at
//                                   decode, the third for operands neither
//                                   takes;
//   bitmap_spmm_naive_{f32,bf16}    replaces `_kernel` (launched by
//                                   `bitmap_spmm_pallas` with
//                                   pipeline=False).
// The wrapper (repro_torch/kernels/bitmap_spmm.py) picks the entry, the
// summation order and the prefill tile; the entries only refuse what they
// cannot run.
//
// Format (the B(N1)-B(K1)-None(N2,K2) bitmap, pre-decoded to CSC):
//   blocks  (nnzb, bn, bk) fp32  non-zero payload blocks, block-column major
//   counts  (K/bk,) int32        non-zero blocks in each block-column
//   offsets (K/bk,) int32        exclusive cumsum of counts
//   row_ids (nnzb,) int32        block-row of each stored block
// x (M, N) is fp32 or bf16 and is converted to fp32 exactly; y (M, K) fp32.
// The kept rows of block-column kj, in stored order (block t, then row r),
// are the rows (offsets[kj] + t) * bn + r of blocks viewed as (nnzb*bn, bk):
// one contiguous run; kept row t * bn + r reads x column row_ids[off+t]*bn+r.
//
// Summation order, shared by all entries (the host function
// repro_torch.kernels.bitmap_spmm.split_plan picks S and P and passes them
// in): each kept block's bn rows are cut into pieces of BC = 32 rows, the
// last one ragged (856 = 26*32 + 24), and a column's pieces, in stored
// order, into S slices of P pieces; a column with fewer kept blocks than the
// longest has empty trailing slices, whose partials are zeros.  Each
// output's slice partial is summed from 0 with fmaf in ascending kept-row
// order, and the partials are added left to right, s = 0 .. S-1, by
// bitmap_reduce_kernel from a workspace (S, M, K) fp32 that the wrapper
// allocates.  S = 1 at prefill (M > 16), and wherever the decode entry
// cannot take the operands: one slice, written straight to y.  No atomics:
// deterministic.  Zero rows padded into a chunk add fmaf(0, 0, acc) == acc,
// so where the entries pad does not change a sum.
//
// Prefill entry (bitmap_spmm_*, M > 16, bk % 4 == 0, blocks 16-byte aligned,
// S = 1): bitmap_transpose_x_kernel, then
// bitmap_spmm_prefill_kernel<Tile, false>.  A kept block is a DENSE bn x bk
// tile, and kept row (t, r) multiplies one whole x column against one
// contiguous payload row, so each x value feeds every output column of a
// tile and each payload value every output row: the register-blocked outer
// product of a dense SGEMM applies, over the kept rows only.  At M = 512 the
// work is fp32 FMAs (half the dense 208.8 GFLOP of a chatglm3-6b layer at
// block density 0.5), and what paces it is shared memory feeding them: a
// warp's 16-byte shared load costs the SM about 4 cycles
// (tools/lds_bench.cu), against 4 warp FMAs a cycle.
// - x is staged transposed: the transpose kernel first copies x into the
//   workspace as (N, mp) fp32, mp = M rounded up to PF_MT, padded rows
//   zero (bf16 widened exactly), so one kept row's x values for an M tile
//   are TM contiguous floats at xt[row_ids[off + t] * bn + r].
// - A thread owns RM x RK outputs in registers: BigTile 8 x 8 (64 x 128
//   outputs a block of 128 threads, at most 128 registers: four blocks an
//   SM), SmallTile 4 x 4 (32 x 32, 64 threads) for grids the big tile
//   cannot spread over the card (wk / wv, K = 256; small M).  Per kept row
//   a thread reads its RM x values and RK payload values as RM/4 + RK/4
//   16-byte shared loads (rows ty*4 + TY*4*g, columns tx*4 + TX*4*g) and
//   does RM*RK FMAs: 16 FMAs a load for the big tile, where the tiled entry
//   does 2.  A warp is 2 x 16 threads: its x loads touch 2 distinct 16-byte
//   words (2.65 SM cycles against 4.06 at 4 or more, tools/lds_bench.cu),
//   its payload loads 16 contiguous ones; all lanes read within one staged
//   row, so no bank conflicts and no padding.
// - Staging is asynchronous: chunks of BC kept rows of the column's run (a
//   chunk may straddle a kept block: each row finds its own x column; rows
//   past the run load zeros) are copied by 16-byte cp.async into a ring of
//   STAGES chunks in dynamic shared memory (x: BC x TM, the payload: BC x
//   TK floats) while the FMAs read an earlier stage; one barrier per chunk.
//   BigTile: 4 chunks of 16 rows; SmallTile, whose blocks are too few to
//   hide a barrier, 3 chunks of 64.
// - The grid is (M tiles, column tiles, block-columns) with M fastest: the
//   M tiles of one column tile run side by side, so the payload comes from
//   HBM about once and from L2 for the others (the tiled entry streamed it
//   once per 64-row M tile).
// - The host function prefill_plan picks the tile from host integers: the
//   big tile when its grid has at least 132 blocks (one per SM), else the
//   small one.  Masks sit in the loads and the store, never around the
//   FMAs.  Each output is summed from 0 with fmaf over its column's kept
//   rows in stored order, as the tiled and naive entries sum it: the same
//   bits.
//
// Tiled entry (bitmap_spmm_tiled_*, operands the prefill and decode entries
// cannot take: bk % 4 != 0 or blocks off 16 bytes, S = 1):
// bitmap_spmm_kernel<T, false>.  Each thread block owns one TM x tk
// output tile (tk <= 64 divides bk, so a tile lies in one block-column) and
// keeps it in registers, 4 x 4 values per thread.  It walks ONLY the
// non-zero blocks of its column, in stored order; within a block it reduces
// over bn in chunks of BC rows (the pieces) staged in shared memory (x slice
// and payload slice), masking the ragged last chunk and the ragged M edge.
// counts[kj] == 0 writes zeros.  The format block is NOT the CUDA tile:
// planned blocks are up to 1024 x 13696 (56 MB in fp32), far beyond shared
// memory.
//
// Decode entry (bitmap_spmm_small_m_*, M <= 16, bk % 4 == 0, blocks 16-byte
// aligned): bitmap_spmm_small_m_kernel<T, MT, false>.  The shipped plans have
// one block-column per role (bk = K), so the tiled grid gives a role K/64
// blocks (4 for K = 256), each walking up to 6,848 kept rows with 60 of its
// 64 tile rows idle.  At M = 4 the work is a stream of the payload with 8
// FLOPs per kept row and column, so this design is about bytes in
// flight.  The grid is (column tiles of SK_TK x block-columns, S): a tile
// never crosses a block-column, since its walk depends on counts[kj]; a
// ragged last tile (bk = 13696 = 53.5 tiles) is masked at the load (dead
// threads read a live column) and the store.  A block of SK_THREADS threads
// stages its slice of x once in shared memory as fp32, column-major ([kept
// row][MT]), MT = M rounded up to 1, 2, 4, 8 or 16 (a template parameter: no
// dead rows in the FMA nest; padded rows are zeros, masked at the store),
// gathering x column row_ids[off + t] * bn + r for kept row (t, r); the
// staged slice is padded with zero rows to a multiple of SK_ROWS.  A thread
// owns 4 adjacent output columns x MT rows in registers; per kept row it
// makes one 16-byte read-only load of the payload, neighbouring threads on
// neighbouring addresses, SK_ROWS rows per batch, the next batch issued
// before the current one's FMAs.  Rows past the slice's end load zeros (mask
// in the load) and meet zero x rows, so no branch sits in the FMA nest.
//
// Naive entry (bitmap_spmm_naive_*): the TPU grid (M/bm, K/bk, t_max) read
// for what it does: its sequential third axis becomes a walk over t <
// t_max inside the thread block, with the STATIC bound t_max (a kernel
// argument, the caller's max-over-layers bound) instead of counts[kj].
// Every step reads the block at min(offsets[kj] + t, nnzb - 1) and the x
// columns of its row id, as the TPU BlockSpec index maps fetch them (so
// nothing reads past nnzb; density 0 stores one padded zero block with all
// counts 0), and a step with t >= counts[kj] runs no FMA.  The live steps
// are exactly t < counts[kj] and come first, so the naive entry is the
// pipelined entry's kernel for the same operands with a compile-time
// switch NAIVE: the live steps walked by the very same code (so the same
// sums in the same order: the naive result equals the pipelined one bit
// for bit, as the reference pins its two TPU kernels), then, after the
// output is stored, the masked steps' reads, outside the FMA loop nest.
// The C launch picks the kernel from the shape and alignment, as the
// pipelined entries are picked (kernels/bitmap_spmm.py::naive_kernel names
// them):
// - decode (M <= 16, bk % 4 == 0, blocks 16-byte aligned):
//   bitmap_spmm_small_m_kernel<T, MT, true> on the decode grid and order,
//   then bitmap_reduce_kernel where S > 1.  The masked steps are cut into
//   pieces as the live ones are; slice s's block takes the masked pieces in
//   its range [s P, (s+1) P), and the last slice's also every piece from S P
//   up to t_max q (t_max above the plan's longest column).  Each masked row
//   is one 16-byte cp.async per thread into a one-slot-per-thread sink in
//   shared memory, and its x columns 4-byte cp.asyncs: a copy into shared
//   memory is a side effect the compiler keeps, where a register load whose
//   value is never used would be deleted.
// - prefill (M > 16, same operands): bitmap_transpose_x_kernel, then
//   bitmap_spmm_prefill_kernel<Tile, true> on prefill_plan's tile and grid;
//   the masked steps' kept rows [counts[kj] bn, t_max bn) are copied in
//   chunks through the same cp.async ring and waited on, and no FMA reads
//   them.
// - anything else: bitmap_spmm_kernel<T, true>, the tiled entry's walk with
//   one slice, then the masked steps' blocks staged into its shared tiles.
// No branch sits in the FMA loop nest: versions with one (a shared step
// function, or an `if (live)` around the FMAs) compiled to 48 registers
// with spills and ran at twice the decode time.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s fp32 without tensor
// cores): bytes = stored payload (nnz blocks * bn * bk * 4) + metadata
// + x + y, against 2 * M * (nnz blocks * bn * bk) FLOPs -- the same work
// for every entry.  Decode (M = 4) is bound by the payload bytes (407.8 MB
// per chatglm3-6b layer at block density 0.5: 0.1220 ms); prefill (M = 512)
// by the fp32 FLOPs (104.4 GFLOP a layer: 1.5585 ms).  The partials' round
// trip (2 * S * M * K * 4 bytes, mostly in L2) is kept under 10 % of the
// payload at decode.  The static bound costs the naive entry (t_max -
// counts[kj]) extra block reads per block-column and column tile, FMAs
// skipped; the shipped plans have none (t_max == counts[kj]).
//
// What the design leaves on the table: the decode loads are synchronous
// register loads, not a cp.async / TMA ring; the payload is fp32 (bf16
// would halve the decode bytes, at another rounding); the K = 256 roles
// (wk, wv) get one column tile and at most rows / (20 M) slices under the
// partials cap, so they stay latency-bound at decode, and 128 small tiles
// at prefill (no split of the reduction there: its order is the naive
// entry's); the prefill entry runs fp32 FMAs on CUDA cores, about as many
// 16-byte shared loads as the SM can serve beside them, where the tensor
// cores would run 15x the rate but round through TF32 (past the 1e-4
// kernel-vs-plain bound and the naive entry's bits); it uses no TMA, no
// warp specialisation and no persistent blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;        // output rows per thread block
constexpr int TK = 64;        // output columns per thread block (tk <= TK)
constexpr int BC = 32;        // reduction rows staged per step: one piece
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

constexpr int SK_MAX_M = 16;            // largest M (MT) of the decode entry
constexpr int SK_THREADS = 64;          // threads of a decode block
constexpr int SK_TK = 4 * SK_THREADS;   // its output columns
constexpr int SK_ROWS = 8;              // kept rows per load batch
constexpr int SK_SMEM = 48 * 1024;      // its x slice, bytes at most
constexpr int RED_THREADS = 256;        // threads of a reduce block
constexpr int MAX_SLICES = 65535;       // grid.y

constexpr int PF_MT = 128;     // prefill: rows of the x copy, a multiple of it

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store_tile(const float (&acc)[4][4],
                                           float* __restrict__ out, int m0,
                                           int k0, int m, int k, int tk,
                                           int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      if (col < tk) out[(size_t)row * k + k0 + col] = acc[i][j];
    }
  }
}

// NAIVE = false is the tiled entry; NAIVE = true adds the naive entry's
// masked steps after the same walk over the live steps (a compile-time
// switch, so no branch enters the FMA loop nest).  One slice, written to
// y; nnzb and t_max are read only by the naive instance.
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

  store_tile(acc, y, m0, k0, m, k, tk, tx, ty);
}

// 16 bytes global -> shared without a register; `bytes` 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
// 4 bytes global -> shared (through L1: the .cg form takes 16 only).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
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

// The next SK_ROWS kept rows, of which `left` are in the slice: one float4
// each; wp steps to the row after.  Rows past the slice's end load zeros.
__device__ __forceinline__ void load_rows(const float4*& wp, int step,
                                          int left, float4 (&v)[SK_ROWS]) {
#pragma unroll
  for (int u = 0; u < SK_ROWS; ++u) {
    v[u] = u < left ? __ldg(wp) : make_float4(0.f, 0.f, 0.f, 0.f);
    wp += step;
  }
}

// The MT staged x values of one kept row.
template <int MT>
__device__ __forceinline__ void load_x(const float* xr, float (&xv)[MT]) {
  if constexpr (MT == 1) {
    xv[0] = xr[0];
  } else if constexpr (MT == 2) {
    const float2 t = *reinterpret_cast<const float2*>(xr);
    xv[0] = t.x;
    xv[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < MT; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(xr + i);
      xv[i] = t.x;
      xv[i + 1] = t.y;
      xv[i + 2] = t.z;
      xv[i + 3] = t.w;
    }
  }
}

// Start of piece p among a block-column's kept rows: block p / q, row
// (p % q) * BC, q = ceil(bn / BC) pieces a block.
__device__ __forceinline__ int piece_row(int p, int q, int bn) {
  return p / q * bn + p % q * BC;
}

// The naive decode entry's masked pieces [p0, p1) of a block-column whose
// stored blocks start at off, read and dropped.  Piece p is the rows
// p % q * BC (up to BC, within bn) of TPU step t = p / q >= counts[kj],
// whose block the index maps fetch at min(off + t, nnzb - 1): this
// thread's 4 payload columns of each row (16 bytes) and, shared by the
// block, the m rows of x at the columns of that block's row id.  Every
// read is a cp.async into this thread's slot of `sink` in shared memory: a
// copy into shared memory is a side effect the compiler keeps (a register
// load whose value is never used would be deleted), and it takes no
// register and no FMA.  Copies into one slot may land in any order:
// nothing reads the sink.  x is read in 4-byte words, cp.async's least, the
// first word of a run rounded down to 4 bytes (for bf16 x it may start 2
// bytes before the run, inside the same word of x's allocation).
template <typename T>
__device__ __forceinline__ void masked_reads(
    const T* __restrict__ x, const float* __restrict__ blocks,
    const int* __restrict__ row_ids, float4* sink, int off, int lcb, int m,
    int n, int bn, int bk, int q, int nnzb, int p0, int p1) {
  constexpr int XW = BC * (int)sizeof(T) / 4 + 1;   // words of a run, at most
  float4* const slot = sink + threadIdx.x;
  for (int p = p0; p < p1; ++p) {
    const int at = min(off + p / q, nnzb - 1);
    const int r0 = p % q * BC, len = min(BC, bn - r0);
    const float* w = blocks + ((size_t)at * bn + r0) * bk + lcb;
#pragma unroll 8
    for (int r = 0; r < len; ++r) cp_async16(slot, w + (size_t)r * bk, 16);
    const T* xr = x + (size_t)row_ids[at] * bn + r0;
    for (int e = threadIdx.x; e < m * XW; e += SK_THREADS) {
      const int i = e / XW, f = e - i * XW;
      const uintptr_t a = (uintptr_t)(xr + (size_t)i * n);
      const uintptr_t word = (a & ~(uintptr_t)3) + 4 * f;
      if (word < a + len * sizeof(T))
        cp_async4(slot, reinterpret_cast<const void*>(word));
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
}

// Shared memory of a decode block: the slice's x, [slice row][MT] fp32,
// and for the naive instance a sink of one float4 a thread after it.
template <bool NAIVE>
constexpr long small_m_smem(int mt, int slice_pieces) {
  return (long)mt * slice_pieces * BC * sizeof(float) +
         (NAIVE ? SK_THREADS * sizeof(float4) : 0);
}

// Decode entry (M <= SK_MAX_M): the partial of slice blockIdx.y over
// output columns [4 * thread, +4) of column tile blockIdx.x % tiles of
// block-column blockIdx.x / tiles, into out + slice * M * K (out is y
// itself when S = 1).  Needs bk % 4 == 0 and blocks 16-byte aligned.
// NAIVE adds, after the store, the naive entry's masked pieces that fall to
// this slice (masked_reads); nnzb and t_max are read only then.
template <typename T, int MT, bool NAIVE>
__global__ void __launch_bounds__(SK_THREADS)
bitmap_spmm_small_m_kernel(const T* __restrict__ x,
                           const float* __restrict__ blocks,
                           const int* __restrict__ counts,
                           const int* __restrict__ row_ids,
                           const int* __restrict__ offsets,
                           float* __restrict__ out, int m, int n, int k,
                           int bn, int bk, int tiles, int slice_pieces,
                           int nnzb, int t_max) {
  extern __shared__ float4 xs4[];
  float* xs = reinterpret_cast<float*>(xs4);   // [slice row][MT], fp32
  const int kj = blockIdx.x / tiles;
  const int cb = (blockIdx.x - kj * tiles) * SK_TK + 4 * threadIdx.x;
  const int lcb = min(cb, bk - 4);             // dead columns read a live one
  const int q = (bn + BC - 1) / BC;
  const int cnt = counts[kj], off = offsets[kj];
  const int pend = cnt * q;                    // the column's pieces
  const int p0 = min((int)blockIdx.y * slice_pieces, pend);
  const int p1 = min(p0 + slice_pieces, pend);
  const int r0 = piece_row(p0, q, bn);         // kept rows [r0, r1)
  const int rows = piece_row(p1, q, bn) - r0;
  const int step = bk / 4;                     // one row, in float4s
  const float4* wp = reinterpret_cast<const float4*>(
      blocks + ((size_t)off * bn + r0) * bk + lcb);
  float4 v[SK_ROWS];
  load_rows(wp, step, rows, v);                // in flight while x is staged

  const int rp = (rows + SK_ROWS - 1) / SK_ROWS * SK_ROWS;
  for (int e = threadIdx.x; e < MT * rp; e += SK_THREADS) {
    const int i = e / rp, c = e - i * rp;
    float val = 0.f;
    if (i < m && c < rows) {
      const int r = r0 + c, t = r / bn;
      val = to_f32(x[(size_t)i * n + (size_t)row_ids[off + t] * bn + r -
                     t * bn]);
    }
    xs[c * MT + i] = val;
  }
  __syncthreads();

  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int u0 = 0; u0 < rows; u0 += SK_ROWS) {
    float4 vn[SK_ROWS];
    load_rows(wp, step, rows - u0 - SK_ROWS, vn);     // next batch
#pragma unroll
    for (int u = 0; u < SK_ROWS; ++u) {
      const float b[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      float xv[MT];
      load_x<MT>(xs + (u0 + u) * MT, xv);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < MT; ++i) acc[i][j] = fmaf(xv[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int u = 0; u < SK_ROWS; ++u) v[u] = vn[u];
  }

  if (cb < bk) {
    float* o = out + (size_t)blockIdx.y * m * k + (size_t)kj * bk + cb;
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if (i < m)
        *reinterpret_cast<float4*>(o + (size_t)i * k) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }

  if constexpr (NAIVE) {
    // the masked pieces [counts[kj] q, t_max q) in this slice's range
    // [s P, (s + 1) P); the last slice also takes those from S P on.  The
    // column's scalars are read again here, so that none of them stays
    // live across the FMA loop (keeping them cost the MT = 2 instance a
    // spill)
    const int c = blockIdx.x / tiles;
    const int col = min((int)(blockIdx.x - c * tiles) * SK_TK +
                            4 * (int)threadIdx.x, bk - 4);
    const int pieces = (bn + BC - 1) / BC;
    const int s0 = (int)blockIdx.y * slice_pieces, mend = t_max * pieces;
    const int s1 = blockIdx.y + 1 == gridDim.y
                       ? mend
                       : min(s0 + slice_pieces, mend);
    masked_reads<T>(x, blocks, row_ids, xs4 + MT * slice_pieces * BC / 4,
                    __ldcg(offsets + c), col, m, n, bn, bk, pieces, nnzb,
                    max(s0, __ldcg(counts + c) * pieces), s1);
  }
}

// y = ws[0] + ws[1] + ... + ws[S-1], left to right, four outputs a thread.
__global__ void __launch_bounds__(RED_THREADS)
bitmap_reduce_kernel(const float4* __restrict__ ws, float4* __restrict__ y,
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

// xt[c * mp + i] = x[i, c] as fp32 for i < m, 0 for m <= i < mp: the
// prefill entry's transposed copy of x, mp a multiple of PF_MT.
template <typename T>
__global__ void __launch_bounds__(256)
bitmap_transpose_x_kernel(const T* __restrict__ x, float* __restrict__ xt,
                          int m, int mp, int n) {
  __shared__ float t[32][33];
  const int c0 = blockIdx.x * 32, i0 = blockIdx.y * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int i = i0 + r, c = c0 + threadIdx.x;
    t[r][threadIdx.x] = i < m && c < n ? to_f32(x[(size_t)i * n + c]) : 0.f;
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int c = c0 + r;
    if (c < n) xt[(size_t)c * mp + i0 + threadIdx.x] = t[threadIdx.x][r];
  }
}

// A prefill tile: TY x TX threads, each owning RM x RK outputs, so a block
// owns TM = TY * RM rows x TK = TX * RK columns; a ring of STAGES chunks of
// BC kept rows.  MIN_BLOCKS per SM caps the registers at 65536 / (NT *
// MIN_BLOCKS).
template <int TY_, int TX_, int RM_, int RK_, int MIN_BLOCKS_, int STAGES_,
          int BC_>
struct PTile {
  static constexpr int TY = TY_, TX = TX_, RM = RM_, RK = RK_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_, STAGES = STAGES_, BC = BC_;
  static constexpr int NT = TY * TX, TM = TY * RM, TK = TX * RK;
};
using BigTile = PTile<8, 16, 8, 8, 4, 4, 16>;    // 64 x 128, 128 threads
using SmallTile = PTile<8, 8, 4, 4, 8, 3, 64>;   // 32 x 32, 64 threads

template <class TT>
constexpr int prefill_smem() {
  return TT::STAGES * TT::BC * (TT::TM + TT::TK) * (int)sizeof(float);
}

// Prefill entry: the TT::TM x TT::TK output tile (blockIdx.x, blockIdx.y)
// of block-column blockIdx.z.  xt: bitmap_transpose_x_kernel's (N, mp)
// copy of x.  Thread (ty, tx) owns rows ty*4 + TY*4*g + (0..3) and columns
// tx*4 + TX*4*g + (0..3) of the tile.  Needs bk % 4 == 0 and blocks
// 16-byte aligned.  NAIVE adds, after the store, the naive entry's masked
// steps' copies; nnzb and t_max are read only then.
template <class TT, bool NAIVE>
__global__ void __launch_bounds__(TT::NT, TT::MIN_BLOCKS)
bitmap_spmm_prefill_kernel(const float* __restrict__ xt,
                           const float* __restrict__ blocks,
                           const int* __restrict__ counts,
                           const int* __restrict__ row_ids,
                           const int* __restrict__ offsets,
                           float* __restrict__ y, int m, int mp, int k,
                           int bn, int bk, int nnzb, int t_max) {
  constexpr int TM = TT::TM, TK = TT::TK, RM = TT::RM, RK = TT::RK;
  constexpr int BC = TT::BC;
  constexpr int XQ = TM / 4, WQ = TK / 4;     // 16-byte copies per row
  constexpr int STAGE = BC * (TM + TK);       // floats of one stage
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int tx = threadIdx.x % TT::TX, ty = threadIdx.x / TT::TX;
  const int m0 = blockIdx.x * TM;
  const int c0 = blockIdx.y * TK;             // column offset in the block
  const int kj = blockIdx.z;
  const int off = offsets[kj];
  const int rows = counts[kj] * bn;           // the column's kept rows
  const int chunks = (rows + BC - 1) / BC;
  const float* const wcol = blocks + (size_t)off * bn * bk + c0;

  // the copies of chunk `ch` into stage `ch % STAGES`: x rows of the
  // kept rows' columns, then the payload rows; rows past the column's run
  // and columns past bk load zeros
  auto issue = [&](int ch) {
    float* const xs = smem + (ch % TT::STAGES) * STAGE;
    float* const ws = xs + BC * TM;
    const int r0 = ch * BC;
    const int t0 = r0 / bn;                   // kept block of row r0
    for (int e = threadIdx.x; e < BC * XQ; e += TT::NT) {
      const int q = e / XQ, f = e - q * XQ, r = r0 + q;
      const bool in = r < rows;
      int t = t0, rr = r - t0 * bn;           // kept row r is (t, rr)
      while (rr >= bn) {
        rr -= bn;
        ++t;
      }
      const float* src =
          in ? xt + ((size_t)row_ids[off + t] * bn + rr) * mp + m0 + 4 * f
             : xt;
      cp_async16(xs + q * TM + 4 * f, src, in ? 16 : 0);
    }
    for (int e = threadIdx.x; e < BC * WQ; e += TT::NT) {
      const int q = e / WQ, f = e - q * WQ, r = r0 + q;
      const bool in = r < rows && c0 + 4 * f < bk;
      cp_async16(ws + q * TK + 4 * f,
                 in ? wcol + (size_t)r * bk + 4 * f : blocks, in ? 16 : 0);
    }
  };

  float acc[RM][RK];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RK; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < TT::STAGES - 1; ++s) {
    if (s < chunks) issue(s);
    cp_async_commit();
  }
  for (int ch = 0; ch < chunks; ++ch) {
    cp_async_wait<TT::STAGES - 2>();
    __syncthreads();      // chunk ch has landed; chunk ch - 1's stage is free
    if (ch + TT::STAGES - 1 < chunks) issue(ch + TT::STAGES - 1);
    cp_async_commit();
    const float* const xs = smem + (ch % TT::STAGES) * STAGE + 4 * ty;
    const float* const ws = smem + (ch % TT::STAGES) * STAGE + BC * TM +
                            4 * tx;
#pragma unroll
    for (int q = 0; q < BC; ++q) {            // ascending kept rows
      float a[RM], b[RK];
#pragma unroll
      for (int g = 0; g < RM / 4; ++g) {
        const float4 v =
            *reinterpret_cast<const float4*>(xs + q * TM + 4 * TT::TY * g);
        a[4 * g] = v.x;
        a[4 * g + 1] = v.y;
        a[4 * g + 2] = v.z;
        a[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < RK / 4; ++g) {
        const float4 v =
            *reinterpret_cast<const float4*>(ws + q * TK + 4 * TT::TX * g);
        b[4 * g] = v.x;
        b[4 * g + 1] = v.y;
        b[4 * g + 2] = v.z;
        b[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = m0 + 4 * ty + 4 * TT::TY * (i / 4) + i % 4;
    if (row >= m) continue;
#pragma unroll
    for (int g = 0; g < RK / 4; ++g) {
      const int col = c0 + 4 * tx + 4 * TT::TX * g;
      if (col < bk)
        *reinterpret_cast<float4*>(y + (size_t)row * k + (size_t)kj * bk +
                                   col) =
            make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                        acc[i][4 * g + 3]);
    }
  }

  if constexpr (NAIVE) {
    // the masked steps counts[kj] <= t < t_max: their kept rows [rows,
    // t_max bn), of the block at min(off + t, nnzb - 1), copied in chunks
    // of BC rows through the same ring and waited on; no FMA reads them.
    // A thread's copies land in its own stage slots, so no barrier is
    // needed between chunks, only before the first (the FMAs' last reads)
    const int mend = t_max * bn;
    const int mchunks = (mend - rows + BC - 1) / BC;
    auto issue_masked = [&](int ch) {
      float* const xs = smem + (ch % TT::STAGES) * STAGE;
      float* const ws = xs + BC * TM;
      const int r0 = rows + ch * BC;
      for (int e = threadIdx.x; e < BC * XQ; e += TT::NT) {
        const int q = e / XQ, f = e - q * XQ, r = r0 + q, t = r / bn;
        const bool in = r < mend;
        const float* src =
            in ? xt + ((size_t)row_ids[min(off + t, nnzb - 1)] * bn + r -
                       t * bn) * mp + m0 + 4 * f
               : xt;
        cp_async16(xs + q * TM + 4 * f, src, in ? 16 : 0);
      }
      for (int e = threadIdx.x; e < BC * WQ; e += TT::NT) {
        const int q = e / WQ, f = e - q * WQ, r = r0 + q, t = r / bn;
        const bool in = r < mend && c0 + 4 * f < bk;
        const float* src =
            in ? blocks + ((size_t)min(off + t, nnzb - 1) * bn + r - t * bn) *
                              bk + c0 + 4 * f
               : blocks;
        cp_async16(ws + q * TK + 4 * f, src, in ? 16 : 0);
      }
    };
    if (mchunks > 0) {
      __syncthreads();
#pragma unroll
      for (int s = 0; s < TT::STAGES - 1; ++s) {
        if (s < mchunks) issue_masked(s);
        cp_async_commit();
      }
      for (int ch = 0; ch < mchunks; ++ch) {
        cp_async_wait<TT::STAGES - 2>();      // chunk ch has landed
        if (ch + TT::STAGES - 1 < mchunks) issue_masked(ch + TT::STAGES - 1);
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
  }
}

template <class TT, bool NAIVE>
int launch_prefill(const float* xt, const void* blocks, const void* counts,
                   const void* row_ids, const void* offsets, float* y, int m,
                   int mp, int k, int bn, int bk, int nnzb, int t_max,
                   cudaStream_t st) {
  constexpr int smem = prefill_smem<TT>();
  const cudaError_t e = cudaFuncSetAttribute(
      bitmap_spmm_prefill_kernel<TT, NAIVE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((m + TT::TM - 1) / TT::TM, (bk + TT::TK - 1) / TT::TK,
                  k / bk);
  bitmap_spmm_prefill_kernel<TT, NAIVE><<<grid, TT::NT, smem, st>>>(
      xt, (const float*)blocks, (const int*)counts, (const int*)row_ids,
      (const int*)offsets, y, m, mp, k, bn, bk, nnzb, t_max);
  return (int)cudaGetLastError();
}

template <typename T, int MT, bool NAIVE>
int launch_small_m(dim3 grid, cudaStream_t st, const void* x,
                   const void* blocks, const void* counts, const void* row_ids,
                   const void* offsets, float* out, int m, int n, int k,
                   int bn, int bk, int tiles, int slice_pieces, int nnzb,
                   int t_max) {
  const int smem = (int)small_m_smem<NAIVE>(MT, slice_pieces);
  if (smem > 48 * 1024) {                 // the naive sink past a full slice
    const cudaError_t e = cudaFuncSetAttribute(
        bitmap_spmm_small_m_kernel<T, MT, NAIVE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  bitmap_spmm_small_m_kernel<T, MT, NAIVE><<<grid, SK_THREADS, smem, st>>>(
      (const T*)x, (const float*)blocks, (const int*)counts,
      (const int*)row_ids, (const int*)offsets, out, m, n, k, bn, bk, tiles,
      slice_pieces, nnzb, t_max);
  return (int)cudaGetLastError();
}

// launch_small_m at the row template MT = mt.
template <typename T, bool NAIVE>
int launch_decode(int mt, dim3 grid, cudaStream_t st, const void* x,
                  const void* blocks, const void* counts, const void* row_ids,
                  const void* offsets, float* out, int m, int n, int k, int bn,
                  int bk, int tiles, int slice_pieces, int nnzb, int t_max) {
  decltype(&launch_small_m<T, 1, NAIVE>) go;
  switch (mt) {
    case 1: go = launch_small_m<T, 1, NAIVE>; break;
    case 2: go = launch_small_m<T, 2, NAIVE>; break;
    case 4: go = launch_small_m<T, 4, NAIVE>; break;
    case 8: go = launch_small_m<T, 8, NAIVE>; break;
    default: go = launch_small_m<T, 16, NAIVE>;
  }
  return go(grid, st, x, blocks, counts, row_ids, offsets, out, m, n, k, bn,
            bk, tiles, slice_pieces, nnzb, t_max);
}

enum Entry { PREFILL, TILED, SMALL_M, NAIVE };

// ws: the (slices, M, K) fp32 workspace when slices > 1; for the prefill
// kernels the (N, ceil(M / PF_MT) * PF_MT) fp32 transposed copy of x;
// unused else.  tile: the prefill kernel's tile, 0 BigTile, 1 SmallTile.
// The naive entry takes the kernel its shape and alignment allow, as the
// pipelined entries are picked: the decode kernel (M <= 16, bk % 4 == 0,
// blocks 16-byte aligned), the prefill kernels (M > 16, the same operands),
// else the tiled kernel.  Refuses (cudaErrorInvalidValue) what the kernel
// cannot run: S > 1 anywhere but the decode kernel, the decode kernel M >
// 16, bk % 4 != 0, blocks off 16 bytes or a slice whose x exceeds
// SK_SMEM, the prefill kernels M <= 16, bk % 4 != 0 or blocks off 16
// bytes.
template <typename T>
int launch(const void* x, const void* blocks, const void* counts,
           const void* row_ids, const void* offsets, void* y, void* ws,
           int m, int n, int k, int bn, int bk, int tk, int nnzb, int t_max,
           int slices, int slice_pieces, int tile, Entry entry,
           void* stream) {
  const bool naive = entry == NAIVE;
  const bool fast = bk % 4 == 0 && (uintptr_t)blocks % 16 == 0;
  const Entry route = !naive ? entry
                      : !fast ? TILED
                      : m <= SK_MAX_M ? SMALL_M
                                      : PREFILL;
  if (m <= 0 || n <= 0 || k <= 0 || bn <= 0 || bk <= 0 || tk <= 0 ||
      tk > TK || bk % tk || k % bk || n % bn ||
      (naive && (nnzb < 1 || t_max < 1)) || slices < 1 ||
      slices > MAX_SLICES || slice_pieces < 1 ||
      (slices > 1 && route != SMALL_M))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float* out = slices > 1 ? (float*)ws : (float*)y;
  if (route == PREFILL) {
    if (m <= SK_MAX_M || !fast || tile < 0 || tile > 1)
      return (int)cudaErrorInvalidValue;
    const int mp = (m + PF_MT - 1) / PF_MT * PF_MT;
    float* xt = (float*)ws;                  // (n, mp) fp32
    bitmap_transpose_x_kernel<T><<<dim3((n + 31) / 32, mp / 32), dim3(32, 8),
                                   0, st>>>((const T*)x, xt, m, mp, n);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    decltype(&launch_prefill<BigTile, false>) go =
        tile == 0 ? (naive ? launch_prefill<BigTile, true>
                           : launch_prefill<BigTile, false>)
                  : (naive ? launch_prefill<SmallTile, true>
                           : launch_prefill<SmallTile, false>);
    return go(xt, blocks, counts, row_ids, offsets, out, m, mp, k, bn, bk,
              nnzb, t_max, st);
  }
  int err;
  if (route == SMALL_M) {
    const int mt = m <= 1 ? 1 : m <= 2 ? 2 : m <= 4 ? 4 : m <= 8 ? 8 : 16;
    if (m > SK_MAX_M || !fast ||
        small_m_smem<false>(mt, slice_pieces) > SK_SMEM)
      return (int)cudaErrorInvalidValue;
    const int tiles = (bk + SK_TK - 1) / SK_TK;
    const dim3 grid(tiles * (k / bk), slices);
    err = (naive ? launch_decode<T, true> : launch_decode<T, false>)(
        mt, grid, st, x, blocks, counts, row_ids, offsets, out, m, n, k, bn,
        bk, tiles, slice_pieces, nnzb, t_max);
  } else {
    const dim3 grid(k / tk, (m + TM - 1) / TM);
    decltype(&bitmap_spmm_kernel<T, false>) go =
        naive ? bitmap_spmm_kernel<T, true> : bitmap_spmm_kernel<T, false>;
    go<<<grid, THREADS, 0, st>>>((const T*)x, (const float*)blocks,
                                 (const int*)counts, (const int*)row_ids,
                                 (const int*)offsets, out, m, n, k, bn, bk,
                                 tk, nnzb, t_max);
    err = (int)cudaGetLastError();
  }
  if (err || slices == 1) return err;
  const int mk4 = m * k / 4;
  bitmap_reduce_kernel<<<(mk4 + RED_THREADS - 1) / RED_THREADS, RED_THREADS,
                         0, st>>>((const float4*)ws, (float4*)y, slices, mk4);
  return (int)cudaGetLastError();
}

}  // namespace

#define BITMAP_ENTRY(name, T, entry)                                         \
  extern "C" int name(const void* x, const void* blocks, const void* counts, \
                      const void* row_ids, const void* offsets, void* y,     \
                      void* ws, int m, int n, int k, int bn, int bk, int tk, \
                      int nnzb, int t_max, int slices, int slice_pieces,     \
                      int tile, void* stream) {                              \
    return launch<T>(x, blocks, counts, row_ids, offsets, y, ws, m, n, k,    \
                     bn, bk, tk, nnzb, t_max, slices, slice_pieces, tile,    \
                     entry, stream);                                         \
  }

BITMAP_ENTRY(bitmap_spmm_f32, float, PREFILL)
BITMAP_ENTRY(bitmap_spmm_bf16, __nv_bfloat16, PREFILL)
BITMAP_ENTRY(bitmap_spmm_tiled_f32, float, TILED)
BITMAP_ENTRY(bitmap_spmm_tiled_bf16, __nv_bfloat16, TILED)
BITMAP_ENTRY(bitmap_spmm_small_m_f32, float, SMALL_M)
BITMAP_ENTRY(bitmap_spmm_small_m_bf16, __nv_bfloat16, SMALL_M)
BITMAP_ENTRY(bitmap_spmm_naive_f32, float, NAIVE)
BITMAP_ENTRY(bitmap_spmm_naive_bf16, __nv_bfloat16, NAIVE)
