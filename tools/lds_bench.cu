// Shared-memory load throughput on one card, by load width and by the
// number of distinct addresses the 32 lanes of a warp touch.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o lds_bench tools/lds_bench.cu
//   ./lds_bench
//
// Each of 8 blocks per SM (132 SMs) issues 16 loads per iteration, each
// followed by one FMA per loaded word, so the loads and not the FMAs set
// the pace.  The lanes read `distinct` words (lane % distinct), which lie in
// different banks.  Prints the time per warp-wide load per SM; cycles are
// at the clock `nvidia-smi --query-gpu=clocks.sm` reads, given as argv[1]
// in MHz (default 1980).  The N:M prefill kernel's design rests on these
// numbers (src/repro_torch/csrc/nm_spmm.cu).
#include <cuda_runtime.h>

#include <cstdio>
#include <cstdlib>

constexpr int SMS = 132, BLOCKS_PER_SM = 8, THREADS = 256, UNROLL = 16;

template <int DISTINCT, int WORDS>
__global__ void __launch_bounds__(THREADS) loads(float* out, int iters) {
  __shared__ float4 s[2048];
  for (int i = threadIdx.x; i < 2048; i += THREADS)
    s[i] = make_float4(i, i + 1, i + 2, i + 3);
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int f = DISTINCT >= 32 ? lane : lane % DISTINCT;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const int step = (it * UNROLL + j) & 63;   // same banks, new address
      if (WORDS == 4) {
        const float4 v = s[(f + 8 * step) & 2047];
        a0 = fmaf(v.x, 1.0001f, a0);
        a1 = fmaf(v.y, 1.0001f, a1);
        a2 = fmaf(v.z, 1.0001f, a2);
        a3 = fmaf(v.w, 1.0001f, a3);
      } else {
        const float* sf = reinterpret_cast<const float*>(s);
        a0 = fmaf(sf[(f + 32 * step) & 8191], 1.0001f, a0);
      }
    }
  }
  out[blockIdx.x * THREADS + threadIdx.x] = a0 + a1 + a2 + a3;
}

template <int DISTINCT, int WORDS>
void run(float* out, double mhz) {
  const int iters = 2048, blocks = SMS * BLOCKS_PER_SM;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  loads<DISTINCT, WORDS><<<blocks, THREADS>>>(out, 16);   // warm-up
  cudaEventRecord(a);
  loads<DISTINCT, WORDS><<<blocks, THREADS>>>(out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  const double per_sm = (double)blocks * (THREADS / 32) * iters * UNROLL / SMS;
  const double ns = ms * 1e6 / per_sm;
  printf("%2d-byte loads, %2d distinct words a warp: %.3f ms, %.3f ns = "
         "%.2f cycles per warp load per SM\n",
         4 * WORDS, DISTINCT, ms, ns, ns * mhz / 1e3);
}

int main(int argc, char** argv) {
  const double mhz = argc > 1 ? atof(argv[1]) : 1980.0;
  float* out;
  if (cudaMalloc(&out, sizeof(float) * SMS * BLOCKS_PER_SM * THREADS)) {
    fprintf(stderr, "lds_bench: no CUDA device\n");
    return 1;
  }
  run<1, 4>(out, mhz);
  run<2, 4>(out, mhz);
  run<4, 4>(out, mhz);
  run<8, 4>(out, mhz);
  run<32, 4>(out, mhz);
  run<1, 1>(out, mhz);
  run<4, 1>(out, mhz);
  run<32, 1>(out, mhz);
  cudaFree(out);
  return cudaGetLastError() != cudaSuccess;
}
