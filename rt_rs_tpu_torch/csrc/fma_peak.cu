// Kernel G: the f32 peak probe, FMA chains held in registers.
//
// Replaces experiments/roofline.py::_fma_kernel (TPU kernel 7).  Input
// x [grid * 16 * 8, 128] f32; output [grid * 8, 128] f32.  Output
// element (g, r, col) (row g * 8 + r) is computed by one thread from 16
// independent chains, chain c starting at x[g * 128 + 8 * c + r, col] + c
// and stepped `iters` times as acc = acc * 0.999999 + 1e-7; the thread
// writes ((acc_0 + acc_1) + acc_2) + ... + acc_15.
//
// Two variants, one source:
//   fused (1): each step is one explicit fmaf, the FFMA instruction
//     whose throughput the data sheet's 67 TFLOP/s assumes (2 flops);
//   separate (0): __fmul_rn then __fadd_rn, the two rounded
//     instructions every -fmad=false kernel of this port executes for a
//     multiply-add: the same instruction rate at half the flops.
// The build passes -fmad=false, so neither variant depends on the
// compiler contracting anything: fused gets its FMA from fmaf.
//
// What bounds it: the FP32 instruction rate.  16 independent chains per
// thread hide the FMA latency (4 cycles) many times over, nothing is
// read after the first 16 loads, and 262,144 threads fill the 132 SMs
// about once (2,048 resident threads each).  Its time against the
// flops is the card's practical f32 rate, with and without FMA.
#include "common.cuh"

constexpr int kChains = 16;
constexpr int kRows = 8;
constexpr int kCols = 128;

template <bool FUSED>
__global__ void fma_peak_kernel(const float* __restrict__ x,
                                float* __restrict__ out, int grid,
                                int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // output element
  if (i >= grid * kRows * kCols) return;
  const int g = i / (kRows * kCols);
  const int r = (i / kCols) % kRows;
  const int col = i % kCols;
  float acc[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c)
    acc[c] = x[((long)g * kChains * kRows + kRows * c + r) * kCols + col] +
             (float)c;
  const float a = 0.999999f, b = 1e-7f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c)
      acc[c] = FUSED ? fmaf(acc[c], a, b) : __fadd_rn(__fmul_rn(acc[c], a), b);
  }
  float s = acc[0];
#pragma unroll
  for (int c = 1; c < kChains; ++c) s = s + acc[c];
  out[i] = s;
}

RT_EXPORT int rt_fma_peak(const float* x, float* out, int grid, int iters,
                          int fused, cudaStream_t stream) {
  const int n = grid * kRows * kCols;
  if (n > 0) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    if (fused)
      fma_peak_kernel<true><<<blocks, threads, 0, stream>>>(x, out, grid, iters);
    else
      fma_peak_kernel<false><<<blocks, threads, 0, stream>>>(x, out, grid, iters);
  }
  return (int)cudaGetLastError();
}
