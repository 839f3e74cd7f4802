// Shared device helpers of the port's hand-written Hopper kernels.
//
// Every kernel here is built by rt_rs_tpu_torch/ops/cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -fmad=false -prec-div=true -prec-sqrt=true -ftz=false
// and never with --use_fast_math: the results must equal the plain
// PyTorch twins op for op, and those (like the JAX reference) round
// every multiply and add separately and divide with IEEE rounding.
// Expressions below are written in the reference's operation order
// (C evaluates a + b + c as (a + b) + c, as Python does).
//
// Each entry point has a plain C interface (pointers, sizes, the
// stream) and returns cudaGetLastError() right after its launch; the
// Python wrapper raises on a nonzero code.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define RT_EXPORT extern "C" __attribute__((visibility("default")))

// The port's trace counters (rt_rs_tpu_torch/tracing.py): an int64
// buffer, word 0 the enable flag, then kTraceSub words for each counter.
// A counting kernel takes the buffer and its first counter's index; a
// block reads the flag once and, when it is set, adds each of its counts
// with one atomicAdd into word blockIdx.x % kTraceSub of that counter, so
// that no word takes every block's atomic.  A null buffer counts nothing.
constexpr int kTraceSub = 32;  // SUB in tracing.py

__device__ __forceinline__ bool trace_on(const long long* trace) {
  return trace != nullptr && trace[0] != 0;
}

__device__ __forceinline__ void trace_add(long long* trace, int counter,
                                          long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(trace) + 1 +
                counter * kTraceSub + blockIdx.x % kTraceSub,
            static_cast<unsigned long long>(v));
}

// v summed over the block's threads, into thread 0's v; every thread of
// the block calls it.
template <int N>
__device__ __forceinline__ void block_sum(long long (&v)[N]) {
  __shared__ long long part[32][N];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    for (int off = 16; off > 0; off >>= 1)
      v[i] += __shfl_down_sync(0xffffffffu, v[i], off);
    if (lane == 0) part[warp][i] = v[i];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)((blockDim.x + 31) >> 5); ++w) {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] += part[w][i];
    }
  }
}

// NaN-propagating max with the semantics of jnp.maximum and
// torch.maximum (fmaxf would drop the NaN).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// mt_chunk_test (rt_rs_tpu/ops/pallas/packet_trace.py:678) for one
// (ray, triangle), shared by kernels B and E: returns ok and sets w.
// tri holds a, e1 = b - a, e2 = c - a.  The exclusion test is the
// caller's.
__device__ __forceinline__ bool mt_test(const float* tri, float ox, float oy,
                                        float oz, float dx, float dy,
                                        float dz, float t_min, float t_max,
                                        float eps, float& w) {
  const float ax = tri[0], ay = tri[1], az = tri[2];
  const float e1x = tri[3], e1y = tri[4], e1z = tri[5];
  const float e2x = tri[6], e2y = tri[7], e2z = tri[8];
  // p = cross(d, e2)
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  // tvec = o - a
  const float tx = ox - ax;
  const float ty = oy - ay;
  const float tz = oz - az;
  // q = cross(tvec, e1)
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float u = tx * px + ty * py + tz * pz;
  const float v = dx * qx + dy * qy + dz * qz;
  const float sgn = (det > 0.0f) ? 1.0f : ((det < 0.0f) ? -1.0f : 0.0f);
  const float adet = fabsf(det);
  const float su = u * sgn;
  const float sv = v * sgn;
  if (!((adet > eps) && (su >= 0.0f) && (su <= adet) && (sv >= 0.0f) &&
        (su + sv <= adet)))
    return false;
  w = (e2x * qx + e2y * qy + e2z * qz) / det;
  return (w > t_min) && (w < t_max);
}

// Hit point + interpolated unit normal of one ray, op for op
// rt_rs_tpu/ops/pallas/shade_tile.py::_hit_normal (the corner
// rotation of compute.wgsl:120-151 is baked into the shade-table
// column order: b = cols 0-2, c = 3-5, a = 6-8).  `row(c)` reads
// shade-table column c of this ray's hit.
struct HitNormal {
  float hx, hy, hz, nx, ny, nz;
};

template <typename Row>
__device__ __forceinline__ HitNormal hit_normal(const Row& row, float ox,
                                                float oy, float oz, float dx,
                                                float dy, float dz, float t) {
  HitNormal h;
  h.hx = ox + dx * t;
  h.hy = oy + dy * t;
  h.hz = oz + dz * t;
  const float bx = row(0), by = row(1), bz = row(2);
  const float cx = row(3), cy = row(4), cz = row(5);
  const float ax = row(6), ay = row(7), az = row(8);
  const float v0x = bx - ax, v0y = by - ay, v0z = bz - az;
  const float v1x = cx - ax, v1y = cy - ay, v1z = cz - az;
  const float v2x = h.hx - ax, v2y = h.hy - ay, v2z = h.hz - az;
  const float d00 = v0x * v0x + v0y * v0y + v0z * v0z;
  const float d01 = v0x * v1x + v0y * v1y + v0z * v1z;
  const float d11 = v1x * v1x + v1y * v1y + v1z * v1z;
  const float d20 = v2x * v0x + v2y * v0y + v2z * v0z;
  const float d21 = v2x * v1x + v2y * v1y + v2z * v1z;
  float denom = d00 * d11 - d01 * d01;
  denom = (denom == 0.0f) ? 1.0f : denom;
  const float vv = (d11 * d20 - d01 * d21) / denom;
  const float ww = (d00 * d21 - d01 * d20) / denom;
  const float uu = 1.0f - vv - ww;
  const float nx = row(9) * vv + row(12) * ww + row(15) * uu;
  const float ny = row(10) * vv + row(13) * ww + row(16) * uu;
  const float nz = row(11) * vv + row(14) * ww + row(17) * uu;
  const float rn = 1.0f / sqrtf(nx * nx + ny * ny + nz * nz);
  h.nx = nx * rn;
  h.ny = ny * rn;
  h.nz = nz * rn;
  return h;
}
