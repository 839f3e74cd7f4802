// Kernel A: the per-ray refine cull.
//
// Replaces rt_rs_tpu/ops/pallas/packet_trace.py::_refine_kernel (called
// through _perray_overlap_kernel_call).  For every (ray tile, chunk)
// pair: does ANY valid ray of the tile pass the slab test against the
// chunk's wobble-widened AABB inside its own [t_min, min(cap, t_max)]
// window?  Inverse directions are 1/d clamped to +-1e30 (NaN kept).
// Output [T, Nc] bool; tiles with no valid ray write false.  Pad chunks
// (inverted bounds) are removed by the wrapper, as in the reference.
//
// What bounds it on this card: arithmetic and the per-chunk block
// vote.  Each (ray, chunk) pair costs ~20 f32 ops on registers; the
// inputs are 8 floats per ray and 6 per chunk, so memory traffic is
// negligible (bounds sit in shared memory, read by all 256 threads as
// broadcasts).  The TPU kernel ORs over rays with a ones-vector matmul;
// here one block owns one tile (one thread per ray) and the OR is
// __syncthreads_or, one barrier per chunk.  Dead tiles exit after one
// vote, which is where secondary bounces spend most tiles.
#include "common.cuh"

__global__ void refine_cull_kernel(const float* __restrict__ payload,
                                   const bool* __restrict__ valid,
                                   const float* __restrict__ capm,
                                   const float* __restrict__ bounds,
                                   bool* __restrict__ out, int n_tiles,
                                   int r, int nc, float t_min) {
  extern __shared__ float sb[];  // [nc, 6]: lo xyz, hi xyz
  const int tile = blockIdx.x;
  const int lane = threadIdx.x;
  const long plane = (long)n_tiles * r;
  const long idx = (long)tile * r + lane;
  bool* row = out + (long)tile * nc;

  const bool vld = valid[idx];
  if (!__syncthreads_or(vld)) {
    for (int c = lane; c < nc; c += blockDim.x) row[c] = false;
    return;
  }
  for (int i = lane; i < nc * 6; i += blockDim.x) sb[i] = bounds[i];

  float o[3], iv[3];
  for (int ax = 0; ax < 3; ++ax) {
    o[ax] = payload[ax * plane + idx];
    const float inv = 1.0f / payload[(3 + ax) * plane + idx];
    iv[ax] = (inv != inv) ? inv : fminf(fmaxf(inv, -1e30f), 1e30f);
  }
  const float cap = capm[idx];
  __syncthreads();

  for (int c = 0; c < nc; ++c) {
    float near = -INFINITY, far = INFINITY;
    for (int ax = 0; ax < 3; ++ax) {
      const float q0 = (sb[c * 6 + ax] - o[ax]) * iv[ax];
      const float q1 = (sb[c * 6 + 3 + ax] - o[ax]) * iv[ax];
      near = nan_max(near, nan_min(q0, q1));
      far = nan_min(far, nan_max(q0, q1));
    }
    const bool ok = vld && (near <= far) && (far >= t_min) && (near <= cap);
    const bool any = __syncthreads_or(ok);
    if (lane == 0) row[c] = any;
  }
}

RT_EXPORT int rt_refine_cull(const float* payload, const bool* valid,
                             const float* capm, const float* bounds,
                             bool* out, int n_tiles, int r, int nc,
                             float t_min, cudaStream_t stream) {
  if (n_tiles > 0) {
    refine_cull_kernel<<<n_tiles, r, nc * 6 * sizeof(float), stream>>>(
        payload, valid, capm, bounds, out, n_tiles, r, nc, t_min);
  }
  return (int)cudaGetLastError();
}
