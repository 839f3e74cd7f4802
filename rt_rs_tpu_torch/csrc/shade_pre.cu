// Kernel C: shade_pre, the first half of a bounce's shading.
//
// Replaces rt_rs_tpu/ops/pallas/shade_tile.py::_shade_pre_kernel (with
// _pre_subgroup and _hit_normal).  Per ray of a live 8-tile subgroup:
// the hit point and interpolated unit normal; for each light k the
// shadow ray, its cap and its contribution mask; then the reflected
// continuation ray (the body is shade_pre_ray, shade_body.cuh).  Rays
// of a subgroup with no live ray get zeros in every output, as on the
// TPU.
//
// Layouts (component-major, T tiles of r rays, plane = T * r):
//   table [P + 1, 32] (the scene's shade table, 16-byte aligned), pid
//   [T, r] i32 (each ray's hit, 0 for a dead ray), payload [8, T, r],
//   t [T, r], live_sg [T / 8] i32, lights [k, 4] (x, y, z, strength)
//   -> sh_pay [8, k * T, r] (light-major tiles: the shadow batch the
//      any-hit call takes as is), caps [k, T, r], masks [k, T, r],
//      next [8, T, r] (only when emit_next).
//
// What bounds it on this card: memory.  A ray of a live subgroup reads
// 8 floats of planes (pid, 6 payload rows, t) and 96 B of its table row
// (vectors 0-4 and 6: columns 0-17 and 24), and writes 8k + 2k + 8
// floats, at ~60 flops per light, far below the H100's ~20 flop/byte
// balance point.  The table (0.8 MB for 6,322 triangles) stays in L2, so
// DRAM sees the 32 B of planes and the writes: 144 B a ray at k = 2.
// One thread per ray keeps every plane access coalesced along the ray
// axis (the TPU's lane axis), and dead subgroups only store zeros.
#include "shade_body.cuh"

__global__ void shade_pre_kernel(const float* __restrict__ table,
                                 const int* __restrict__ pid,
                                 const float* __restrict__ payload,
                                 const float* __restrict__ t_in,
                                 const int* __restrict__ live_sg,
                                 const float* __restrict__ lights, int k,
                                 int n_tiles, int r, int emit_next,
                                 float* __restrict__ sh_pay,
                                 float* __restrict__ caps,
                                 float* __restrict__ masks,
                                 float* __restrict__ next) {
  const long plane = (long)n_tiles * r;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= plane) return;
  const long tile = idx / r;
  shade_pre_ray(table, pid, payload, t_in, lights, k, plane, idx,
                live_sg[tile / 8] != 0, emit_next, sh_pay, caps, masks, next);
}

RT_EXPORT int rt_shade_pre(const float* table, const int* pid,
                           const float* payload, const float* t_in,
                           const int* live_sg, const float* lights, int k,
                           int n_tiles, int r, int emit_next, float* sh_pay,
                           float* caps, float* masks, float* next,
                           cudaStream_t stream) {
  const long n = (long)n_tiles * r;
  if (n > 0) {
    const int threads = 256;
    const long blocks = (n + threads - 1) / threads;
    shade_pre_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        table, pid, payload, t_in, live_sg, lights, k, n_tiles, r,
        emit_next, sh_pay, caps, masks, next);
  }
  return (int)cudaGetLastError();
}
