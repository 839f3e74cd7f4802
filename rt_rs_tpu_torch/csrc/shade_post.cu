// Kernel D: shade_post, the second half of a bounce's shading.
//
// Replaces rt_rs_tpu/ops/pallas/shade_tile.py::_shade_post_kernel (with
// _post_subgroup and _hit_normal).  Per ray of a live 8-tile subgroup:
// for each light, the shadow verdict, and the Blinn/Phong colour
// contribution of the lit lights (the body is shade_post_ray,
// shade_body.cuh).  Rays of a subgroup with no live ray get zeros.
//
// Layouts: rows [32, T, r], payload [8, T, r], t / active [T, r],
// sh_t / sh_id / caps [k, T, r], live_sg [T / 8] i32, lights [k, 4]
// -> out [3, T, r].
//
// What bounds it on this card: memory, like shade_pre (~45 floats read
// and 3 written per ray, ~50 flops per light); one thread per ray with
// coalesced component-major accesses.
#include "shade_body.cuh"

__global__ void shade_post_kernel(
    const float* __restrict__ rows, const float* __restrict__ payload,
    const float* __restrict__ t_in, const float* __restrict__ active,
    const float* __restrict__ sh_t, const float* __restrict__ sh_id,
    const float* __restrict__ caps, const int* __restrict__ live_sg,
    const float* __restrict__ lights, int k, int n_tiles, int r,
    int first_bounce, int blocked_mode, float t_min, float t_max,
    float* __restrict__ out) {
  const long plane = (long)n_tiles * r;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= plane) return;
  const long tile = idx / r;
  shade_post_ray(rows, payload, t_in, active, sh_t, sh_id, caps, lights, k,
                 plane, idx, live_sg[tile / 8] != 0, first_bounce,
                 blocked_mode, t_min, t_max, out);
}

RT_EXPORT int rt_shade_post(const float* rows, const float* payload,
                            const float* t_in, const float* active,
                            const float* sh_t, const float* sh_id,
                            const float* caps, const int* live_sg,
                            const float* lights, int k, int n_tiles, int r,
                            int first_bounce, int blocked_mode, float t_min,
                            float t_max, float* out, cudaStream_t stream) {
  const long n = (long)n_tiles * r;
  if (n > 0) {
    const int threads = 256;
    const long blocks = (n + threads - 1) / threads;
    shade_post_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        rows, payload, t_in, active, sh_t, sh_id, caps, live_sg, lights, k,
        n_tiles, r, first_bounce, blocked_mode, t_min, t_max, out);
  }
  return (int)cudaGetLastError();
}
