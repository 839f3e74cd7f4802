// Kernel D: shade_post, the second half of a bounce's shading.
//
// Replaces rt_rs_tpu/ops/pallas/shade_tile.py::_shade_post_kernel (with
// _post_subgroup and _hit_normal).  Per ray of a live 8-tile subgroup:
// for each light, the shadow verdict (blocked_mode: the any-hit mask
// sh_t > 0; else sh_id != 0 and t_min < sh_t < t_max and sh_t < cap);
// a lit light adds diffuse ls * max(0, u.n) and specular
// pow(max(0, sdot), spec) * ls.  The colour contribution is
// (C18..20 * diffuse * albedo.x + spec * albedo.y), times albedo.z
// after bounce 0, zero where the ray is not active.  Rays of a
// subgroup with no live ray get zeros.
//
// Layouts: rows [32, T, r], payload [8, T, r], t / active [T, r],
// sh_t / sh_id / caps [k, T, r], live_sg [T / 8] i32, lights [k, 4]
// -> out [3, T, r].
//
// What bounds it on this card: memory, like shade_pre (~45 floats read
// and 3 written per ray, ~50 flops per light); one thread per ray with
// coalesced component-major accesses.
#include "common.cuh"

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

  if (live_sg[tile / 8] == 0) {
    for (int c = 0; c < 3; ++c) out[c * plane + idx] = 0.0f;
    return;
  }

  auto row = [&](int c) { return rows[c * plane + idx]; };
  const float ox = payload[0 * plane + idx];
  const float oy = payload[1 * plane + idx];
  const float oz = payload[2 * plane + idx];
  const float dx = payload[3 * plane + idx];
  const float dy = payload[4 * plane + idx];
  const float dz = payload[5 * plane + idx];
  const HitNormal h = hit_normal(row, ox, oy, oz, dx, dy, dz, t_in[idx]);
  const float spec_pow = row(24);

  float diffuse = 0.0f;
  float spec = 0.0f;
  for (int li = 0; li < k; ++li) {
    const float lx = lights[li * 4 + 0];
    const float ly = lights[li * 4 + 1];
    const float lz = lights[li * 4 + 2];
    const float ls = lights[li * 4 + 3];
    const float ddx = lx - h.hx, ddy = ly - h.hy, ddz = lz - h.hz;
    const float s = ddx * ddx + ddy * ddy + ddz * ddz;
    const float inv = rsqrtf(s);
    const float ux = ddx * inv, uy = ddy * inv, uz = ddz * inv;
    bool shadowed;
    if (blocked_mode) {
      shadowed = sh_t[li * plane + idx] > 0.0f;
    } else {
      const float st = sh_t[li * plane + idx];
      shadowed = (sh_id[li * plane + idx] != 0.0f) && (st < t_max) &&
                 (st > t_min) && (st < caps[li * plane + idx]);
    }
    const bool lit = !shadowed && (ls > 0.0f);
    // diffuse (compute.wgsl:160-166)
    const float dterm = ls * nan_max(0.0f, ux * h.nx + uy * h.ny + uz * h.nz);
    // specular via reflect(-u, n) (compute.wgsl:168-175)
    const float eux = -ux, euy = -uy, euz = -uz;
    const float den = eux * h.nx + euy * h.ny + euz * h.nz;
    const float rx = eux - 2.0f * den * h.nx;
    const float ry = euy - 2.0f * den * h.ny;
    const float rz = euz - 2.0f * den * h.nz;
    const float sdot = (-rx) * dx + (-ry) * dy + (-rz) * dz;
    const float sterm = powf(nan_max(0.0f, sdot), spec_pow) * ls;
    diffuse = diffuse + (lit ? dterm : 0.0f);
    spec = spec + (lit ? sterm : 0.0f);
  }

  const float da = diffuse * row(21);
  const float sa = spec * row(22);
  // albedo.z attenuation for bounce > 0 (compute.wgsl:258-265)
  const float scale = first_bounce ? 1.0f : row(23);
  const bool act = active[idx] > 0.0f;
  for (int c = 0; c < 3; ++c) {
    const float contrib = (row(18 + c) * da + sa) * scale;
    out[c * plane + idx] = act ? contrib : 0.0f;
  }
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
