// Kernel C: shade_pre, the first half of a bounce's shading.
//
// Replaces rt_rs_tpu/ops/pallas/shade_tile.py::_shade_pre_kernel (with
// _pre_subgroup and _hit_normal).  Per ray of a live 8-tile subgroup:
// the hit point and interpolated unit normal; for each light k the
// shadow ray (origin offset 0.001 along +-n toward the light's side,
// unit direction, excl = pid, row 7 = the light distance), its cap
// (= the distance) and its contribution mask (the light can change
// the colour: ls > 0 and (diffuse side > 0 or specular sdot > 0 or
// spec power <= 0)); then the reflected continuation ray.  Rays of a
// subgroup with no live ray get zeros in every output, as on the TPU.
//
// Layouts (component-major, T tiles of r rays, plane = T * r):
//   rows [32, T, r], payload [8, T, r], t / pid_f [T, r],
//   live_sg [T / 8] i32, lights [k, 4] (x, y, z, strength)
//   -> sh_pay [8, k * T, r] (light-major tiles: the shadow batch the
//      any-hit call takes as is), caps [k, T, r], masks [k, T, r],
//      next [8, T, r] (only when emit_next).
//
// What bounds it on this card: memory.  Each ray reads 32 + 8 + 2
// floats and writes 8k + 2k + 8, at ~60 flops per light, far below
// the H100's ~20 flop/byte balance point.  One thread per ray keeps
// every access coalesced along the ray axis (the TPU's lane axis), and
// dead subgroups only store zeros.
#include "common.cuh"

__global__ void shade_pre_kernel(const float* __restrict__ rows,
                                 const float* __restrict__ payload,
                                 const float* __restrict__ t_in,
                                 const float* __restrict__ pid_f,
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
  const long kplane = (long)k * plane;

  if (live_sg[tile / 8] == 0) {
    for (int li = 0; li < k; ++li) {
      for (int c = 0; c < 8; ++c) sh_pay[c * kplane + li * plane + idx] = 0.0f;
      caps[li * plane + idx] = 0.0f;
      masks[li * plane + idx] = 0.0f;
    }
    if (emit_next)
      for (int c = 0; c < 8; ++c) next[c * plane + idx] = 0.0f;
    return;
  }

  auto row = [&](int c) { return rows[c * plane + idx]; };
  const float ox = payload[0 * plane + idx];
  const float oy = payload[1 * plane + idx];
  const float oz = payload[2 * plane + idx];
  const float dx = payload[3 * plane + idx];
  const float dy = payload[4 * plane + idx];
  const float dz = payload[5 * plane + idx];
  const float pid = pid_f[idx];
  const HitNormal h = hit_normal(row, ox, oy, oz, dx, dy, dz, t_in[idx]);
  const float spec_pow = row(24);

  for (int li = 0; li < k; ++li) {
    const float lx = lights[li * 4 + 0];
    const float ly = lights[li * 4 + 1];
    const float lz = lights[li * 4 + 2];
    const float ls = lights[li * 4 + 3];
    const float ddx = lx - h.hx, ddy = ly - h.hy, ddz = lz - h.hz;
    const float s = ddx * ddx + ddy * ddy + ddz * ddz;
    const float dist = sqrtf(s);
    const float inv = rsqrtf(s);
    const float ux = ddx * inv, uy = ddy * inv, uz = ddz * inv;
    const float side = ux * h.nx + uy * h.ny + uz * h.nz;
    const float off = (side < 0.0f) ? -0.001f : 0.001f;
    float* sp = sh_pay + li * plane + idx;
    sp[0 * kplane] = h.hx + off * h.nx;
    sp[1 * kplane] = h.hy + off * h.ny;
    sp[2 * kplane] = h.hz + off * h.nz;
    sp[3 * kplane] = ux;
    sp[4 * kplane] = uy;
    sp[5 * kplane] = uz;
    sp[6 * kplane] = pid;
    sp[7 * kplane] = dist;
    caps[li * plane + idx] = dist;
    // Zero-contribution cull: the same op sequence as shade_post's
    // specular term, so the two agree on every ray.
    const float eux = -ux, euy = -uy, euz = -uz;
    const float den = eux * h.nx + euy * h.ny + euz * h.nz;
    const float rfx = eux - 2.0f * den * h.nx;
    const float rfy = euy - 2.0f * den * h.ny;
    const float rfz = euz - 2.0f * den * h.nz;
    const float sdot = (-rfx) * dx + (-rfy) * dy + (-rfz) * dz;
    const bool need =
        (ls > 0.0f) && ((side > 0.0f) || (sdot > 0.0f) || (spec_pow <= 0.0f));
    masks[li * plane + idx] = need ? 1.0f : 0.0f;
  }

  if (emit_next) {
    // reflect(d, n) = d - 2 dot(d, n) n, normalised (compute.wgsl:267-276).
    const float dn = dx * h.nx + dy * h.ny + dz * h.nz;
    float rx = dx - 2.0f * dn * h.nx;
    float ry = dy - 2.0f * dn * h.ny;
    float rz = dz - 2.0f * dn * h.nz;
    const float rr = rsqrtf(rx * rx + ry * ry + rz * rz);
    rx = rx * rr;
    ry = ry * rr;
    rz = rz * rr;
    const float rside = rx * h.nx + ry * h.ny + rz * h.nz;
    const float roff = (rside < 0.0f) ? -0.001f : 0.001f;
    next[0 * plane + idx] = h.hx + roff * h.nx;
    next[1 * plane + idx] = h.hy + roff * h.ny;
    next[2 * plane + idx] = h.hz + roff * h.nz;
    next[3 * plane + idx] = rx;
    next[4 * plane + idx] = ry;
    next[5 * plane + idx] = rz;
    next[6 * plane + idx] = 0.0f;
    next[7 * plane + idx] = 0.0f;
  }
}

RT_EXPORT int rt_shade_pre(const float* rows, const float* payload,
                           const float* t_in, const float* pid_f,
                           const int* live_sg, const float* lights, int k,
                           int n_tiles, int r, int emit_next, float* sh_pay,
                           float* caps, float* masks, float* next,
                           cudaStream_t stream) {
  const long n = (long)n_tiles * r;
  if (n > 0) {
    const int threads = 256;
    const long blocks = (n + threads - 1) / threads;
    shade_pre_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        rows, payload, t_in, pid_f, live_sg, lights, k, n_tiles, r,
        emit_next, sh_pay, caps, masks, next);
  }
  return (int)cudaGetLastError();
}
