// The per-ray bodies of a bounce's shading, shared by kernels C
// (shade_pre.cu), D (shade_post.cu) and F (shade_bounce.cu), so that
// all three run the same code and the fused kernel is bit-equal to the
// two it fuses.  Each body handles ray `idx` of the component-major
// planes (plane = T * r floats); `live` is its 8-tile subgroup's flag:
// a dead subgroup writes zeros in every output, as on the TPU.
#pragma once

#include "common.cuh"

// shade_pre for one ray (rt_rs_tpu/ops/pallas/shade_tile.py::
// _pre_subgroup): the hit point and interpolated unit normal; for each
// light li the shadow ray (origin offset 0.001 along +-n toward the
// light's side, unit direction, excl = pid, row 7 = the light distance)
// at tile li * T + tile of sh_pay [8, k * T, r], its cap (= the
// distance) and its contribution mask (the light can change the
// colour: ls > 0 and (diffuse side > 0 or specular sdot > 0 or spec
// power <= 0)); then, with emit_next, the reflected continuation ray.
__device__ __forceinline__ void shade_pre_ray(
    const float* __restrict__ rows, const float* __restrict__ payload,
    const float* __restrict__ t_in, const float* __restrict__ pid_f,
    const float* __restrict__ lights, int k, long plane, long idx, bool live,
    int emit_next, float* __restrict__ sh_pay, float* __restrict__ caps,
    float* __restrict__ masks, float* __restrict__ next) {
  const long kplane = (long)k * plane;
  if (!live) {
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
    const float inv = 1.0f / sqrtf(s);
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
    const float rr = 1.0f / sqrtf(rx * rx + ry * ry + rz * rz);
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

// shade_post for one ray (shade_tile.py::_post_subgroup): for each light
// the shadow verdict (blocked_mode: the any-hit mask sh_t > 0; else
// sh_id != 0 and t_min < sh_t < t_max and sh_t < cap); a lit light adds
// diffuse ls * max(0, u.n) and specular pow(max(0, sdot), spec) * ls.
// The colour contribution is (C18..20 * diffuse * albedo.x + spec *
// albedo.y), times albedo.z after bounce 0, zero where the ray is not
// active; out is [3, T, r].
__device__ __forceinline__ void shade_post_ray(
    const float* __restrict__ rows, const float* __restrict__ payload,
    const float* __restrict__ t_in, const float* __restrict__ active,
    const float* __restrict__ sh_t, const float* __restrict__ sh_id,
    const float* __restrict__ caps, const float* __restrict__ lights, int k,
    long plane, long idx, bool live, int first_bounce, int blocked_mode,
    float t_min, float t_max, float* __restrict__ out) {
  if (!live) {
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
    const float inv = 1.0f / sqrtf(s);
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
