// The per-ray bodies of a bounce's shading, shared by kernels C
// (shade_pre.cu), D (shade_post.cu) and F (shade_bounce.cu), so that
// all three run the same code and the fused kernel is bit-equal to the
// two it fuses.  Each body handles ray `idx` of the component-major
// planes (plane = T * r floats); `live` is its 8-tile subgroup's flag:
// a dead subgroup writes zeros in every output, as on the TPU.  A ray's
// hit row is read from the resident shade table [P + 1, 32] at its pid
// (TableRow); the frame writes no [32, T, r] plane of rows.  The post
// body's arithmetic (shade_post_color) takes its operands through an
// accessor, so that kernel D can load them into registers in its own
// order while kernel F reads them as it goes, with the same operations.
#pragma once

#include "common.cuh"

// Shade-table columns a kernel reads, as a mask of the row's 16-byte
// vectors (vector q holds columns 4q..4q+3): shade_pre reads columns
// 0-17 and 24 (vectors 0-4 and 6), shade_post columns 0-24 (0-6).
constexpr unsigned kPreVectors = 0x5Fu;
constexpr unsigned kPostVectors = 0x7Fu;

// One hit's row of the shade table [P + 1, 32] (128-byte rows, the
// table 16-byte aligned: the wrappers check it), the vectors of VECTORS
// read with one 16-byte load each.  The table is a few MB at most and
// stays in L2 across a frame's calls.  row(c) is column c.
template <unsigned VECTORS>
struct TableRow {
  float v[28];

  __device__ __forceinline__ void load(const float* __restrict__ table, int pid) {
    const float4* src = reinterpret_cast<const float4*>(table + (long)pid * 32);
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      const float4 x = (VECTORS >> q & 1u) ? __ldg(src + q) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v[4 * q + 0] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  }
  __device__ __forceinline__ float operator()(int c) const { return v[c]; }
};

// shade_pre for one ray (rt_rs_tpu/ops/pallas/shade_tile.py::
// _pre_subgroup) on its hit row table[pid]: the hit point and
// interpolated unit normal; for each light li the shadow ray (origin
// offset 0.001 along +-n toward the light's side, unit direction, excl =
// pid, row 7 = the light distance) at tile li * T + tile of sh_pay
// [8, k * T, r], its cap (= the distance) and its contribution mask
// (the light can change the colour: ls > 0 and (diffuse side > 0 or
// specular sdot > 0 or spec power <= 0)); then, with emit_next, the
// reflected continuation ray.
__device__ __forceinline__ void shade_pre_ray(
    const float* __restrict__ table, const int* __restrict__ pid_in,
    const float* __restrict__ payload, const float* __restrict__ t_in,
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

  const int pid_i = pid_in[idx];
  const float ox = payload[0 * plane + idx];
  const float oy = payload[1 * plane + idx];
  const float oz = payload[2 * plane + idx];
  const float dx = payload[3 * plane + idx];
  const float dy = payload[4 * plane + idx];
  const float dz = payload[5 * plane + idx];
  const float t = t_in[idx];
  TableRow<kPreVectors> row;
  row.load(table, pid_i);
  const float pid = (float)pid_i;
  const HitNormal h = hit_normal(row, ox, oy, oz, dx, dy, dz, t);
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

// Where shade_post_color reads a ray's operands.  PostGlobal reads the
// hit row into registers and the rest from the component-major planes
// in global memory where the arithmetic uses them (kernel F); kernel D
// loads every operand into registers first (shade_post.cu::PostRegs).
// An accessor gives row(c) (shade-table column c), pay(c) (payload row
// c), t(), active(), sh_t(li) / sh_id(li) / cap(li) of light li and
// light(li, c) of the lights [k, 4].
struct PostGlobal {
  TableRow<kPostVectors> rw;
  const float* __restrict__ payload;
  const float* __restrict__ t_in;
  const float* __restrict__ active_f;
  const float* __restrict__ sh_t_in;
  const float* __restrict__ sh_id_in;
  const float* __restrict__ caps;
  const float* __restrict__ lights;
  long plane, idx;

  __device__ __forceinline__ float row(int c) const { return rw(c); }
  __device__ __forceinline__ float pay(int c) const { return payload[c * plane + idx]; }
  __device__ __forceinline__ float t() const { return t_in[idx]; }
  __device__ __forceinline__ float active() const { return active_f[idx]; }
  __device__ __forceinline__ float sh_t(int li) const { return sh_t_in[li * plane + idx]; }
  __device__ __forceinline__ float sh_id(int li) const { return sh_id_in[li * plane + idx]; }
  __device__ __forceinline__ float cap(int li) const { return caps[li * plane + idx]; }
  __device__ __forceinline__ float light(int li, int c) const { return lights[li * 4 + c]; }
};

// shade_post for one ray of a live subgroup (shade_tile.py::
// _post_subgroup): for each light the shadow verdict (blocked_mode: the
// any-hit mask sh_t > 0; else sh_id != 0 and t_min < sh_t < t_max and
// sh_t < cap); a lit light adds diffuse ls * max(0, u.n) and specular
// pow(max(0, sdot), spec) * ls.  The colour contribution is
// (C18..20 * diffuse * albedo.x + spec * albedo.y), times albedo.z
// after bounce 0, zero where the ray is not active -> color[3].
template <typename In>
__device__ __forceinline__ void shade_post_color(
    const In& in, int k, int first_bounce, int blocked_mode, float t_min,
    float t_max, float (&color)[3]) {
  auto row = [&](int c) { return in.row(c); };
  const float ox = in.pay(0);
  const float oy = in.pay(1);
  const float oz = in.pay(2);
  const float dx = in.pay(3);
  const float dy = in.pay(4);
  const float dz = in.pay(5);
  const HitNormal h = hit_normal(row, ox, oy, oz, dx, dy, dz, in.t());
  const float spec_pow = row(24);

  float diffuse = 0.0f;
  float spec = 0.0f;
  for (int li = 0; li < k; ++li) {
    const float lx = in.light(li, 0);
    const float ly = in.light(li, 1);
    const float lz = in.light(li, 2);
    const float ls = in.light(li, 3);
    const float ddx = lx - h.hx, ddy = ly - h.hy, ddz = lz - h.hz;
    const float s = ddx * ddx + ddy * ddy + ddz * ddz;
    const float inv = 1.0f / sqrtf(s);
    const float ux = ddx * inv, uy = ddy * inv, uz = ddz * inv;
    bool shadowed;
    if (blocked_mode) {
      shadowed = in.sh_t(li) > 0.0f;
    } else {
      const float st = in.sh_t(li);
      shadowed = (in.sh_id(li) != 0.0f) && (st < t_max) && (st > t_min) &&
                 (st < in.cap(li));
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
  const bool act = in.active() > 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float contrib = (row(18 + c) * da + sa) * scale;
    color[c] = act ? contrib : 0.0f;
  }
}

// shade_post for ray `idx` of the planes in global memory (kernel F):
// shade_post_color on its hit row table[pid] where `live`, zeros where
// not; out is [3, T, r].
__device__ __forceinline__ void shade_post_ray(
    const float* __restrict__ table, const int* __restrict__ pid,
    const float* __restrict__ payload,
    const float* __restrict__ t_in, const float* __restrict__ active,
    const float* __restrict__ sh_t, const float* __restrict__ sh_id,
    const float* __restrict__ caps, const float* __restrict__ lights, int k,
    long plane, long idx, bool live, int first_bounce, int blocked_mode,
    float t_min, float t_max, float* __restrict__ out) {
  if (!live) {
    for (int c = 0; c < 3; ++c) out[c * plane + idx] = 0.0f;
    return;
  }
  PostGlobal in{{}, payload, t_in, active, sh_t, sh_id, caps, lights, plane, idx};
  in.rw.load(table, pid[idx]);
  float color[3];
  shade_post_color(in, k, first_bounce, blocked_mode, t_min, t_max, color);
  for (int c = 0; c < 3; ++c) out[c * plane + idx] = color[c];
}
