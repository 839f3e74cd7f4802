// Kernel G: the threaded BVH walk, closest hit per ray.
//
// Replaces no pallas_call: it is the XLA lax.while_loop of
// rt_rs_tpu/handlers/bvh.py::_bvh_intersect (contiguous leaves, the
// bvh handler) and rt_rs_tpu/handlers/rf.py::_rf_intersect (8-slot
// payload leaves, rf_bvh).  There every step moves the whole ray batch
// by one unit of work per ray: one prim test of the leaf the ray last
// entered, or one node step (the slab test of handlers/bvh.py::_node_slab,
// the cull, the hit or miss link).  Here one thread runs one ray's loop
// alone.  A ray takes exactly the tests it takes in the lockstep loop,
// in the same order, so its (t, pid) is the loop's bit for bit: ties
// keep the first prim found (strict t < best_t).  Rays with valid == 0
// start at END and return the miss sentinel (t_max + 1, 0).
//
// Layouts: o, d [n, 3]; excl [n] i32; valid [n] u8 (torch bool);
// node_min / node_max [m, 3] (covering bounds), hit_link / miss_link /
// leaf_count [m] i32 (m = END); leaves = leaf_start [m] (payload == 0)
// or the payload slots [m * 8] (payload == 1, slot 0 = empty);
// pa, pb, pc [p, 3] (row 0 = the null sentinel)  ->  t [n], pid [n].
//
// What bounds it on this card: operations and latency, not bytes.  A ray
// reads its 7 words and writes 2; the tree (at most a few MB here) and
// the prims stay in L2 and are read through the read-only cache, while
// each node step costs ~24 and each prim test ~49 f32 operations on a
// dependent chain of loads.  The design is the simple one: one thread a
// ray, 128 a block, no shared memory; the warps diverge where their rays
// take different paths.  No host read, so a frame that launches it can
// be captured in a CUDA graph.
#include "common.cuh"

namespace {

constexpr int kSlots = 8;
constexpr int kBlock = 128;

// rt_rs_tpu_torch/ops/intersect.py::tri_intersect_pairs for one (ray,
// prim), op for op: edges from the corners at run time, the two-sided
// determinant branches, the quotient only where they pass.  Returns
// whether w lies in [t_min, t_max] and sets w.
__device__ __forceinline__ bool tri_pair(const float* __restrict__ pa,
                                         const float* __restrict__ pb,
                                         const float* __restrict__ pc,
                                         int pid, float ox, float oy, float oz,
                                         float dx, float dy, float dz,
                                         float t_min, float t_max, float eps,
                                         float& w) {
  const float ax = __ldg(pa + 3 * pid), ay = __ldg(pa + 3 * pid + 1),
              az = __ldg(pa + 3 * pid + 2);
  const float e1x = __ldg(pb + 3 * pid) - ax;
  const float e1y = __ldg(pb + 3 * pid + 1) - ay;
  const float e1z = __ldg(pb + 3 * pid + 2) - az;
  const float e2x = __ldg(pc + 3 * pid) - ax;
  const float e2y = __ldg(pc + 3 * pid + 1) - ay;
  const float e2z = __ldg(pc + 3 * pid + 2) - az;
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
  const bool ok =
      (det > eps && u >= 0.0f && u <= det && v >= 0.0f && u + v <= det) ||
      (det < -eps && u <= 0.0f && u >= det && v <= 0.0f && u + v >= det);
  if (!ok) return false;
  w = (e2x * qx + e2y * qy + e2z * qz) / det;
  return w <= t_max && w >= t_min;
}

// One axis of _node_slab: the slab distances with the wobble, min and
// max with NaN propagated (jnp.minimum / jnp.maximum; fminf / fmaxf
// would drop it), then NaN mapped to -inf / +inf.
__device__ __forceinline__ void slab_axis(float bmin, float bmax, float o,
                                          float inv, float& lo, float& hi) {
  const float wob = 2e-6f + 1e-5f * fmaxf(fabsf(bmin), fabsf(bmax));
  const float t0 = (bmin - wob - o) * inv;
  const float t1 = (bmax + wob - o) * inv;
  const bool nan = (t0 != t0) || (t1 != t1);
  lo = nan ? -INFINITY : fminf(t0, t1);
  hi = nan ? INFINITY : fmaxf(t0, t1);
}

template <bool kPayload>
__global__ void __launch_bounds__(kBlock)
    bvh_walk_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const int* __restrict__ excl,
                    const uint8_t* __restrict__ valid,
                    const float* __restrict__ node_min,
                    const float* __restrict__ node_max,
                    const int* __restrict__ hit_link,
                    const int* __restrict__ miss_link,
                    const int* __restrict__ leaf_count,
                    const int* __restrict__ leaves,
                    const float* __restrict__ pa, const float* __restrict__ pb,
                    const float* __restrict__ pc, int n, int end, float t_min,
                    float t_max, float eps, float miss_t,
                    float* __restrict__ t_out, int* __restrict__ pid_out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  const int ex = excl[i];
  int idx = valid[i] ? 0 : end;
  int left = 0, ptr = 0;
  float best_t = miss_t;
  int best_id = 0;
  while (idx < end || left > 0) {
    if (left > 0) {
      // Leaf phase: one prim of the leaf.
      const int pid = kPayload ? __ldg(leaves + ptr) : ptr;
      float w;
      if (pid != ex && (!kPayload || pid != 0) &&
          tri_pair(pa, pb, pc, pid, ox, oy, oz, dx, dy, dz, t_min, t_max, eps,
                   w) &&
          w > t_min && w < t_max && w < best_t) {
        best_t = w;
        best_id = pid;
      }
      ++ptr;
      --left;
    } else {
      // Node phase: the box test, the cull, the link.
      float lx, hx, ly, hy, lz, hz;
      slab_axis(__ldg(node_min + 3 * idx), __ldg(node_max + 3 * idx), ox, ix,
                lx, hx);
      slab_axis(__ldg(node_min + 3 * idx + 1), __ldg(node_max + 3 * idx + 1),
                oy, iy, ly, hy);
      slab_axis(__ldg(node_min + 3 * idx + 2), __ldg(node_max + 3 * idx + 2),
                oz, iz, lz, hz);
      const float near = fmaxf(fmaxf(lx, ly), lz);
      const float far = fminf(fminf(hx, hy), hz);
      const bool hit = near <= far && far >= t_min && near <= best_t;
      if (hit) {
        const int count = __ldg(leaf_count + idx);
        if (count > 0) {
          left = count;
          ptr = kPayload ? idx * kSlots : __ldg(leaves + idx);
        }
        idx = __ldg(hit_link + idx);
      } else {
        idx = __ldg(miss_link + idx);
      }
    }
  }
  t_out[i] = best_t;
  pid_out[i] = best_id;
}

}  // namespace

RT_EXPORT int rt_bvh_walk(const float* o, const float* d, const int* excl,
                          const uint8_t* valid, const float* node_min,
                          const float* node_max, const int* hit_link,
                          const int* miss_link, const int* leaf_count,
                          const int* leaves, const float* pa, const float* pb,
                          const float* pc, int n, int num_nodes, int payload,
                          float t_min, float t_max, float eps, float miss_t,
                          float* t_out, int* pid_out, cudaStream_t stream) {
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + kBlock - 1) / kBlock);
    if (payload) {
      bvh_walk_kernel<true><<<blocks, kBlock, 0, stream>>>(
          o, d, excl, valid, node_min, node_max, hit_link, miss_link,
          leaf_count, leaves, pa, pb, pc, n, num_nodes, t_min, t_max, eps,
          miss_t, t_out, pid_out);
    } else {
      bvh_walk_kernel<false><<<blocks, kBlock, 0, stream>>>(
          o, d, excl, valid, node_min, node_max, hit_link, miss_link,
          leaf_count, leaves, pa, pb, pc, n, num_nodes, t_min, t_max, eps,
          miss_t, t_out, pid_out);
    }
  }
  return (int)cudaGetLastError();
}
