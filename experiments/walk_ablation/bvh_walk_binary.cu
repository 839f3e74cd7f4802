// Kernel G's packed records without the wide tree: the ablation's
// "step 1 alone" (experiments/walk_ablation/walk_ablation.py; never on
// a frame path).  The threaded walk of the parent design, one thread a
// ray over the binary tree's preorder escape links, one unit of work a
// step ("if-if": a prim test or a node step), on 32-byte nodes
// {lo.xyz, miss link}, {hi.xyz, leaf word} (the slab bounds with the
// wobble applied; the leaf word ~q for a leaf whose prims start at
// packed prim q, 0 otherwise: a box that passes always leads to node
// i + 1, the first child or a leaf's escape) and kernel G's 48-byte
// prims.  Slab and prim tests are kernel G's (csrc/bvh_walk.cu), so the
// (t, pid) is the twin's bit for bit.
#include "common.cuh"

namespace {

constexpr int kBlock = 128;

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// csrc/bvh_walk.cu's tri_edges.
__device__ __forceinline__ bool tri_edges(float4 a, float4 e1, float4 e2,
                                          float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float t_min, float t_max, float eps,
                                          float& w) {
  const float px = dy * e2.z - dz * e2.y;
  const float py = dz * e2.x - dx * e2.z;
  const float pz = dx * e2.y - dy * e2.x;
  const float tx = ox - a.x;
  const float ty = oy - a.y;
  const float tz = oz - a.z;
  const float qx = ty * e1.z - tz * e1.y;
  const float qy = tz * e1.x - tx * e1.z;
  const float qz = tx * e1.y - ty * e1.x;
  const float det = e1.x * px + e1.y * py + e1.z * pz;
  const float u = tx * px + ty * py + tz * pz;
  const float v = dx * qx + dy * qy + dz * qz;
  const bool ok =
      (det > eps && u >= 0.0f && u <= det && v >= 0.0f && u + v <= det) ||
      (det < -eps && u <= 0.0f && u >= det && v <= 0.0f && u + v >= det);
  if (!ok) return false;
  w = (e2.x * qx + e2.y * qy + e2.z * qz) / det;
  return w <= t_max && w >= t_min;
}

__global__ void __launch_bounds__(kBlock)
    bvh_walk_binary_kernel(const float* __restrict__ o,
                           const float* __restrict__ d,
                           const int* __restrict__ excl,
                           const uint8_t* __restrict__ valid,
                           const float4* __restrict__ nodes,
                           const float4* __restrict__ prims, int n, int end,
                           float t_min, float t_max, float eps, float miss_t,
                           float* __restrict__ t_out,
                           int* __restrict__ pid_out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  const int ex = excl[i];
  int idx = valid[i] ? 0 : end;
  int ptr = 0;
  bool in_leaf = false;
  float best_t = miss_t;
  int best_id = 0;
  while (idx < end || in_leaf) {
    if (in_leaf) {
      const float4 a = __ldg(prims + 3 * ptr);
      const float4 e1 = __ldg(prims + 3 * ptr + 1);
      const float4 e2 = __ldg(prims + 3 * ptr + 2);
      const int pid = __float_as_int(a.w);
      float w;
      if (pid != ex &&
          tri_edges(a, e1, e2, ox, oy, oz, dx, dy, dz, t_min, t_max, eps,
                    w) &&
          w > t_min && w < t_max && w < best_t) {
        best_t = w;
        best_id = pid;
      }
      in_leaf = __float_as_int(e1.w) == 0;
      ++ptr;
    } else {
      const float4 lo = __ldg(nodes + 2 * idx);
      const float4 hi = __ldg(nodes + 2 * idx + 1);
      float t0 = (lo.x - ox) * ix, t1 = (hi.x - ox) * ix;
      const float lx = min_nan(t0, t1), hx = max_nan(t0, t1);
      t0 = (lo.y - oy) * iy;
      t1 = (hi.y - oy) * iy;
      const float ly = min_nan(t0, t1), hy = max_nan(t0, t1);
      t0 = (lo.z - oz) * iz;
      t1 = (hi.z - oz) * iz;
      const float lz = min_nan(t0, t1), hz = max_nan(t0, t1);
      const float near = fmaxf(fmaxf(fmaxf(lx, ly), lz), -INFINITY);
      const float far = fminf(fminf(fminf(hx, hy), hz), INFINITY);
      if (near <= far && far >= t_min && near <= best_t) {
        const int leaf = __float_as_int(hi.w);
        if (leaf < 0) {
          in_leaf = true;
          ptr = ~leaf;
        }
        ++idx;
      } else {
        idx = __float_as_int(lo.w);
      }
    }
  }
  t_out[i] = best_t;
  pid_out[i] = best_id;
}

}  // namespace

RT_EXPORT int rt_bvh_walk_binary(const float* o, const float* d,
                                 const int* excl, const uint8_t* valid,
                                 const int* nodes, const int* prims, int n,
                                 int num_nodes, float t_min, float t_max,
                                 float eps, float miss_t, float* t_out,
                                 int* pid_out, cudaStream_t stream) {
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + kBlock - 1) / kBlock);
    bvh_walk_binary_kernel<<<blocks, kBlock, 0, stream>>>(
        o, d, excl, valid, reinterpret_cast<const float4*>(nodes),
        reinterpret_cast<const float4*>(prims), n, num_nodes, t_min, t_max,
        eps, miss_t, t_out, pid_out);
  }
  return (int)cudaGetLastError();
}
