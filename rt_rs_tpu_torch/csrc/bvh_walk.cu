// Kernel G: the threaded BVH walk on a wide tree: closest hit per ray,
// or the closest hit with its shade row, or any hit below a cap.
//
// Replaces no pallas_call: it is the XLA lax.while_loop of
// rt_rs_tpu/handlers/bvh.py::_bvh_intersect (contiguous leaves, the
// bvh handler) and rt_rs_tpu/handlers/rf.py::_rf_intersect (8-slot
// payload leaves, rf_bvh).  There every step moves the whole ray batch
// by one unit of work per ray: one prim test of the leaf the ray last
// entered, or one node step over the preorder escape links (the slab
// test of handlers/bvh.py::_node_slab, the cull, the hit or miss link).
//
// Here one thread runs one ray over the same tree collapsed into
// kWidth-wide nodes (rt_rs_tpu_torch/bvh/wide.py packs them once per
// accel): a node holds its children's slab bounds (the wobble applied)
// and child words, a prim its corner a, its edges and its id.  At a
// node the ray tests every child's box, takes the first that passes and
// pushes the others in reverse preorder with their near on a short
// stack; a pop re-applies the cull near <= best_t.  The pack checks
// that the links are a preorder tree and that bounds nest exactly, and
// every step of the slab test is a monotone f32 operation, so a box
// that passes implies its ancestors passed at their own, earlier
// visits: the ray enters exactly the binary walk's leaves, in its
// order, with its best t, and makes its prim tests in its order.  Its
// (t, pid) is the loop's bit for bit: ties keep the first prim found
// (strict t < best_t).  Rays with valid == 0 return the miss sentinel
// (t_max + 1, 0).  The packed prims are the leaves' in test order, the
// empty payload slots dropped, so one walk serves both leaf kinds.
//
// Modes (MODE below), on component-major ray tiles (rt_bvh_walk_tiled,
// the bvh handler's tiled, rows and any-hit entries; its flat path pads
// its rays into tiles for the closest mode):
//   0 closest: (t, pid), as above;
//   1 rows: the same, and the winner's row of the scene's shade table
//     [P, 32] f32 written to rows [32, n] (row 0 for a miss or an
//     invalid ray, as the gather branch's table[pid] reads it);
//   2 any-hit: best_t starts at the ray's cap (payload row 7), every
//     test stays the closest walk's (pid != excl, t_min < w < t_max,
//     w < best_t), and the ray stops at the first prim that passes:
//     blocked = 1.  Some hit lies below the cap exactly when the
//     closest one does, so blocked is the closest walk's verdict
//     pid != 0 && t < cap bit for bit; nodes whose near lies beyond
//     the cap are culled.
//
// The stack a walk needs grows with the tree's depth (about one entry a
// binary level on a chain; the pack counts it).  Up to kLocalStack
// entries live in the thread's local memory (the *_kernel entries, one
// thread a ray); a deeper tree's walk keeps its stack in a scratch
// buffer the wrapper allocates (the *_scratch_kernel entries, each
// thread a strided set of rays), so every tree the binary walk takes is
// walked, in every mode.
//
// Layouts.  Rays: payload [8, n] f32, component-major over the n = T *
// r ray slots (rows 0-5 o and d, row 6 the f32 exclusion id, row 7 the
// cap), valid [n] u8 (torch bool) -> t, pid [n] (modes 0, 1), rows
// [32, n] (mode 1), blocked [n] u8 (mode 2); a thread reads its ray's
// 8 words from 8 planes, so a warp's loads and stores are 128
// contiguous bytes a plane.  Tree: nodes [k, 8 * kWidth] i32: lo.x,
// hi.x, lo.y, hi.y, lo.z, hi.z (kWidth f32 each), then kWidth child
// words (> 0 a node, ~q a leaf whose prims start at q, 0 empty),
// padding; prims [q, 12] i32: {a, pid}, {b - a, last}, {c - a, 0}.
// While the trace buffer's flag is set (tracing.py), each block adds
// its valid rays, wide-node visits and prim tests to walk_rays,
// walk_nodes and walk_prims, and in the any-hit mode its valid rays and
// blocked rays to walk_anyhit and walk_blocked, counted in registers as
// the rays walk and summed in one block reduction.
//
// What bounds it on this card: latency.  A ray reads its 7 or 8 words
// and writes 2 (closest: t, pid) or one byte (any-hit), the modes the
// frames call; the rows mode writes 34 words a slot (1.06 GB a 1080p
// frame of four calls), and no frame calls it: the shading kernels read
// each hit's row from the table by pid.  The tree and prims (a few MB)
// stay in L2, but each step waits on the load before it.  The binary walk made ~17 dependent node steps a primary ray,
// each two round trips (the box, then the link); here a node is one
// 128-byte line of independent 16-byte loads (box and links together),
// ~4 of them a torus primary ray, and a prim three 16-byte loads.  A
// call of ~100K rays is one wave and lasts as long as its slowest
// warp's chain of such loads.  The rows epilogue is 8 independent
// 16-byte loads of one L2-resident row and 32 coalesced stores a ray.
// The loop is "while-while": nodes until the ray holds a leaf or is
// done, then the leaf's prims, so a warp whose lanes are in different
// phases issues each body once per phase change, not every step.  No
// host read, so a frame that launches it can be captured in a CUDA
// graph.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWidth = 4;        // children per node (WIDTH in bvh/wide.py)
constexpr int kLocalStack = 64;  // stack entries in local memory (LOCAL_STACK)
constexpr int kBlock = 128;
constexpr int kNodeVecs = 2 * kWidth;  // 16-byte vectors a node
constexpr int kRowVecs = kWidth / 4;   // vectors a bounds row

// rt_rs_tpu_torch/ops/intersect.py::tri_intersect_edges for one (ray,
// prim), op for op: the two-sided determinant branches, the quotient
// only where they pass.  Returns whether w lies in [t_min, t_max] and
// sets w.
__device__ __forceinline__ bool tri_edges(float4 a, float4 e1, float4 e2,
                                          float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float t_min, float t_max, float eps,
                                          float& w) {
  // p = cross(d, e2)
  const float px = dy * e2.z - dz * e2.y;
  const float py = dz * e2.x - dx * e2.z;
  const float pz = dx * e2.y - dy * e2.x;
  // tvec = o - a
  const float tx = ox - a.x;
  const float ty = oy - a.y;
  const float tz = oz - a.z;
  // q = cross(tvec, e1)
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

// min / max that return NaN if either operand is NaN (jnp.minimum,
// jnp.maximum; fminf / fmaxf would drop it): PTX min.NaN / max.NaN.
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

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, t_min;
};

enum Mode { kClosest = 0, kRows = 1, kAnyHit = 2 };

// The walk's rays: load(i, ...) sets ray i's origin and direction, its
// exclusion id and its cap (row 7), and returns whether it is valid.
struct TileRays {
  const float* __restrict__ payload;  // [8, n]
  const uint8_t* __restrict__ valid;  // [n]
  size_t n;
  __device__ __forceinline__ bool load(size_t i, Ray& r, int& ex,
                                       float& cap) const {
    r.ox = payload[i];
    r.oy = payload[n + i];
    r.oz = payload[2 * n + i];
    r.dx = payload[3 * n + i];
    r.dy = payload[4 * n + i];
    r.dz = payload[5 * n + i];
    ex = (int)payload[6 * n + i];  // truncation, as torch's .to(int32)
    cap = payload[7 * n + i];
    return valid[i] != 0;
  }
};

// What a walk writes: t and pid (closest, rows), rows [32, n] from the
// shade table [P, 32] (rows), blocked (any-hit).
struct WalkOut {
  float* __restrict__ t;
  int* __restrict__ pid;
  float* __restrict__ rows;
  const float4* __restrict__ table;
  uint8_t* __restrict__ blocked;
  size_t n;
};

// One ray's stack of (child word, near) entries.  LocalStack holds
// kLocalStack of them in the thread's local memory; ScratchStack holds
// a deeper tree's in the wrapper's scratch buffer, entry e of thread g
// at e * stride + g (a warp's entries in one line), words then nears.
struct LocalStack {
  int w[kLocalStack];
  float n[kLocalStack];
  __device__ __forceinline__ void put(int sp, int word, float near) {
    w[sp] = word;
    n[sp] = near;
  }
  __device__ __forceinline__ int word(int sp) const { return w[sp]; }
  __device__ __forceinline__ float near(int sp) const { return n[sp]; }
};

struct ScratchStack {
  int* w;
  float* n;
  size_t stride;
  __device__ __forceinline__ void put(int sp, int word, float near) {
    w[(size_t)sp * stride] = word;
    n[(size_t)sp * stride] = near;
  }
  __device__ __forceinline__ int word(int sp) const { return w[(size_t)sp * stride]; }
  __device__ __forceinline__ float near(int sp) const { return n[(size_t)sp * stride]; }
};

// The children of node k: the first whose box passes -> its word (0:
// none) and near; the others that pass pushed in reverse preorder.
template <class Stack>
__device__ __forceinline__ int visit_node(const float4* __restrict__ nodes,
                                          int k, const Ray& r, float best_t,
                                          Stack& stack, int& sp) {
  const float4* node = nodes + (size_t)k * kNodeVecs;
  float b[6][kWidth];
#pragma unroll
  for (int row = 0; row < 6; ++row) {
#pragma unroll
    for (int v = 0; v < kRowVecs; ++v) {
      const float4 x = __ldg(node + row * kRowVecs + v);
      b[row][4 * v] = x.x;
      b[row][4 * v + 1] = x.y;
      b[row][4 * v + 2] = x.z;
      b[row][4 * v + 3] = x.w;
    }
  }
  int word[kWidth];
#pragma unroll
  for (int v = 0; v < kRowVecs; ++v) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(node) + 6 * kRowVecs + v);
    word[4 * v] = x.x;
    word[4 * v + 1] = x.y;
    word[4 * v + 2] = x.z;
    word[4 * v + 3] = x.w;
  }
  int next = 0;
  float next_near = 0.0f;
#pragma unroll
  for (int c = kWidth - 1; c >= 0; --c) {
    // _node_slab: per axis the slab distances' min and max, NaN if
    // either is NaN; near = the max of the axes' mins with NaN taken as
    // -inf (fmaxf drops a NaN operand, and -inf ends a row of NaNs),
    // far = the min of the maxes with NaN as +inf.
    float t0 = (b[0][c] - r.ox) * r.ix, t1 = (b[1][c] - r.ox) * r.ix;
    const float lx = min_nan(t0, t1), hx = max_nan(t0, t1);
    t0 = (b[2][c] - r.oy) * r.iy;
    t1 = (b[3][c] - r.oy) * r.iy;
    const float ly = min_nan(t0, t1), hy = max_nan(t0, t1);
    t0 = (b[4][c] - r.oz) * r.iz;
    t1 = (b[5][c] - r.oz) * r.iz;
    const float lz = min_nan(t0, t1), hz = max_nan(t0, t1);
    const float near = fmaxf(fmaxf(fmaxf(lx, ly), lz), -INFINITY);
    const float far = fminf(fminf(fminf(hx, hy), hz), INFINITY);
    if (word[c] != 0 && near <= far && far >= r.t_min && near <= best_t) {
      if (next != 0) stack.put(sp++, next, next_near);
      next = word[c];
      next_near = near;
    }
  }
  return next;
}

// The next entry whose near is still within best_t -> its word, or 0
// when the stack runs out (the ray is done).
template <class Stack>
__device__ __forceinline__ int pop(const Stack& stack, int& sp, float best_t) {
  while (sp > 0) {
    --sp;
    if (stack.near(sp) <= best_t) return stack.word(sp);
  }
  return 0;
}

// What a thread's walks did, for the trace counters: valid rays walked,
// wide-node visits, prim tests (excluded prims skipped), and of the
// any-hit mode its valid rays and those that found a blocker.
struct WalkCount {
  int rays = 0, nodes = 0, prims = 0, anyhit = 0, blocked = 0;
};

// Ray i's walk in MODE -> out at slot i; its work added to `count`.
template <int MODE, class Stack>
__device__ __forceinline__ void walk_ray(size_t i, const TileRays& rays,
                                         Stack& stack,
                                         const float4* __restrict__ nodes,
                                         const float4* __restrict__ prims,
                                         float t_min, float t_max, float eps,
                                         float miss_t, const WalkOut& out,
                                         WalkCount& count) {
  Ray r;
  int ex;
  float cap;
  const bool valid = rays.load(i, r, ex, cap);
  r.ix = 1.0f / r.dx;
  r.iy = 1.0f / r.dy;
  r.iz = 1.0f / r.dz;
  r.t_min = t_min;
  float best_t = MODE == kAnyHit ? cap : miss_t;
  int best_id = 0;
  bool blocked = false;
  int sp = 0;
  // cur: > 0 a node, 0 the root first and then done, < 0 a leaf.
  int cur = 0;
  bool live = valid;
  count.rays += live;
  while (live) {
    // Nodes until the ray holds a leaf or is done.
    while (cur >= 0) {
      const int next = visit_node(nodes, cur, r, best_t, stack, sp);
      ++count.nodes;
      cur = next != 0 ? next : pop(stack, sp, best_t);
      if (cur == 0) break;
    }
    if (cur == 0) break;
    // The leaf's prims, up to the one marked last (any-hit: or the
    // first that passes).
    for (int p = ~cur;; ++p) {
      const float4 a = __ldg(prims + 3 * p);
      const float4 e1 = __ldg(prims + 3 * p + 1);
      const float4 e2 = __ldg(prims + 3 * p + 2);
      const int pid = __float_as_int(a.w);
      float w;
      count.prims += pid != ex;
      if (pid != ex &&
          tri_edges(a, e1, e2, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, t_min,
                    t_max, eps, w) &&
          w > t_min && w < t_max && w < best_t) {
        if (MODE == kAnyHit) {
          blocked = true;
          break;
        }
        best_t = w;
        best_id = pid;
      }
      if (__float_as_int(e1.w) != 0) break;
    }
    if (MODE == kAnyHit && blocked) break;
    cur = pop(stack, sp, best_t);
    live = cur != 0;
  }
  if (MODE == kAnyHit) {
    out.blocked[i] = blocked;
    count.anyhit += valid;
    count.blocked += blocked;
    return;
  }
  out.t[i] = best_t;
  out.pid[i] = best_id;
  if (MODE == kRows) {
    // The winner's row (row 0 for a miss): 8 loads of one 128-byte
    // row, 32 stores each coalesced across the warp.
    const float4* src = out.table + (size_t)best_id * 8;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const float4 x = __ldg(src + v);
      out.rows[(size_t)(4 * v) * out.n + i] = x.x;
      out.rows[(size_t)(4 * v + 1) * out.n + i] = x.y;
      out.rows[(size_t)(4 * v + 2) * out.n + i] = x.z;
      out.rows[(size_t)(4 * v + 3) * out.n + i] = x.w;
    }
  }
}

// The block's walks added to walk_rays, walk_nodes and walk_prims
// (counters `counter` to `counter + 2`) and, in the any-hit mode, to
// walk_anyhit and walk_blocked (`counter + 3`, `counter + 4`) while the
// trace flag is set: one block reduction of the five counts.
template <int MODE>
__device__ __forceinline__ void count_walks(const WalkCount& count,
                                            long long* trace, int counter) {
  if (!trace_on(trace)) return;
  long long v[5] = {count.rays, count.nodes, count.prims, count.anyhit,
                    count.blocked};
  block_sum(v);
  if (threadIdx.x == 0)
    for (int k = 0; k < (MODE == kAnyHit ? 5 : 3); ++k)
      trace_add(trace, counter + k, v[k]);
}

// One thread a ray, its stack in local memory (trees whose walk needs
// at most kLocalStack entries).
template <int MODE>
__device__ __forceinline__ void walk_local(const TileRays& rays,
                                           const float4* __restrict__ nodes,
                                           const float4* __restrict__ prims,
                                           int n, float t_min, float t_max,
                                           float eps, float miss_t,
                                           const WalkOut& out,
                                           long long* __restrict__ trace,
                                           int counter) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  WalkCount count;
  if (i < n) {
    LocalStack stack;
    walk_ray<MODE>(i, rays, stack, nodes, prims, t_min, t_max, eps, miss_t,
                   out, count);
  }
  count_walks<MODE>(count, trace, counter);
}

// Deeper trees: each thread walks rays g, g + threads, ... with its
// stack of `depth` entries in `scratch` ([2, depth, threads] words).
template <int MODE>
__device__ __forceinline__ void walk_scratch(
    const TileRays& rays, const float4* __restrict__ nodes,
    const float4* __restrict__ prims, int* __restrict__ scratch, int n,
    int depth, float t_min, float t_max, float eps, float miss_t,
    const WalkOut& out, long long* __restrict__ trace, int counter) {
  const int g = blockIdx.x * kBlock + threadIdx.x;
  const size_t threads = (size_t)gridDim.x * kBlock;
  ScratchStack stack{scratch + g,
                     reinterpret_cast<float*>(scratch) + depth * threads + g,
                     threads};
  WalkCount count;
  for (size_t i = g; i < (size_t)n; i += threads) {
    walk_ray<MODE>(i, rays, stack, nodes, prims, t_min, t_max, eps, miss_t,
                   out, count);
  }
  count_walks<MODE>(count, trace, counter);
}

// The kernels, one pair per mode.
template <int MODE>
__global__ void __launch_bounds__(kBlock)
    bvh_walk_tiled_kernel(TileRays rays, const float4* __restrict__ nodes,
                          const float4* __restrict__ prims, int n,
                          float t_min, float t_max, float eps, float miss_t,
                          WalkOut out, long long* __restrict__ trace,
                          int counter) {
  walk_local<MODE>(rays, nodes, prims, n, t_min, t_max, eps, miss_t, out,
                   trace, counter);
}

template <int MODE>
__global__ void __launch_bounds__(kBlock)
    bvh_walk_tiled_scratch_kernel(TileRays rays,
                                  const float4* __restrict__ nodes,
                                  const float4* __restrict__ prims,
                                  int* __restrict__ scratch, int n, int depth,
                                  float t_min, float t_max, float eps,
                                  float miss_t, WalkOut out,
                                  long long* __restrict__ trace, int counter) {
  walk_scratch<MODE>(rays, nodes, prims, scratch, n, depth, t_min, t_max,
                     eps, miss_t, out, trace, counter);
}

template <int MODE>
cudaError_t launch_tiled(const TileRays& rays, const float4* nv,
                         const float4* pv, int* scratch, int n, int depth,
                         int threads, float t_min, float t_max, float eps,
                         float miss_t, const WalkOut& out, long long* trace,
                         int counter, cudaStream_t stream) {
  if (scratch == nullptr) {
    const unsigned blocks = (unsigned)((n + kBlock - 1) / kBlock);
    bvh_walk_tiled_kernel<MODE><<<blocks, kBlock, 0, stream>>>(
        rays, nv, pv, n, t_min, t_max, eps, miss_t, out, trace, counter);
  } else {
    bvh_walk_tiled_scratch_kernel<MODE>
        <<<(unsigned)(threads / kBlock), kBlock, 0, stream>>>(
            rays, nv, pv, scratch, n, depth, t_min, t_max, eps, miss_t, out,
            trace, counter);
  }
  return cudaGetLastError();
}

}  // namespace

// payload [8, n], valid [n] -> by mode (0 closest, 1 rows, 2 any-hit)
// t_out, pid_out [n], rows_out [32, n] from table [P, 32] (16-byte
// aligned), blocked_out [n]; the outputs a mode does not write may be
// null.  scratch null: the local-stack kernel (depth <= kLocalStack);
// else the scratch kernel on threads / kBlock blocks.
RT_EXPORT int rt_bvh_walk_tiled(const float* payload, const uint8_t* valid,
                                const int* nodes, const int* prims,
                                const float* table, int* scratch, int n,
                                int depth, int threads, int mode, float t_min,
                                float t_max, float eps, float miss_t,
                                float* t_out, int* pid_out, float* rows_out,
                                uint8_t* blocked_out, long long* trace,
                                int counter, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (scratch == nullptr ? depth > kLocalStack
                         : (threads <= 0 || threads % kBlock != 0))
    return (int)cudaErrorInvalidValue;
  const float4* nv = reinterpret_cast<const float4*>(nodes);
  const float4* pv = reinterpret_cast<const float4*>(prims);
  const TileRays rays{payload, valid, (size_t)n};
  const WalkOut out{t_out, pid_out, rows_out,
                    reinterpret_cast<const float4*>(table), blocked_out,
                    (size_t)n};
  const auto launch = [&](auto mode_const) {
    return launch_tiled<decltype(mode_const)::value>(
        rays, nv, pv, scratch, n, depth, threads, t_min, t_max, eps, miss_t,
        out, trace, counter, stream);
  };
  switch (mode) {
    case kClosest:
      return (int)launch(std::integral_constant<int, kClosest>{});
    case kRows:
      if (table == nullptr || rows_out == nullptr) return (int)cudaErrorInvalidValue;
      return (int)launch(std::integral_constant<int, kRows>{});
    case kAnyHit:
      return (int)launch(std::integral_constant<int, kAnyHit>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}
