// The RF-BVH records walk: closest hit per ray, or the closest hit with
// its shade row, or any hit below a cap, over the reduced-footprint
// 16-byte records where they lie.
//
// Replaces no pallas_call: it is the XLA lax.while_loop of
// rt_rs_tpu/handlers/rf.py::_rf_intersect, which steps the RF tree
// unpacked to f32 arrays.  Here one thread walks one ray over the
// records themselves (rt_rs_tpu_torch/bvh/rf.py packs them; the
// handler puts them on the device as one [R, 4] int32 tensor and keeps
// nothing else), the format of the reference's RfBvhIntrs
// (src/lib/handlers/rf.rs):
//   words 0-2: per axis (min, max) as two f16 in the low and high
//     halves, rounded outward at the pack;
//   word 3, the tag: an interior record's fst << 16 | snd (record
//     indices), a leaf's top bit, the leaf followed by a payload record
//     of 8 u16 slots (0 empty, else a prim id + 1 in the scene's own
//     order, the null row being prim 0).
// A record is one 16-byte load.  Each axis's bounds decode with
// __half2float (exact), then the slab test of
// rt_rs_tpu_torch/ops/bvh_walk.py::node_slab, op for op: the wobble
// 2e-6 + 1e-5 * max(|min|, |max|), the slab distances, NaN min / max,
// NaN near taken as -inf and NaN far as +inf.  A record is tested when
// the walk reaches it (near <= far, far >= t_min, near <= best_t), fst
// before snd (snd pushed on the stack): the records' preorder and the
// binary walk's order, with its best t at every test.  A leaf that
// passes tests its slots in order; a prim's corners come from the
// scene's own pa, pb, pc [P, 3] f32 (passed at each call, as the rows
// mode's shade table is), its edges b - a and c - a computed here, and
// its test is kernel G's (csrc/bvh_walk.cu), so the same f32 operations
// and bits.  A hit replaces the best when nearer, or as near with a
// smaller pid: ties go to the smallest pid, so (t, pid) is the
// brute-force closest hit's whatever the order of the tests.  Rays
// with valid == 0 return the miss sentinel (t_max + 1, 0).
//
// Modes (MODE below), on component-major ray tiles, with the arguments
// and outputs of kernel G's tiled entry:
//   0 closest: (t, pid);
//   1 rows: the same, and the winner's row of the scene's shade table
//     [P, 32] f32 written to rows [32, n] (row 0 for a miss or an
//     invalid ray);
//   2 any-hit: best_t starts at the ray's cap (payload row 7), every
//     test stays the closest walk's, and the ray stops at the first
//     prim that passes: blocked = 1, the closest walk's verdict
//     pid != 0 && t < cap bit for bit.
// Layouts: payload [8, n] f32 (rows 0-5 o and d, row 6 the f32
// exclusion id, row 7 the cap), valid [n] u8 -> t, pid [n] (modes 0,
// 1), rows [32, n] (mode 1), blocked [n] u8 (mode 2).
//
// The stack holds record indices (4 bytes), one entry a binary level
// at most.  Up to kLocalStack entries live in local memory (the
// *_kernel entries, one thread a ray); a deeper tree's walk keeps its
// stack in the wrapper's scratch buffer ([depth, threads] int32, the
// *_scratch_kernel entries, each thread a strided set of rays).
//
// While the trace buffer's flag is set (tracing.py), each block adds
// its valid rays, the node records whose box it tested and the
// non-empty, non-excluded slots it tested to rf_rays, rf_records and
// rf_prims, counted in registers and summed in one block reduction.
//
// What bounds it on this card: latency.  The records (98 KB for the
// teatime scene) stay in L1 and L2, but each record's test waits on
// its load, one binary level a step, so a ray's walk is a chain of
// dependent 16-byte loads.  No host read, so a frame that launches it
// can be captured in a CUDA graph.
#include <cuda_fp16.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kLocalStack = 64;  // stack entries in local memory (LOCAL_STACK)
constexpr int kBlock = 128;      // threads a block (BLOCK in ops/bvh_walk_rf.py)
constexpr unsigned kLeafBit = 0x80000000u;

enum Mode { kClosest = 0, kRows = 1, kAnyHit = 2 };

// min / max that return NaN if either operand is NaN (torch.minimum,
// torch.maximum): PTX min.NaN / max.NaN.
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

__device__ __forceinline__ float half_bits(unsigned h) {
  return __half2float(__ushort_as_half((unsigned short)h));
}

// One axis of node_slab: the record word's (min, max), wobbled, against
// the ray -> the slab distances' (min, max), NaN if either is NaN.
__device__ __forceinline__ void slab(unsigned word, float o, float inv,
                                     float& lo, float& hi) {
  const float bmin = half_bits(word & 0xFFFFu);
  const float bmax = half_bits(word >> 16);
  const float wob = 2e-6f + 1e-5f * fmaxf(fabsf(bmin), fabsf(bmax));
  const float t0 = (bmin - wob - o) * inv;
  const float t1 = (bmax + wob - o) * inv;
  lo = min_nan(t0, t1);
  hi = max_nan(t0, t1);
}

// rt_rs_tpu_torch/ops/intersect.py::tri_intersect_pairs for one (ray,
// prim), op for op (kernel G's tri_edges on e1 = b - a, e2 = c - a).
// Returns whether w lies in [t_min, t_max] and sets w.
__device__ __forceinline__ bool tri_test(const float* __restrict__ pa,
                                         const float* __restrict__ pb,
                                         const float* __restrict__ pc,
                                         int pid, float ox, float oy,
                                         float oz, float dx, float dy,
                                         float dz, float t_min, float t_max,
                                         float eps, float& w) {
  const size_t q = (size_t)pid * 3;
  const float ax = __ldg(pa + q), ay = __ldg(pa + q + 1), az = __ldg(pa + q + 2);
  const float e1x = __ldg(pb + q) - ax, e1y = __ldg(pb + q + 1) - ay,
              e1z = __ldg(pb + q + 2) - az;
  const float e2x = __ldg(pc + q) - ax, e2y = __ldg(pc + q + 1) - ay,
              e2z = __ldg(pc + q + 2) - az;
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

struct Prims {
  const float* __restrict__ pa;  // [P, 3]
  const float* __restrict__ pb;
  const float* __restrict__ pc;
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

// One ray's stack of record indices: LocalStack in the thread's local
// memory, ScratchStack in the wrapper's buffer (entry e of thread g at
// e * stride + g, a warp's entries in one line).
struct LocalStack {
  int w[kLocalStack];
  __device__ __forceinline__ void put(int sp, int rec) { w[sp] = rec; }
  __device__ __forceinline__ int get(int sp) const { return w[sp]; }
};

struct ScratchStack {
  int* w;
  size_t stride;
  __device__ __forceinline__ void put(int sp, int rec) { w[(size_t)sp * stride] = rec; }
  __device__ __forceinline__ int get(int sp) const { return w[(size_t)sp * stride]; }
};

// What a thread's walks did, for the trace counters.
struct WalkCount {
  int rays = 0, records = 0, prims = 0;
};

// Ray i's walk in MODE -> out at slot i; its work added to `count`.
template <int MODE, class Stack>
__device__ __forceinline__ void walk_ray(size_t i, const float* __restrict__ payload,
                                         const uint8_t* __restrict__ valid_in,
                                         size_t n, Stack& stack,
                                         const uint4* __restrict__ records,
                                         const Prims& prims, float t_min,
                                         float t_max, float eps, float miss_t,
                                         const WalkOut& out, WalkCount& count) {
  const float ox = payload[i], oy = payload[n + i], oz = payload[2 * n + i];
  const float dx = payload[3 * n + i], dy = payload[4 * n + i],
              dz = payload[5 * n + i];
  const int ex = (int)payload[6 * n + i];  // truncation, as torch's .to(int32)
  const float cap = payload[7 * n + i];
  const bool valid = valid_in[i] != 0;
  const float ix = 1.0f / dx, iy = 1.0f / dy, iz = 1.0f / dz;
  float best_t = MODE == kAnyHit ? cap : miss_t;
  int best_id = 0;
  bool blocked = false;
  int sp = 0;
  int cur = valid ? 0 : -1;  // the record to test; -1 done
  count.rays += valid;
  while (cur >= 0) {
    const uint4 rec = __ldg(records + cur);
    ++count.records;
    float lx, hx, ly, hy, lz, hz;
    slab(rec.x, ox, ix, lx, hx);
    slab(rec.y, oy, iy, ly, hy);
    slab(rec.z, oz, iz, lz, hz);
    // fmaxf drops a NaN operand, and -inf ends a row of NaNs
    const float near = fmaxf(fmaxf(fmaxf(lx, ly), lz), -INFINITY);
    const float far = fminf(fminf(fminf(hx, hy), hz), INFINITY);
    if (near <= far && far >= t_min && near <= best_t) {
      if ((rec.w & kLeafBit) == 0) {
        // interior: fst now, snd later
        stack.put(sp++, (int)(rec.w & 0xFFFFu));
        cur = (int)((rec.w >> 16) & 0x7FFFu);
        continue;
      }
      const uint4 slots = __ldg(records + cur + 1);
      const unsigned words[4] = {slots.x, slots.y, slots.z, slots.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int pid = (int)((words[k >> 1] >> (16 * (k & 1))) & 0xFFFFu);
        if (pid == 0 || pid == ex) continue;
        ++count.prims;
        float w;
        if (!tri_test(prims.pa, prims.pb, prims.pc, pid, ox, oy, oz, dx, dy,
                      dz, t_min, t_max, eps, w) ||
            !(w > t_min && w < t_max))
          continue;
        if (MODE == kAnyHit) {
          if (w < best_t) {
            blocked = true;
            break;
          }
        } else if (w < best_t || (w == best_t && pid < best_id)) {
          best_t = w;
          best_id = pid;
        }
      }
      if (MODE == kAnyHit && blocked) break;
    }
    cur = sp > 0 ? stack.get(--sp) : -1;
  }
  if (MODE == kAnyHit) {
    out.blocked[i] = blocked;
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

// The block's walks added to rf_rays, rf_records and rf_prims
// (counters `counter` to `counter + 2`) while the trace flag is set.
__device__ __forceinline__ void count_walks(const WalkCount& count,
                                            long long* trace, int counter) {
  if (!trace_on(trace)) return;
  long long v[3] = {count.rays, count.records, count.prims};
  block_sum(v);
  if (threadIdx.x == 0)
    for (int k = 0; k < 3; ++k) trace_add(trace, counter + k, v[k]);
}

// One thread a ray, its stack in local memory.
template <int MODE>
__global__ void __launch_bounds__(kBlock)
    bvh_walk_rf_kernel(const float* __restrict__ payload,
                       const uint8_t* __restrict__ valid,
                       const uint4* __restrict__ records, Prims prims, int n,
                       float t_min, float t_max, float eps, float miss_t,
                       WalkOut out, long long* __restrict__ trace,
                       int counter) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  WalkCount count;
  if (i < n) {
    LocalStack stack;
    walk_ray<MODE>(i, payload, valid, (size_t)n, stack, records, prims, t_min,
                   t_max, eps, miss_t, out, count);
  }
  count_walks(count, trace, counter);
}

// Deeper trees: each thread walks rays g, g + threads, ... with its
// stack of `depth` entries in `scratch` ([depth, threads] words).
template <int MODE>
__global__ void __launch_bounds__(kBlock)
    bvh_walk_rf_scratch_kernel(const float* __restrict__ payload,
                               const uint8_t* __restrict__ valid,
                               const uint4* __restrict__ records,
                               Prims prims, int* __restrict__ scratch, int n,
                               float t_min, float t_max, float eps,
                               float miss_t, WalkOut out,
                               long long* __restrict__ trace, int counter) {
  const int g = blockIdx.x * kBlock + threadIdx.x;
  const size_t threads = (size_t)gridDim.x * kBlock;
  ScratchStack stack{scratch + g, threads};
  WalkCount count;
  for (size_t i = g; i < (size_t)n; i += threads) {
    walk_ray<MODE>(i, payload, valid, (size_t)n, stack, records, prims,
                   t_min, t_max, eps, miss_t, out, count);
  }
  count_walks(count, trace, counter);
}

template <int MODE>
cudaError_t launch(const float* payload, const uint8_t* valid,
                   const uint4* records, const Prims& prims, int* scratch,
                   int n, int threads, float t_min, float t_max, float eps,
                   float miss_t, const WalkOut& out, long long* trace,
                   int counter, cudaStream_t stream) {
  if (scratch == nullptr) {
    const unsigned blocks = (unsigned)((n + kBlock - 1) / kBlock);
    bvh_walk_rf_kernel<MODE><<<blocks, kBlock, 0, stream>>>(
        payload, valid, records, prims, n, t_min, t_max, eps, miss_t, out,
        trace, counter);
  } else {
    bvh_walk_rf_scratch_kernel<MODE>
        <<<(unsigned)(threads / kBlock), kBlock, 0, stream>>>(
            payload, valid, records, prims, scratch, n, t_min, t_max, eps,
            miss_t, out, trace, counter);
  }
  return cudaGetLastError();
}

}  // namespace

// payload [8, n], valid [n], records [R, 4] int32, pa / pb / pc [P, 3]
// f32 -> by mode (0 closest, 1 rows, 2 any-hit) t_out, pid_out [n],
// rows_out [32, n] from table [P, 32] (16-byte aligned), blocked_out
// [n]; the outputs a mode does not write may be null.  scratch null:
// the local-stack kernel (depth <= kLocalStack); else the scratch
// kernel on threads / kBlock blocks, scratch [depth, threads] int32.
RT_EXPORT int rt_bvh_walk_rf_tiled(const float* payload, const uint8_t* valid,
                                   const int* records, const float* pa,
                                   const float* pb, const float* pc,
                                   const float* table, int* scratch, int n,
                                   int depth, int threads, int mode,
                                   float t_min, float t_max, float eps,
                                   float miss_t, float* t_out, int* pid_out,
                                   float* rows_out, uint8_t* blocked_out,
                                   long long* trace, int counter,
                                   cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (scratch == nullptr ? depth > kLocalStack
                         : (threads <= 0 || threads % kBlock != 0))
    return (int)cudaErrorInvalidValue;
  const uint4* rv = reinterpret_cast<const uint4*>(records);
  const Prims prims{pa, pb, pc};
  const WalkOut out{t_out, pid_out, rows_out,
                    reinterpret_cast<const float4*>(table), blocked_out,
                    (size_t)n};
  const auto go = [&](auto mode_const) {
    return launch<decltype(mode_const)::value>(
        payload, valid, rv, prims, scratch, n, threads, t_min, t_max, eps,
        miss_t, out, trace, counter, stream);
  };
  switch (mode) {
    case kClosest:
      return (int)go(std::integral_constant<int, kClosest>{});
    case kRows:
      if (table == nullptr || rows_out == nullptr) return (int)cudaErrorInvalidValue;
      return (int)go(std::integral_constant<int, kRows>{});
    case kAnyHit:
      return (int)go(std::integral_constant<int, kAnyHit>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}
