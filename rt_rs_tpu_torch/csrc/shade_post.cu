// Kernel D: shade_post, the second half of a bounce's shading.
//
// Replaces rt_rs_tpu/ops/pallas/shade_tile.py::_shade_post_kernel (with
// _post_subgroup and _hit_normal).  Per ray of a live 8-tile subgroup:
// for each light, the shadow verdict, and the Blinn/Phong colour
// contribution of the lit lights (the arithmetic is shade_post_color,
// shade_body.cuh, shared with kernel F).  Rays of a subgroup with no
// live ray get zeros.
//
// Layouts: table [P + 1, 32] (the scene's shade table, 16-byte
// aligned), pid [T, r] i32 (each ray's hit, 0 for a dead ray), payload
// [8, T, r], t / active [T, r], sh_t / sh_id / caps [k, T, r], live_sg
// [T / 8] i32, lights [k, 4] -> out [3, T, r]; T is a multiple of 8.  While the trace buffer's flag
// is set (tracing.py), block 0 adds T * r to counter + 1 (slots.b) and
// each live block its rays with active set to counter (live_rays.b).
//
// What bounds it on this card: memory.  A ray of a live subgroup reads
// pid, 6 payload rows, t, active and 1 (blocked_mode) or 3 floats a
// light from the planes, and 112 B of its table row (vectors 0-6:
// columns 0-27), and writes 3 floats, at ~50 flops a light: far below
// the balance point.  The table stays in L2 (0.8 MB for 6,322
// triangles), so DRAM sees (9 + K or 3 K) floats in and 3 out a ray.  At
// 384x288 (one partial wave) a call is as long as its chain of round
// trips, so the design keeps that chain short:
//
// * A block covers POST_RAYS consecutive rays of one 8-tile subgroup, so
//   its liveness is one word, uniform across the block, read before any
//   data: a dead block writes its zeros with 16-byte stores and reads
//   nothing else.
// * A live thread issues every load of its planes (pid, 6 payload rows,
//   t, active, K or 3 K) before any arithmetic, into registers, then its
//   row's 7 vectors, which depend on pid: two round trips for all its
//   bytes after the flag's.  The kernel is instantiated for each
//   light count K = 1..4 and both modes, so a thread holds exactly the
//   planes its call reads; other counts take K = 0, which reads the light
//   planes where the arithmetic uses them.
// * POST_RAYS = 128: a 384x288 frame's 54 subgroups of 2,048 rays make
//   864 blocks, spread over the 132 SMs within ~7% of even.
//
// The designs it was measured against, each bit-checked first and all
// slower (1-D bulk copies into shared memory, shared memory filled by
// 16-byte loads, two or four rays a thread, reading liveness with the
// data, other block sizes), and their times are in PERF.md section 6,
// row 4 (PR 14).
#include "shade_body.cuh"

constexpr int POST_RAYS = 128;  // rays (threads) of a block
constexpr int SUBGROUP_TILES = 8;

// v[li] for a runtime li without indexing a local array (selects).
template <int N>
__device__ __forceinline__ float pick(const float (&v)[N], int li) {
  float x = v[0];
#pragma unroll
  for (int j = 1; j < N; ++j) x = (li == j) ? v[j] : x;
  return x;
}

// shade_post_color's operands of one ray, loaded into registers: K
// lights' planes (K = 0: read from global memory where used).
template <int K, int BLOCKED>
struct PostRegs {
  static constexpr int KS = K > 0 ? K : 1;
  static constexpr int KC = K > 0 && !BLOCKED ? K : 1;
  TableRow<kPostVectors> rw;
  float p[6], tt, act, st[KS], sid[KC], cp[KC];
  const float* __restrict__ sh_t_g;
  const float* __restrict__ sh_id_g;
  const float* __restrict__ caps_g;
  const float* __restrict__ lights;
  long plane, idx;

  __device__ __forceinline__ float row(int c) const { return rw(c); }
  __device__ __forceinline__ float pay(int c) const { return p[c]; }
  __device__ __forceinline__ float t() const { return tt; }
  __device__ __forceinline__ float active() const { return act; }
  __device__ __forceinline__ float sh_t(int li) const {
    return K > 0 ? pick(st, li) : sh_t_g[li * plane + idx];
  }
  __device__ __forceinline__ float sh_id(int li) const {
    return K > 0 && !BLOCKED ? pick(sid, li) : sh_id_g[li * plane + idx];
  }
  __device__ __forceinline__ float cap(int li) const {
    return K > 0 && !BLOCKED ? pick(cp, li) : caps_g[li * plane + idx];
  }
  __device__ __forceinline__ float light(int li, int c) const { return lights[li * 4 + c]; }
};

template <int K, int BLOCKED>
__global__ void __launch_bounds__(POST_RAYS) shade_post_kernel(
    const float* __restrict__ table, const int* __restrict__ pid,
    const float* __restrict__ payload, const float* __restrict__ t_in,
    const float* __restrict__ active, const float* __restrict__ sh_t,
    const float* __restrict__ sh_id, const float* __restrict__ caps,
    const int* __restrict__ live_sg, const float* __restrict__ lights, int k,
    int n_tiles, int r, int first_bounce, float t_min, float t_max,
    float* __restrict__ out, long long* __restrict__ trace, int counter) {
  const long plane = (long)n_tiles * r;
  const int sg_rays = SUBGROUP_TILES * r;
  const int per_sg = (sg_rays + POST_RAYS - 1) / POST_RAYS;
  const long sg = blockIdx.x / per_sg;
  const int j = (int)(blockIdx.x - sg * per_sg);
  const long ray0 = sg * sg_rays + (long)j * POST_RAYS;
  // a multiple of 8 rays from a multiple of 4: whole 16-byte stores
  const int n = min(POST_RAYS, sg_rays - j * POST_RAYS);
  if (blockIdx.x == 0 && threadIdx.x == 0 && trace_on(trace))
    trace_add(trace, counter + 1, plane);  // slots.b
  if (live_sg[sg] == 0) {
    for (int q = threadIdx.x; q < 3 * (n / 4); q += POST_RAYS) {
      const int c = q / (n / 4);
      reinterpret_cast<float4*>(out + c * plane + ray0)[q - c * (n / 4)] =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    return;
  }
  // Threads past n (none where r is a multiple of 16) read ray0's
  // operands and store nothing.
  const bool mine = (int)threadIdx.x < n;
  const long idx = ray0 + (mine ? threadIdx.x : 0);
  PostRegs<K, BLOCKED> in;
  const int hit = pid[idx];
#pragma unroll
  for (int c = 0; c < 6; ++c) in.p[c] = payload[c * plane + idx];
  in.tt = t_in[idx];
  in.act = active[idx];
  if constexpr (K > 0) {
#pragma unroll
    for (int li = 0; li < K; ++li) {
      in.st[li] = sh_t[li * plane + idx];
      if constexpr (!BLOCKED) {
        in.sid[li] = sh_id[li * plane + idx];
        in.cp[li] = caps[li * plane + idx];
      }
    }
  }
  in.rw.load(table, hit);
  in.sh_t_g = sh_t, in.sh_id_g = sh_id, in.caps_g = caps, in.lights = lights;
  in.plane = plane, in.idx = idx;
  float color[3];
  shade_post_color(in, K > 0 ? K : k, first_bounce, BLOCKED, t_min, t_max, color);
  if (mine)
    for (int c = 0; c < 3; ++c) out[c * plane + idx] = color[c];
  if (trace_on(trace)) {  // live_rays.b
    const int live = __syncthreads_count(mine && in.act > 0.0f);
    if (threadIdx.x == 0) trace_add(trace, counter, live);
  }
}

template <int BLOCKED>
static void launch(unsigned blocks, cudaStream_t stream, const float* table,
                   const int* pid, const float* payload, const float* t_in,
                   const float* active, const float* sh_t, const float* sh_id,
                   const float* caps,
                   const int* live_sg, const float* lights, int k, int n_tiles,
                   int r, int first_bounce, float t_min, float t_max,
                   float* out, long long* trace, int counter) {
  auto kernel = shade_post_kernel<0, BLOCKED>;
  switch (k) {
    case 1: kernel = shade_post_kernel<1, BLOCKED>; break;
    case 2: kernel = shade_post_kernel<2, BLOCKED>; break;
    case 3: kernel = shade_post_kernel<3, BLOCKED>; break;
    case 4: kernel = shade_post_kernel<4, BLOCKED>; break;
  }
  kernel<<<blocks, POST_RAYS, 0, stream>>>(table, pid, payload, t_in, active,
                                            sh_t, sh_id, caps, live_sg, lights,
                                            k, n_tiles, r, first_bounce, t_min,
                                            t_max, out, trace, counter);
}

RT_EXPORT int rt_shade_post(const float* table, const int* pid,
                            const float* payload, const float* t_in,
                            const float* active, const float* sh_t,
                            const float* sh_id, const float* caps,
                            const int* live_sg, const float* lights, int k,
                            int n_tiles, int r,
                            int first_bounce, int blocked_mode, float t_min,
                            float t_max, float* out, long long* trace,
                            int counter, cudaStream_t stream) {
  const long per_sg = (SUBGROUP_TILES * (long)r + POST_RAYS - 1) / POST_RAYS;
  const long blocks = (long)(n_tiles / SUBGROUP_TILES) * per_sg;
  if (blocks > 0)
    (blocked_mode ? launch<1> : launch<0>)(
        (unsigned)blocks, stream, table, pid, payload, t_in, active, sh_t,
        sh_id, caps, live_sg, lights, k, n_tiles, r, first_bounce, t_min, t_max, out,
        trace, counter);
  return (int)cudaGetLastError();
}
