// Kernel D's design variants, for experiments/post_ablation/post_ablation.py:
// the same entry point as rt_rs_tpu_torch/csrc/shade_post.cu, built in its
// place from a copy of csrc/.  Three constants pick the variant:
//
// * POST_STAGE: where a block's operands go before the arithmetic.
//   0: one 1-D bulk copy (TMA, cp.async.bulk) per input plane into
//   shared memory, issued by warp 0 against one mbarrier; 1: registers,
//   one ray a thread, every load issued before any arithmetic; 2: shared
//   memory, filled by every thread with 16-byte loads, all issued before
//   the first store, then one __syncthreads; 3: registers as 1, the
//   kernel specialised on the light count and blocked_mode, POST_RPT
//   rays a thread loaded as POST_RPT-wide vectors.
// * POST_RAYS: rays (threads) of a block; a block never spans two 8-tile
//   subgroups.
// * POST_FLAG_FIRST: 1 reads the subgroup's liveness word before any data
//   (a dead block reads nothing else); 0 issues it with the data (a dead
//   block drops the data).
// * POST_MIN_BLOCKS: __launch_bounds__' blocks per SM, which caps the
//   registers a thread may use (0: no cap).
//
// The arithmetic is shade_body.cuh's shade_post_color in every variant.
#include "shade_body.cuh"

constexpr int POST_STAGE = 0;
constexpr int POST_RAYS = 128;
constexpr int POST_FLAG_FIRST = 1;
constexpr int POST_MIN_BLOCKS = 0;
constexpr int POST_RPT = 1;  // POST_STAGE 3: rays a thread, loaded as vectors
constexpr int POST_LIGHTS = 4;  // lights whose planes are staged
constexpr int SUBGROUP_TILES = 8;
// Staged planes: rows 0-24, payload 0-5, t, active, then per staged
// light sh_t (and sh_id, caps unless blocked_mode).
constexpr int P_PAY = 25, P_T = 31, P_ACTIVE = 32, P_LIGHT = 33;
constexpr int MAX_PLANES = P_LIGHT + 3 * POST_LIGHTS;
// Shared memory: the mbarrier in the first 16 bytes, the staged lights,
// then the planes, POST_RAYS floats each.
constexpr int POST_HEAD = 16 + 16 * POST_LIGHTS;

__host__ __device__ constexpr int post_planes(int k, int blocked_mode) {
  return P_LIGHT + (k < POST_LIGHTS ? k : POST_LIGHTS) * (blocked_mode ? 1 : 3);
}

// The global address of staged plane p's first ray.
__device__ __forceinline__ const float* plane_src(
    int p, int per_light, long plane, const float* rows, const float* payload,
    const float* t_in, const float* active, const float* sh_t,
    const float* sh_id, const float* caps) {
  if (p < P_PAY) return rows + p * plane;
  if (p < P_T) return payload + (p - P_PAY) * plane;
  if (p == P_T) return t_in;
  if (p == P_ACTIVE) return active;
  const int li = (p - P_LIGHT) / per_light, q = (p - P_LIGHT) % per_light;
  return (q == 0 ? sh_t : q == 1 ? sh_id : caps) + li * plane;
}

// shade_post_color's operands of ray i of a block, from the staged planes.
struct PostStaged {
  const float* s;   // [planes][POST_RAYS]
  const float* ls;  // [POST_LIGHTS][4]
  int i, per_light;
  // lights past POST_LIGHTS: global memory, ray idx of the planes
  const float* __restrict__ sh_t_g;
  const float* __restrict__ sh_id_g;
  const float* __restrict__ caps_g;
  const float* __restrict__ lights_g;
  long plane, idx;

  __device__ __forceinline__ float at(int p) const { return s[p * POST_RAYS + i]; }
  __device__ __forceinline__ float row(int c) const { return at(c); }
  __device__ __forceinline__ float pay(int c) const { return at(P_PAY + c); }
  __device__ __forceinline__ float t() const { return at(P_T); }
  __device__ __forceinline__ float active() const { return at(P_ACTIVE); }
  __device__ __forceinline__ float sh_t(int li) const {
    return li < POST_LIGHTS ? at(P_LIGHT + li * per_light) : sh_t_g[li * plane + idx];
  }
  __device__ __forceinline__ float sh_id(int li) const {
    return li < POST_LIGHTS ? at(P_LIGHT + li * per_light + 1) : sh_id_g[li * plane + idx];
  }
  __device__ __forceinline__ float cap(int li) const {
    return li < POST_LIGHTS ? at(P_LIGHT + li * per_light + 2) : caps_g[li * plane + idx];
  }
  __device__ __forceinline__ float light(int li, int c) const {
    return li < POST_LIGHTS ? ls[li * 4 + c] : lights_g[li * 4 + c];
  }
};

// v[li] for a runtime li without indexing a local array (selects).
__device__ __forceinline__ float pick(const float (&v)[POST_LIGHTS], int li) {
  float x = v[0];
#pragma unroll
  for (int j = 1; j < POST_LIGHTS; ++j) x = (li == j) ? v[j] : x;
  return x;
}

// shade_post_color's operands of one ray, loaded into registers.
struct PostRegs {
  float r[25], p[6], tt, act;
  float st[POST_LIGHTS], sid[POST_LIGHTS], cp[POST_LIGHTS], lt[4][POST_LIGHTS];
  const float* __restrict__ sh_t_g;
  const float* __restrict__ sh_id_g;
  const float* __restrict__ caps_g;
  const float* __restrict__ lights_g;
  long plane, idx;

  __device__ __forceinline__ float row(int c) const { return r[c]; }
  __device__ __forceinline__ float pay(int c) const { return p[c]; }
  __device__ __forceinline__ float t() const { return tt; }
  __device__ __forceinline__ float active() const { return act; }
  __device__ __forceinline__ float sh_t(int li) const {
    return li < POST_LIGHTS ? pick(st, li) : sh_t_g[li * plane + idx];
  }
  __device__ __forceinline__ float sh_id(int li) const {
    return li < POST_LIGHTS ? pick(sid, li) : sh_id_g[li * plane + idx];
  }
  __device__ __forceinline__ float cap(int li) const {
    return li < POST_LIGHTS ? pick(cp, li) : caps_g[li * plane + idx];
  }
  __device__ __forceinline__ float light(int li, int c) const {
    return li < POST_LIGHTS ? pick(lt[c], li) : lights_g[li * 4 + c];
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const float* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Zeros in out's 3 planes for n rays from ray0, 16 bytes a store
// (n is a multiple of 8 and ray0 of 4).
__device__ __forceinline__ void zero_rays(float* __restrict__ out, long plane,
                                          long ray0, int n) {
  const int quads = n / 4;
  for (int q = threadIdx.x; q < 3 * quads; q += blockDim.x) {
    const int c = q / quads;
    reinterpret_cast<float4*>(out + c * plane + ray0)[q - c * quads] =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// POST_STAGE 3: registers, one ray a thread, the kernel specialised on
// the light count K (1-4; 0: any, the light planes read where used) and
// blocked_mode, so a thread loads and holds just the planes its call
// reads (row 23 only after bounce 0).
template <int K, int BLOCKED>
struct PostRegsK {
  float r[25], p[6], tt, act;
  float st[K > 0 ? K : 1], sid[K > 0 && !BLOCKED ? K : 1], cp[K > 0 && !BLOCKED ? K : 1];
  const float* __restrict__ sh_t_g;
  const float* __restrict__ sh_id_g;
  const float* __restrict__ caps_g;
  const float* __restrict__ lights_g;
  long plane, idx;

  __device__ __forceinline__ float row(int c) const { return r[c]; }
  __device__ __forceinline__ float pay(int c) const { return p[c]; }
  __device__ __forceinline__ float t() const { return tt; }
  __device__ __forceinline__ float active() const { return act; }
  template <int N>
  __device__ __forceinline__ static float sel(const float (&v)[N], int li) {
    float x = v[0];
#pragma unroll
    for (int j = 1; j < N; ++j) x = (li == j) ? v[j] : x;
    return x;
  }
  __device__ __forceinline__ float sh_t(int li) const {
    return K > 0 ? sel(st, li) : sh_t_g[li * plane + idx];
  }
  __device__ __forceinline__ float sh_id(int li) const {
    return K > 0 && !BLOCKED ? sel(sid, li) : sh_id_g[li * plane + idx];
  }
  __device__ __forceinline__ float cap(int li) const {
    return K > 0 && !BLOCKED ? sel(cp, li) : caps_g[li * plane + idx];
  }
  __device__ __forceinline__ float light(int li, int c) const { return lights_g[li * 4 + c]; }
};

// RPT floats from p (8 * RPT-byte aligned) into v: one vector load.
template <int RPT>
__device__ __forceinline__ void load_rpt(const float* __restrict__ p, float (&v)[RPT]) {
  if constexpr (RPT == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else if constexpr (RPT == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  } else {
    v[0] = *p;
  }
}

template <int K, int BLOCKED>
__global__ void __launch_bounds__(POST_RAYS / POST_RPT) shade_post_regs_kernel(
    const float* __restrict__ rows, const float* __restrict__ payload,
    const float* __restrict__ t_in, const float* __restrict__ active,
    const float* __restrict__ sh_t, const float* __restrict__ sh_id,
    const float* __restrict__ caps, const int* __restrict__ live_sg,
    const float* __restrict__ lights, int k, int n_tiles, int r,
    int first_bounce, float t_min, float t_max, float* __restrict__ out) {
  constexpr int RPT = POST_RPT;
  const long plane = (long)n_tiles * r;
  const int sg_rays = SUBGROUP_TILES * r;
  const int per_sg = (sg_rays + POST_RAYS - 1) / POST_RAYS;
  const long b = blockIdx.x;
  const long sg = b / per_sg;
  const int j = (int)(b - sg * per_sg);
  const long ray0 = sg * sg_rays + (long)j * POST_RAYS;
  const int n = min(POST_RAYS, sg_rays - j * POST_RAYS);
  if (live_sg[sg] == 0) {
    zero_rays(out, plane, ray0, n);
    return;
  }
  const int i0 = RPT * (int)threadIdx.x;
  if (i0 >= n) return;
  const long idx0 = ray0 + i0;
  PostRegsK<K, BLOCKED> in[RPT];
  float v[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) in[q].r[23] = 0.0f;  // read after bounce 0 only
#pragma unroll
  for (int c = 0; c < 25; ++c) {
    if (c == 23 && first_bounce) continue;
    load_rpt<RPT>(rows + c * plane + idx0, v);
#pragma unroll
    for (int q = 0; q < RPT; ++q) in[q].r[c] = v[q];
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    load_rpt<RPT>(payload + c * plane + idx0, v);
#pragma unroll
    for (int q = 0; q < RPT; ++q) in[q].p[c] = v[q];
  }
  load_rpt<RPT>(t_in + idx0, v);
#pragma unroll
  for (int q = 0; q < RPT; ++q) in[q].tt = v[q];
  load_rpt<RPT>(active + idx0, v);
#pragma unroll
  for (int q = 0; q < RPT; ++q) in[q].act = v[q];
  if constexpr (K > 0) {
#pragma unroll
    for (int li = 0; li < K; ++li) {
      load_rpt<RPT>(sh_t + li * plane + idx0, v);
#pragma unroll
      for (int q = 0; q < RPT; ++q) in[q].st[li] = v[q];
      if constexpr (!BLOCKED) {
        load_rpt<RPT>(sh_id + li * plane + idx0, v);
#pragma unroll
        for (int q = 0; q < RPT; ++q) in[q].sid[li] = v[q];
        load_rpt<RPT>(caps + li * plane + idx0, v);
#pragma unroll
        for (int q = 0; q < RPT; ++q) in[q].cp[li] = v[q];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    in[q].sh_t_g = sh_t, in[q].sh_id_g = sh_id, in[q].caps_g = caps, in[q].lights_g = lights;
    in[q].plane = plane, in[q].idx = idx0 + q;
    float color[3];
    shade_post_color(in[q], K > 0 ? K : k, first_bounce, BLOCKED, t_min, t_max, color);
    for (int c = 0; c < 3; ++c) out[c * plane + idx0 + q] = color[c];
  }
}

template <int K, int BLOCKED>
void launch_regs(unsigned blocks, cudaStream_t stream, const float* rows,
                 const float* payload, const float* t_in, const float* active,
                 const float* sh_t, const float* sh_id, const float* caps,
                 const int* live_sg, const float* lights, int k, int n_tiles,
                 int r, int first_bounce, float t_min, float t_max, float* out) {
  shade_post_regs_kernel<K, BLOCKED><<<blocks, POST_RAYS / POST_RPT, 0, stream>>>(
      rows, payload, t_in, active, sh_t, sh_id, caps, live_sg, lights, k,
      n_tiles, r, first_bounce, t_min, t_max, out);
}

template <int BLOCKED>
void launch_regs_k(unsigned blocks, cudaStream_t stream, const float* rows,
                   const float* payload, const float* t_in, const float* active,
                   const float* sh_t, const float* sh_id, const float* caps,
                   const int* live_sg, const float* lights, int k, int n_tiles,
                   int r, int first_bounce, float t_min, float t_max, float* out) {
#define RT_REGS(KK)                                                          \
  launch_regs<KK, BLOCKED>(blocks, stream, rows, payload, t_in, active, sh_t, \
                           sh_id, caps, live_sg, lights, k, n_tiles, r,       \
                           first_bounce, t_min, t_max, out)
  switch (k) {
    case 1: RT_REGS(1); break;
    case 2: RT_REGS(2); break;
    case 3: RT_REGS(3); break;
    case 4: RT_REGS(4); break;
    default: RT_REGS(0);
  }
#undef RT_REGS
}

__global__ void __launch_bounds__(POST_RAYS, POST_MIN_BLOCKS > 0 ? POST_MIN_BLOCKS : 1) shade_post_kernel(
    const float* __restrict__ rows, const float* __restrict__ payload,
    const float* __restrict__ t_in, const float* __restrict__ active,
    const float* __restrict__ sh_t, const float* __restrict__ sh_id,
    const float* __restrict__ caps, const int* __restrict__ live_sg,
    const float* __restrict__ lights, int k, int n_tiles, int r,
    int first_bounce, int blocked_mode, float t_min, float t_max,
    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long plane = (long)n_tiles * r;
  const int sg_rays = SUBGROUP_TILES * r;
  const int per_sg = (sg_rays + POST_RAYS - 1) / POST_RAYS;
  const long b = blockIdx.x;
  const long sg = b / per_sg;
  const int j = (int)(b - sg * per_sg);
  const long ray0 = sg * sg_rays + (long)j * POST_RAYS;
  const int n = min(POST_RAYS, sg_rays - j * POST_RAYS);
  const int tid = threadIdx.x;
  const int kl = min(k, POST_LIGHTS);
  const int per_light = blocked_mode ? 1 : 3;
  const int planes = post_planes(k, blocked_mode);
  const long idx = ray0 + tid;

  bool live = true;
  if constexpr (POST_FLAG_FIRST != 0) {
    live = live_sg[sg] != 0;
    if (!live) {
      zero_rays(out, plane, ray0, n);
      return;
    }
  }

  if constexpr (POST_STAGE == 1) {
    PostRegs in;
    in.sh_t_g = sh_t, in.sh_id_g = sh_id, in.caps_g = caps, in.lights_g = lights;
    in.plane = plane, in.idx = idx;
    if (tid < n) {
#pragma unroll
      for (int c = 0; c < 25; ++c) in.r[c] = rows[c * plane + idx];
#pragma unroll
      for (int c = 0; c < 6; ++c) in.p[c] = payload[c * plane + idx];
      in.tt = t_in[idx];
      in.act = active[idx];
#pragma unroll
      for (int li = 0; li < POST_LIGHTS; ++li) {
        in.st[li] = li < k ? sh_t[li * plane + idx] : 0.0f;
        in.sid[li] = li < k && !blocked_mode ? sh_id[li * plane + idx] : 0.0f;
        in.cp[li] = li < k && !blocked_mode ? caps[li * plane + idx] : 0.0f;
#pragma unroll
        for (int c = 0; c < 4; ++c) in.lt[c][li] = li < k ? lights[li * 4 + c] : 0.0f;
      }
    }
    if constexpr (POST_FLAG_FIRST == 0) live = live_sg[sg] != 0;
    if (!live) {
      zero_rays(out, plane, ray0, n);
      return;
    }
    if (tid < n) {
      float color[3];
      shade_post_color(in, k, first_bounce, blocked_mode, t_min, t_max, color);
      for (int c = 0; c < 3; ++c) out[c * plane + idx] = color[c];
    }
    return;
  }

  float* ls = reinterpret_cast<float*>(smem + 16);
  float* s = reinterpret_cast<float*>(smem + POST_HEAD);
  if constexpr (POST_STAGE == 0) {
    const uint32_t bar = smem_u32(smem);
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(1)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid < 32) {
      const uint32_t bytes = (uint32_t)n * 4u;
      if (tid == 0)
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
            "r"(planes * bytes + (uint32_t)kl * 16u)
            : "memory");
      __syncwarp();
      for (int p = tid; p < planes; p += 32)
        bulk_copy(smem_u32(s + p * POST_RAYS),
                  plane_src(p, per_light, plane, rows, payload, t_in, active, sh_t, sh_id, caps) + ray0,
                  bytes, bar);
      if (tid == 31 && kl > 0) bulk_copy(smem_u32(ls), lights, (uint32_t)kl * 16u, bar);
    }
    if constexpr (POST_FLAG_FIRST == 0) live = live_sg[sg] != 0;
    bar_wait(bar, 0);
  } else {
    // Every thread: 16-byte loads of the block's planes, all issued
    // before the first store to shared memory.  Warp w takes plane
    // w + 4 q (POST_RAYS / 32 warps), lane l its quad l, l + 32, ...
    constexpr int WARPS = POST_RAYS / 32;
    constexpr int QUADS = POST_RAYS / 4;  // of a plane
    constexpr int LOADS = (MAX_PLANES + WARPS - 1) / WARPS * ((QUADS + 31) / 32);
    float4 v[LOADS];
    const int warp = tid / 32, lane = tid % 32;
#pragma unroll
    for (int q = 0; q < LOADS; ++q) {
      const int p = warp + WARPS * (q / ((QUADS + 31) / 32));
      const int w = lane + 32 * (q % ((QUADS + 31) / 32));
      if (p < planes && 4 * w < n) {
        const float* src = plane_src(p, per_light, plane, rows, payload, t_in, active, sh_t, sh_id, caps);
        v[q] = *reinterpret_cast<const float4*>(src + ray0 + 4 * w);
      }
    }
    if (tid < 4 * kl) ls[tid] = lights[tid];
    if constexpr (POST_FLAG_FIRST == 0) live = live_sg[sg] != 0;
#pragma unroll
    for (int q = 0; q < LOADS; ++q) {
      const int p = warp + WARPS * (q / ((QUADS + 31) / 32));
      const int w = lane + 32 * (q % ((QUADS + 31) / 32));
      if (p < planes && 4 * w < n) reinterpret_cast<float4*>(s + p * POST_RAYS)[w] = v[q];
    }
    __syncthreads();
  }
  if (!live) {
    zero_rays(out, plane, ray0, n);
    return;
  }
  if (tid < n) {
    const PostStaged in{s, ls, tid, per_light, sh_t, sh_id, caps, lights, plane, idx};
    float color[3];
    shade_post_color(in, k, first_bounce, blocked_mode, t_min, t_max, color);
    for (int c = 0; c < 3; ++c) out[c * plane + idx] = color[c];
  }
}

RT_EXPORT int rt_shade_post(const float* rows, const float* payload,
                            const float* t_in, const float* active,
                            const float* sh_t, const float* sh_id,
                            const float* caps, const int* live_sg,
                            const float* lights, int k, int n_tiles, int r,
                            int first_bounce, int blocked_mode, float t_min,
                            float t_max, float* out, long long* /*trace*/,
                            int /*counter*/, cudaStream_t stream) {
  // The variants count nothing: the trace buffer is the shipped kernel's.
  const long per_sg = (SUBGROUP_TILES * (long)r + POST_RAYS - 1) / POST_RAYS;
  const long blocks = (long)(n_tiles / SUBGROUP_TILES) * per_sg;
  if (blocks > 0) {
    if (POST_STAGE == 3) {
      (blocked_mode ? launch_regs_k<1> : launch_regs_k<0>)(
          (unsigned)blocks, stream, rows, payload, t_in, active, sh_t, sh_id, caps,
          live_sg, lights, k, n_tiles, r, first_bounce, t_min, t_max, out);
      return (int)cudaGetLastError();
    }
    const size_t smem = POST_STAGE == 1 ? 0
        : POST_HEAD + (size_t)post_planes(k, blocked_mode) * POST_RAYS * sizeof(float);
    shade_post_kernel<<<(unsigned)blocks, POST_RAYS, smem, stream>>>(
        rows, payload, t_in, active, sh_t, sh_id, caps, live_sg, lights, k,
        n_tiles, r, first_bounce, blocked_mode, t_min, t_max, out);
  }
  return (int)cudaGetLastError();
}
