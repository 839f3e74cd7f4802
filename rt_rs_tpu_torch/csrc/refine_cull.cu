// Kernel A: the per-ray refine cull.
//
// Replaces rt_rs_tpu/ops/pallas/packet_trace.py::_refine_kernel (called
// through _perray_overlap_kernel_call).  For every (ray tile, chunk)
// pair: does ANY valid ray of the tile pass the slab test against the
// chunk's wobble-widened AABB inside its own [t_min, min(cap, t_max)]
// window?  Inverse directions are 1/d clamped to +-1e30 (NaN kept).
// Output [T, Nc] bool; tiles with no valid ray write false.  Pad chunks
// (inverted bounds) are removed by the wrapper, as in the reference.
//
// What bounds it on this card: instruction issue: ~12 f32 ops per (ray,
// chunk) pair on registers, plus the min / max and the comparisons (the
// twin's NaN-propagating min / max, written with compares and selects,
// cost three instructions each; here they are Hopper's one-instruction
// min.NaN / max.NaN, which propagate NaN alike).  The inputs
// are 8 floats per ray and 6 per chunk, so memory traffic is negligible
// (bounds sit in shared memory, read by all threads as broadcasts).
// The TPU kernel ORs over rays with a ones-vector matmul; the first
// port gave one block a whole tile (one thread per ray) and ORed with a
// block-wide __syncthreads_or per chunk, 128 barriers per live tile
// around ~12 ops of work each, and one block per tile left the SMs
// uneven (a call's live tiles are a few per SM).  Here one block owns
// one tile and one stripe of 32 chunks, and nothing is voted per chunk:
// each thread keeps its own ray's verdicts in a register word, bit c for
// chunk c of the stripe, and ORs the word into the block's shared word
// (atomicOr) at the stripe's end; a warp with no valid ray skips the
// loop, and one barrier precedes the write of the stripe's 32 bools.  A
// per-chunk warp vote (__any_sync) measured 6-15% slower (PERF.md).
// Dead tiles exit after one block vote, which is where secondary
// bounces spend most tiles.
#include "common.cuh"

// torch.minimum / torch.maximum in one instruction each (PTX min.NaN /
// max.NaN, sm_80 and later): a NaN operand gives NaN.  -0.0 and +0.0
// may come out either way, and compare alike.
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__global__ void refine_cull_kernel(const float* __restrict__ payload,
                                   const bool* __restrict__ valid,
                                   const float* __restrict__ capm,
                                   const float* __restrict__ bounds,
                                   bool* __restrict__ out, int n_tiles,
                                   int r, int nc, float t_min) {
  __shared__ float sb[32 * 6];  // the stripe's chunks: lo xyz, hi xyz
  __shared__ unsigned stripe_word;
  const int n_stripes = (nc + 31) / 32;
  const int tile = blockIdx.x / n_stripes;
  const int c0 = (blockIdx.x % n_stripes) * 32;
  const int n = min(32, nc - c0);
  const int lane = threadIdx.x;
  const long plane = (long)n_tiles * r;
  const long idx = (long)tile * r + lane;
  bool* row = out + (long)tile * nc + c0;

  const bool vld = valid[idx];
  if (!__syncthreads_or(vld)) {
    if (lane < n) row[lane] = false;
    return;
  }
  for (int i = lane; i < n * 6; i += blockDim.x) sb[i] = bounds[c0 * 6 + i];
  if (lane == 0) stripe_word = 0u;

  float o[3], iv[3];
  for (int ax = 0; ax < 3; ++ax) {
    o[ax] = payload[ax * plane + idx];
    const float inv = 1.0f / payload[(3 + ax) * plane + idx];
    iv[ax] = (inv != inv) ? inv : fminf(fmaxf(inv, -1e30f), 1e30f);
  }
  const float cap = capm[idx];
  __syncthreads();

  if (__any_sync(0xffffffffu, vld)) {
    unsigned word = 0u;  // bit c: this ray passes chunk c0 + c
    for (int c = 0; c < n; ++c) {
      float near = -INFINITY, far = INFINITY;
      for (int ax = 0; ax < 3; ++ax) {
        const float q0 = (sb[c * 6 + ax] - o[ax]) * iv[ax];
        const float q1 = (sb[c * 6 + 3 + ax] - o[ax]) * iv[ax];
        near = max_nan(near, min_nan(q0, q1));
        far = min_nan(far, max_nan(q0, q1));
      }
      const bool ok = vld && (near <= far) && (far >= t_min) && (near <= cap);
      word |= (unsigned)ok << c;
    }
    if (word) atomicOr(&stripe_word, word);
  }
  __syncthreads();
  if (lane < n) row[lane] = (stripe_word >> lane) & 1u;
}

RT_EXPORT int rt_refine_cull(const float* payload, const bool* valid,
                             const float* capm, const float* bounds,
                             bool* out, int n_tiles, int r, int nc,
                             float t_min, cudaStream_t stream) {
  if (n_tiles > 0 && nc > 0) {
    const long blocks = (long)n_tiles * ((nc + 31) / 32);
    refine_cull_kernel<<<(unsigned)blocks, r, 0, stream>>>(
        payload, valid, capm, bounds, out, n_tiles, r, nc, t_min);
  }
  return (int)cudaGetLastError();
}
