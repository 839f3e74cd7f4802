// Kernel F: shade_bounce, shade_post of bounce b fused with shade_pre
// of bounce b + 1.
//
// Replaces rt_rs_tpu/ops/pallas/shade_tile.py::_shade_bounce_kernel
// (its entry shade_bounce; the bodies _post_subgroup and
// _pre_subgroup).  The two halves share only the shade table: post
// reads bounce b's hits (and their table rows), rays and shadow
// verdicts, pre reads bounce b + 1's hits, their rows and rays; both
// become ready after the same intersect call.  One
// thread per ray runs shade_post_ray gated by live[0] of its 8-tile
// subgroup, then shade_pre_ray gated by live[1] (shade_body.cuh: the
// same code as kernels D and C, so the fused outputs are bit-equal to
// the two kernels').
//
// Layouts (plane = T * r):
//   table [P + 1, 32] (the scene's shade table, 16-byte aligned);
//   post: pid [T, r] i32, payload [8, T, r], t / active [T, r],
//         sh_t / sh_id / caps [k, T, r];
//   pre:  pid2 [T, r] i32, payload2 [8, T, r], t2 [T, r];
//   live [2, T / 8] i32, lights [k, 4]
//   -> color [3, T, r]; sh_pay [8, k * T, r], caps_out / masks
//      [k, T, r], next [8, T, r] (only when emit_next).
// While the trace buffer's flag is set (tracing.py), each block adds
// bounce b's rays with active set, in live subgroups, to counter
// (live_rays.b), and block 0 T * r to counter + 1 (slots.b).
//
// What bounds it on this card: memory, the union of the two kernels'
// operands and outputs (only the L2-resident table is shared); the
// fusion removes one launch per bounce pair, which matters where the
// frame is launch-bound (small frames).  Accesses are coalesced along
// the ray axis as in C and D.
#include "shade_body.cuh"

__global__ void shade_bounce_kernel(
    const float* __restrict__ table, const int* __restrict__ pid,
    const float* __restrict__ payload, const float* __restrict__ t_in,
    const float* __restrict__ active, const float* __restrict__ sh_t,
    const float* __restrict__ sh_id, const float* __restrict__ caps,
    const int* __restrict__ pid2, const float* __restrict__ payload2,
    const float* __restrict__ t2, const int* __restrict__ live,
    const float* __restrict__ lights, int k, int n_tiles, int r,
    int first_bounce, int blocked_mode, int emit_next, float t_min,
    float t_max, float* __restrict__ color, float* __restrict__ sh_pay,
    float* __restrict__ caps_out, float* __restrict__ masks,
    float* __restrict__ next, long long* __restrict__ trace, int counter) {
  const long plane = (long)n_tiles * r;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long sg = idx / r / 8;
  const long n_sg = n_tiles / 8;
  const bool mine = idx < plane;
  if (mine) {
    shade_post_ray(table, pid, payload, t_in, active, sh_t, sh_id, caps,
                   lights, k, plane, idx, live[sg] != 0, first_bounce,
                   blocked_mode, t_min, t_max, color);
    shade_pre_ray(table, pid2, payload2, t2, lights, k, plane, idx,
                  live[n_sg + sg] != 0, emit_next, sh_pay, caps_out, masks,
                  next);
  }
  if (trace_on(trace)) {  // bounce b's live_rays.b and slots.b
    const int shaded = __syncthreads_count(mine && live[sg] != 0 &&
                                           active[idx] > 0.0f);
    if (threadIdx.x == 0) {
      trace_add(trace, counter, shaded);
      if (blockIdx.x == 0) trace_add(trace, counter + 1, plane);
    }
  }
}

RT_EXPORT int rt_shade_bounce(
    const float* table, const int* pid, const float* payload,
    const float* t_in, const float* active, const float* sh_t,
    const float* sh_id, const float* caps, const int* pid2,
    const float* payload2, const float* t2, const int* live,
    const float* lights, int k, int n_tiles, int r, int first_bounce,
    int blocked_mode, int emit_next, float t_min, float t_max, float* color,
    float* sh_pay, float* caps_out, float* masks, float* next,
    long long* trace, int counter, cudaStream_t stream) {
  const long n = (long)n_tiles * r;
  if (n > 0) {
    const int threads = 256;
    const long blocks = (n + threads - 1) / threads;
    shade_bounce_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        table, pid, payload, t_in, active, sh_t, sh_id, caps, pid2, payload2,
        t2, live, lights, k, n_tiles, r, first_bounce, blocked_mode,
        emit_next, t_min, t_max, color, sh_pay, caps_out, masks, next, trace,
        counter);
  }
  return (int)cudaGetLastError();
}
