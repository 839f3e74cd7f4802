"""The JAX package's kernel probes (``experiments/``), ported.

Each probe keeps the entry points of its JAX counterpart and runs a
hand-written CUDA kernel for CUDA tensors, its plain-PyTorch twin for CPU
tensors:

* :mod:`~rt_rs_tpu_torch.experiments.roofline` — the f32 peak probe
  (``practical_peak``): register-resident FMA chains, fused and separate;
* :mod:`~rt_rs_tpu_torch.experiments.tpose_table` — the closest hit on a
  transposed ``[Nc, 16, tc]`` chunk table (``packet_closest_hit_t``);
* :mod:`~rt_rs_tpu_torch.experiments.mxu_mt` — Möller–Trumbore as one
  matrix product per (ray tile, chunk) (``packet_closest_hit_mxu``), on
  the CUDA cores or the tensor cores (TF32).

The two closest-hit probes take the flat intersect contract of
:func:`rt_rs_tpu_torch.ops.shade.trace`, so a frame can be rendered
through them with :func:`rt_rs_tpu_torch.ops.shade.render`.
"""
