"""CLI tools (counterparts of ``rt_rs_tpu/tools``), mirroring the
reference binaries (Cargo.toml:18-35): ``construct`` (scene authoring),
``precompute`` (ahead-of-time BVH), ``load`` (full-featured runner),
``demo`` (minimal run), and ``debug_tree`` (tree dumps and checks).
Each runs as ``python -m rt_rs_tpu_torch.tools.<name>``."""
