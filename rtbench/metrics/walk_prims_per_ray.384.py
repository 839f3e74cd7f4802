"""``walk_prims_per_ray.384``: ``walk_prims_per_ray`` read in the 384x288 chained cell, whose frames
are timed by ``frame_ms.384`` (the same reader; a metric of its own
because it moves another end-to-end metric)."""

from rtbench import spec

read = spec.metric_reader("walk_prims_per_ray").read
