"""``cull_entries_m.384``: ``cull_entries_m`` read in the 384x288 chained cell, whose frames
are timed by ``frame_ms.384`` (the same reader; a metric of its own
because it moves another end-to-end metric)."""

from rtbench import spec

read = spec.metric_reader("cull_entries_m").read
