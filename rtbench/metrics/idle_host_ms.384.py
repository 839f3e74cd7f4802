"""``idle_host_ms.384``: ``idle_host_ms`` read in the 384x288 chained cell, whose frames
are timed by ``frame_ms.384`` (the same reader; a metric of its own
because it moves another end-to-end metric)."""

from rtbench import spec

read = spec.metric_reader("idle_host_ms").read
