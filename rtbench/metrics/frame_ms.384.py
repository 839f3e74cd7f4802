"""``frame_ms.384``: ``frame_ms`` in the 384x288 chained cell, bounded
apart from the 1080p cells (the same reader)."""

from rtbench import spec

read = spec.metric_reader("frame_ms").read
