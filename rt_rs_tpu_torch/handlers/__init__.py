"""Acceleration-backend registry.

Counterpart of ``rt_rs_tpu/handlers/__init__.py``.  Ported: ``pbvh``
(the packet kernels of the frame paths), ``naive`` (brute force, the
cross-check) and ``blank`` (every ray misses, the overhead baseline);
asking for any other handler raises a ``KeyError`` that lists what is
available.
"""

from __future__ import annotations

from typing import Any

from rt_rs_tpu_torch.handlers.base import IntrsHandler, IntrsStats
from rt_rs_tpu_torch.handlers.blank import BlankIntrs
from rt_rs_tpu_torch.handlers.naive import BasicIntrs
from rt_rs_tpu_torch.handlers.pbvh import PacketBvhIntrs

_REGISTRY = {"blank": BlankIntrs, "naive": BasicIntrs, "pbvh": PacketBvhIntrs}


def get_handler(name: str, **kwargs: Any) -> IntrsHandler:
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"handler {name!r} is not ported to rt_rs_tpu_torch; "
            f"available: {available()}"
        ) from None
    return factory(**kwargs)


def available() -> list[str]:
    return sorted(_REGISTRY)


__all__ = ["IntrsHandler", "IntrsStats", "get_handler", "available"]
