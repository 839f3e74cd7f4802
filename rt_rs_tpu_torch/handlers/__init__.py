"""Acceleration-backend registry.

Counterpart of ``rt_rs_tpu/handlers/__init__.py``.  Only ``pbvh`` (the
packet kernels of the frame path) is ported; asking for any other
handler raises a ``KeyError`` that lists what is available.
"""

from __future__ import annotations

from typing import Any

from rt_rs_tpu_torch.handlers.base import IntrsHandler, IntrsStats
from rt_rs_tpu_torch.handlers.pbvh import PacketBvhIntrs

_REGISTRY = {"pbvh": PacketBvhIntrs}


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
