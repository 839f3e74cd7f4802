"""Acceleration-backend registry.

Counterpart of ``rt_rs_tpu/handlers/__init__.py``.  Ported: ``bvh``
(the default: the threaded walk over a 48 B/node tree, or the packet
kernels over its leaf order), ``rf_bvh`` (the same walk over 16-byte
records), ``pbvh`` (the packet kernels of the frame paths), ``naive``
(brute force, the cross-check) and ``blank`` (every ray misses, the
overhead baseline).
A handler of the JAX package that is not ported yet raises
``NotImplementedError`` naming the ROADMAP item that ports it; any other
name raises ``ValueError``, as in the JAX package.
"""

from __future__ import annotations

from typing import Any

from rt_rs_tpu_torch.handlers.base import IntrsHandler, IntrsStats
from rt_rs_tpu_torch.handlers.blank import BlankIntrs
from rt_rs_tpu_torch.handlers.bvh import BvhIntrs
from rt_rs_tpu_torch.handlers.naive import BasicIntrs
from rt_rs_tpu_torch.handlers.pbvh import PacketBvhIntrs
from rt_rs_tpu_torch.handlers.rf import RfBvhIntrs

_REGISTRY = {
    "blank": BlankIntrs,
    "bvh": BvhIntrs,
    "naive": BasicIntrs,
    "pbvh": PacketBvhIntrs,
    "rf_bvh": RfBvhIntrs,
}
# The JAX package's other handlers -> the ROADMAP §1 item that ports them.
_NOT_PORTED = {"lbvh": 6}


def get_handler(name: str, **kwargs: Any) -> IntrsHandler:
    factory = _REGISTRY.get(name)
    if factory is None:
        if name in _NOT_PORTED:
            raise NotImplementedError(
                f"handler {name!r} is not ported to rt_rs_tpu_torch yet (ROADMAP "
                f"§1 item {_NOT_PORTED[name]}); available: {available()}"
            )
        raise ValueError(f"unknown handler {name!r}; available: {available()}")
    return factory(**kwargs)


def available() -> list[str]:
    return sorted(_REGISTRY)


__all__ = ["IntrsHandler", "IntrsStats", "get_handler", "available"]
