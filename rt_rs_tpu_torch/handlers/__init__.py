"""Acceleration-backend registry.

Counterpart of ``rt_rs_tpu/handlers/__init__.py``, with every handler
of the JAX package: ``bvh`` (the default: the threaded walk over a
48 B/node tree, or the packet kernels over its leaf order), ``rf_bvh``
(a walk of its own over the 16-byte records themselves), ``pbvh`` (the packet kernels of
the frame paths), ``lbvh`` (the packet kernels over a chunk table built
on the device), ``naive`` (brute force, the cross-check) and ``blank``
(every ray misses, the overhead baseline).  :func:`register` adds a
handler by name, or replaces one; an unknown name raises
``ValueError``, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable

from rt_rs_tpu_torch.handlers.base import IntrsHandler, IntrsStats
from rt_rs_tpu_torch.handlers.blank import BlankIntrs
from rt_rs_tpu_torch.handlers.bvh import BvhIntrs
from rt_rs_tpu_torch.handlers.lbvh import LbvhIntrs
from rt_rs_tpu_torch.handlers.naive import BasicIntrs
from rt_rs_tpu_torch.handlers.pbvh import PacketBvhIntrs
from rt_rs_tpu_torch.handlers.rf import RfBvhIntrs

_REGISTRY: dict[str, Callable[..., IntrsHandler]] = {}


def register(name: str, factory: Callable[..., IntrsHandler]) -> None:
    """Make ``get_handler(name, **kwargs)`` (and ``Renderer(handler=name)``)
    call ``factory(**kwargs)``; a later call replaces an earlier one."""
    _REGISTRY[name] = factory


def get_handler(name: str, **kwargs: Any) -> IntrsHandler:
    factory = _REGISTRY.get(name)
    if factory is None:
        raise ValueError(f"unknown handler {name!r}; available: {available()}")
    return factory(**kwargs)


def available() -> list[str]:
    return sorted(_REGISTRY)


for _name, _factory in (
    ("blank", BlankIntrs),
    ("naive", BasicIntrs),
    ("bvh", BvhIntrs),
    ("rf_bvh", RfBvhIntrs),
    ("pbvh", PacketBvhIntrs),
    ("lbvh", LbvhIntrs),
):
    register(_name, _factory)

__all__ = ["IntrsHandler", "IntrsStats", "get_handler", "register", "available"]
