"""``accel_bytes``: the device bytes of every tensor reachable from an
object, each storage counted once.

A generic walk over dataclasses, named tuples, tuples, lists, sets,
dicts and objects' attributes (``__dict__`` and ``__slots__``), so a
renamed or added field of the program's structure does not hide a
tensor.  Views that share a storage count its bytes once.
"""

from __future__ import annotations

import types

import torch

_LEAVES = (str, bytes, bytearray, int, float, complex, bool, type(None), torch.device, torch.dtype)
_SKIP = (type, types.ModuleType, types.FunctionType, types.BuiltinFunctionType, types.MethodType)


def _children(x):
    if isinstance(x, dict):
        return [*x.keys(), *x.values()]
    if isinstance(x, (list, tuple, set, frozenset)):
        return list(x)
    out = list(getattr(x, "__dict__", {}).values())
    for cls in type(x).__mro__:
        for slot in getattr(cls, "__slots__", ()):
            if isinstance(slot, str) and hasattr(x, slot):
                out.append(getattr(x, slot))
    return out


def tensor_bytes(root, device: torch.device | str | None = None) -> int:
    """Bytes of the distinct storages of the tensors reachable from
    ``root`` (on ``device`` only, if given)."""
    device = None if device is None else torch.device(device)
    storages: dict[tuple[str, int], int] = {}
    seen: set[int] = set()
    stack = [root]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if device is not None and x.device.type != device.type:
                continue
            st = x.untyped_storage()
            key = (str(x.device), st.data_ptr())
            storages[key] = max(storages.get(key, 0), st.nbytes())
            continue
        if isinstance(x, _LEAVES) or isinstance(x, _SKIP) or id(x) in seen:
            continue
        seen.add(id(x))
        stack.extend(_children(x))
    return sum(storages.values())
