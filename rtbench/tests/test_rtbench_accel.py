"""``accel_bytes``: the generic walk counts each storage once, finds
tensors in any field, and on a real renderer counts the port's whole
structure (chunk table and packed walk records besides the nodes)."""

import dataclasses

import torch

from rtbench import accel


@dataclasses.dataclass(frozen=True)
class Inner:
    a: torch.Tensor
    n: int = 3


class Slotted:
    __slots__ = ("x", "y")

    def __init__(self, x, y):
        self.x, self.y = x, y


def test_shared_storages_count_once():
    base = torch.zeros(100, dtype=torch.float32)  # 400 bytes
    view = base[10:20]
    other = torch.zeros(8, dtype=torch.int64)  # 64 bytes
    root = {"a": Inner(base), "b": [view, (view, other)], "c": Slotted(other, base.view(10, 10))}
    assert accel.tensor_bytes(root) == 400 + 64


def test_cycles_and_plain_values():
    t = torch.ones(4)
    cyc = {"t": t, "n": 1.5, "s": "x"}
    cyc["self"] = cyc
    assert accel.tensor_bytes([cyc, cyc]) == 16


def test_device_filter():
    assert accel.tensor_bytes({"t": torch.ones(4)}, "cuda") == 0
    assert accel.tensor_bytes({"t": torch.ones(4)}, "cpu") == 16


def test_renderer_accel_on_cpu():
    from rtbench import scenes, spec
    from rtbench.drive import make_renderer

    config = spec.config(spec.benchmark(), "teatime")
    r = make_renderer(scenes.build(config), config, 16, 12, "cpu")
    got = accel.tensor_bytes(r.accel, "cpu")
    nodes = sum(t.untyped_storage().nbytes() for t in vars(r.accel.nodes).values() if torch.is_tensor(t))
    assert got > nodes > 0  # the walk's records (the CPU takes the threaded walk) besides the nodes
    assert got == accel.tensor_bytes((r.accel.nodes, r.accel.walk, r.accel.chunks), "cpu")
