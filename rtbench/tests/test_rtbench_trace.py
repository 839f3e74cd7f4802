"""The kernel-name classifier against names recorded from a profile on
the card, and the trace's reduction to the per-layer metrics."""

import json
import pathlib

import pytest

from rtbench import spec
from rtbench.trace import NO_HOST_OP, Trace, base_name, matches

RECORDED = json.loads((pathlib.Path(__file__).parent / "recorded_kernel_names.json").read_text())["names"]
INTERSECT = spec.metric_reader("intersect_ms").PREFIXES
SHADE = spec.metric_reader("shade_ms").PREFIXES


def by_kind(name):
    if matches(name, INTERSECT):
        return "intersect"
    if matches(name, SHADE):
        return "shade"
    return "glue"


def test_recorded_names_sort_into_kinds():
    kinds = {}
    for n in RECORDED:
        kinds.setdefault(by_kind(n), set()).add(base_name(n))
    assert kinds["intersect"] == {
        "mt_trace_items_kernel", "mt_trace_prologue_kernel", "refine_cull_kernel", "bvh_walk_kernel",
    }
    assert kinds["shade"] == {"shade_pre_kernel", "shade_post_kernel"}
    assert {"elementwise_kernel", "vectorized_gather_kernel", "radixSortKVInPlace", "Memcpy DtoD"} <= kinds["glue"]


@pytest.mark.parametrize(
    "raw, base",
    [
        ("void (anonymous namespace)::mt_trace_items_kernel<2, false>(float const*, int)", "mt_trace_items_kernel"),
        ("(anonymous namespace)::bvh_walk_kernel(float const*, float const*)", "bvh_walk_kernel"),
        ("refine_cull_kernel(float const*, bool const*)", "refine_cull_kernel"),
        ("void shade_post_kernel<2, 1>(float const*)", "shade_post_kernel"),
        ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<at::native::X>(int)", "CatArrayBatchedCopy"),
        ("Memcpy DtoD (Device -> Device)", "Memcpy DtoD"),
        ("memcpy32_post", "memcpy32_post"),
    ],
)
def test_base_name(raw, base):
    assert base_name(raw) == base


def synthetic():
    """A window of 10 ms, 2 frames: kernels of each kind, an overlap, gaps."""
    device = [
        ("void (anonymous namespace)::mt_trace_items_kernel<2, false>(float const*)", 0.000, 0.003),
        ("refine_cull_kernel(float const*)", 0.0025, 0.004),  # overlaps the first
        ("void shade_post_kernel<2, 1>(float const*)", 0.005, 0.006),
        ("void at::native::vectorized_elementwise_kernel<4, X>(int)", 0.006, 0.007),
        ("Memcpy DtoD (Device -> Device)", 0.008, 0.0085),
    ]
    host = [
        ("aten::copy_", 0.0040, 0.0052),
        ("cudaStreamSynchronize", 0.0041, 0.0051),  # inside aten::copy_
        ("cudaLaunchKernel", 0.0072, 0.0079),
    ]
    return Trace(0.0, 0.010, 2, device, host)


def test_busy_and_gaps():
    t = synthetic()
    assert t.busy_intervals() == [(0.0, 0.004), (0.005, 0.007), (0.008, 0.0085)]
    assert t.busy_s() == pytest.approx(0.0065)
    assert t.idle_gaps() == [(0.004, 0.005), (0.007, 0.008), (0.0085, 0.010)]


def test_readers_on_a_synthetic_trace():
    t = synthetic()
    read = {m: spec.metric_reader(m).read(t) for m in ("intersect_ms", "shade_ms", "glue_ms", "device_idle.frame")}
    assert read["intersect_ms"] == pytest.approx((0.003 + 0.0015) * 1e3 / 2)
    assert read["shade_ms"] == pytest.approx(0.001 * 1e3 / 2)
    assert read["glue_ms"] == pytest.approx((0.001 + 0.0005) * 1e3 / 2)
    assert read["device_idle.frame"] == pytest.approx(0.35)


# the readers of the trace: those of the per-layer metrics
READERS = sorted(m["name"] for m in spec.benchmark()["per_layer"])


@pytest.mark.parametrize("name", READERS)
def test_readers_return_nothing_without_a_trace(name):
    empty = Trace(0.0, 1.0, 3, [], [])
    assert spec.metric_reader(name).read(empty) is None


@pytest.mark.parametrize("name", [n for n in READERS if n.endswith(".384")])
def test_a_cells_reader_reads_as_its_base(name):
    base = "device_idle.frame" if name.startswith("device_idle") else name[: -len(".384")]
    t = synthetic()
    assert spec.metric_reader(name).read(t) == spec.metric_reader(base).read(t)


def test_breakdown_labels_gaps_by_the_innermost_host_op():
    b = synthetic().breakdown()
    ops = dict(b["device_ops"])
    assert ops["mt_trace_items_kernel"] == pytest.approx(0.003)
    idle = dict(b["idle_gaps"])
    assert idle["cudaStreamSynchronize"] == pytest.approx(0.001)
    assert idle["cudaLaunchKernel"] == pytest.approx(0.001)
    assert idle[NO_HOST_OP] == pytest.approx(0.0015)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
