"""The port's tracing (``rt_rs_tpu_torch.tracing``): its counters equal
counts made independently on the same frames, its spans nest as the
renderer's steps do, and nothing it does changes a frame.

On the CPU the wrappers count what the kernels count on the card.  The
card's own check (marked ``card``; this file imports no JAX, so it runs
there without the tests' conftest):

    python3 -m pytest tests/test_torch_tracing.py -m card --noconftest -q
"""

from __future__ import annotations

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rt_rs_tpu_torch import Renderer, tracing
from rt_rs_tpu_torch.bvh import wide
from rt_rs_tpu_torch.ops import bvh_walk, cuda, shade_tile
from rt_rs_tpu_torch.ops import packet_trace as pt
from rt_rs_tpu_torch.scene.presets import torus_scene

SIZE = (16, 12)
CPU_ACTS = [ProfilerActivity.CPU]


def renderer(handler="bvh", device="cpu", size=SIZE, **kw):
    return Renderer(torus_scene(), size=size, device=device, handler=handler, **kw)


@pytest.fixture(autouse=True)
def outside_a_session():
    """A check outside any profiler session before each test, as a
    frame rendered between two sessions makes: the next session then
    starts from zero."""
    tracing.begin("cpu", 0)


def spans(prof) -> list[tuple[str, float, float]]:
    """The ``rt.`` spans of a profile: (name, start, end) in order."""
    out = [
        (e.name, e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.name.startswith("rt.")
    ]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def parents(found) -> dict[str, set]:
    """Each span name -> the names of the innermost spans around it
    (None at the top)."""
    out = collections.defaultdict(set)
    stack = []
    for name, a, b in found:
        while stack and stack[-1][2] < a:
            stack.pop()
        out[name].add(stack[-1][0] if stack else None)
        stack.append((name, a, b))
    return dict(out)


def test_counters_and_modes_match_the_kernels():
    assert tracing.MODES == pt.MT_MODES
    assert tracing.WORDS == 1 + tracing.SUB * len(tracing.COUNTERS)
    # kernels D and F add slots.b right after live_rays.b; kernel G its
    # five counters in a row from walk_rays
    for b in range(tracing.BOUNCES):
        assert tracing.INDEX[f"slots.{b}"] == tracing.INDEX[f"live_rays.{b}"] + 1
    walk = ("walk_nodes", "walk_prims", "walk_anyhit", "walk_blocked")
    assert [tracing.INDEX[n] - tracing.INDEX["walk_rays"] for n in walk] == [1, 2, 3, 4]
    assert tracing.bounce_counter(11) == "live_rays.7"
    assert tracing.cull_counter("rows", True) == "cull_entries.rows.refine"
    assert tracing.cull_counter("anyhit", 0) == "cull_entries.anyhit.interval"


def test_without_a_profiler_nothing_counts():
    r = renderer()
    r.render_frame()  # the first check outside a session disarms
    before = tracing.snapshot()
    assert tracing.span("rt.dispatch") is tracing.span("rt.replay")
    with tracing.span("rt.frame"):
        pass
    r.animate(2, chain=2)
    r.animate(1)
    after = tracing.snapshot()
    assert not tracing.counting("cpu")
    assert int(tracing.buffer("cpu")[0]) == 0
    for key in ("live_rays", "slots", "cull_entries", "walk_rays", "walk_nodes", "walk_prims", "walk_anyhit", "frames"):
        assert after[key] == before[key], key


def test_spans_nest_as_the_renderer_steps():
    # the blank handler: the renderer's steps without the twins' many ops
    with profile(activities=CPU_ACTS) as prof:
        r = renderer("blank")
        r.animate(4, chain=2, sync_every=4, on_frame=lambda i, f, dt: None)
    found = spans(prof)
    names = collections.Counter(n for n, _, _ in found)
    assert names["rt.build"] == 1
    assert names["rt.dispatch"] == names["rt.prepare"] == names["rt.replay"] == names["rt.copy_out"] == 2
    assert names["rt.sync"] == names["rt.deliver"] == 1
    assert names["rt.orbit"] == 2
    up = parents(found)
    assert up["rt.prepare"] == up["rt.replay"] == {"rt.dispatch"}
    for top in ("rt.build", "rt.dispatch", "rt.copy_out", "rt.orbit", "rt.sync", "rt.deliver"):
        assert up[top] == {None}, top

    with profile(activities=CPU_ACTS) as prof:
        r.animate(3, sync_every=2, on_frame=lambda i, f, dt: None)
    found = spans(prof)
    names = collections.Counter(n for n, _, _ in found)
    assert names == {"rt.frame": 3, "rt.orbit": 3, "rt.sync": 2, "rt.deliver": 2}
    assert all(p == {None} for p in parents(found).values())


def record(monkeypatch, owner, name, log):
    """Wrap ``owner.name`` so that each call appends (args, kwargs) to
    ``log`` before it runs."""
    inner = getattr(owner, name)

    def wrapped(*args, **kwargs):
        log.append((args, kwargs))
        return inner(*args, **kwargs)

    monkeypatch.setattr(owner, name, wrapped)


def test_live_rays_equal_the_active_rays(monkeypatch):
    posts, bounces = [], []
    record(monkeypatch, shade_tile, "shade_post", posts)
    record(monkeypatch, shade_tile, "shade_bounce", bounces)
    r = renderer("pbvh", fuse_bounce=True)
    with profile(activities=CPU_ACTS):
        r.render_frame()
    snap = tracing.snapshot()
    live = [0] * tracing.BOUNCES
    slots = [0] * tracing.BOUNCES
    for args, kw in posts + bounces:
        active_f = args[4]  # after the table, pid, payload and t
        live[kw["bounce"]] += int(active_f.bool().sum())
        slots[kw["bounce"]] += active_f.numel()
    assert len(bounces) == r.config.compute.bounces - 1 and len(posts) == 1
    assert snap["live_rays"] == live and snap["slots"] == slots
    assert snap["frames"] == 1
    assert 0 < live[1] < live[0] < slots[0]


@pytest.mark.parametrize("force_rows", [None, False])
def test_cull_entries_equal_the_compacted_lists(monkeypatch, force_rows):
    calls, lists = [], []
    record(monkeypatch, pt, "packet_closest_hit_tiled", calls)
    inner = pt.compact

    def compact(overlap):
        ids, counts = inner(overlap)
        lists.append(int(counts.sum()))
        return ids, counts

    monkeypatch.setattr(pt, "compact", compact)
    r = renderer("pbvh", force_rows=force_rows)
    with profile(activities=CPU_ACTS):
        r.render_frame()
    snap = tracing.snapshot()
    want = collections.Counter()
    assert len(calls) == len(lists) > 0
    for (_, kw), kept in zip(calls, lists):
        mode = "anyhit" if kw.get("any_hit") else ("rows" if kw.get("emit_rows") else "closest")
        want[tracing.cull_counter(mode, kw.get("refine", False))] += kept
    got = {f"cull_entries.{k}": v for k, v in snap["cull_entries"].items() if v}
    assert got == dict(want)
    assert sum(lists) > 0


def test_walk_counts_equal_the_wide_walk(monkeypatch):
    calls = []
    record(monkeypatch, bvh_walk, "bvh_walk_tiled", calls)
    r = renderer("bvh")
    with profile(activities=CPU_ACTS):
        r.render_frame()
    snap = tracing.snapshot()
    rays = nodes = prims = anyhit = blocked = 0
    for (payload, valid, tree), kw in calls:
        packed = wide.pack_walk(*tree.binary, payload=tree.payload)
        work = bvh_walk.WideWork()
        out = bvh_walk.bvh_walk_tiled_wide_reference(payload, valid, packed, work=work, **kw)
        rays += int(valid.sum())
        nodes += work.node_visits
        prims += work.prim_tests
        if kw["mode"] == "anyhit":
            anyhit += int(valid.sum())
            blocked += int(out.sum())
    # primaries and the next bounces' rays, a shadow call a bounce
    bounces = r.config.compute.bounces
    assert [kw["mode"] for _, kw in calls] == ["closest"] + ["anyhit", "closest"] * (bounces - 1) + ["anyhit"]
    assert (snap["walk_rays"], snap["walk_nodes"], snap["walk_prims"]) == (rays, nodes, prims)
    assert (snap["walk_anyhit"], snap["walk_blocked"]) == (anyhit, blocked)
    assert nodes >= rays > 0 and prims > 0 and 0 < blocked < anyhit


def test_frames_count_what_was_rendered():
    r = renderer("blank")
    with profile(activities=CPU_ACTS):
        r.animate(5, chain=2, sync_every=4)  # three dispatches of 2
        r.animate(3)
        r.render_frame()
    assert tracing.snapshot()["frames"] == 6 + 3 + 1


def test_a_new_session_zeroes_and_the_next_check_disarms():
    r = renderer("pbvh")
    with profile(activities=CPU_ACTS):
        r.render_frame()
    first = tracing.snapshot()
    assert tracing.counting("cpu") and int(tracing.buffer("cpu")[0]) == 1
    r.render_frame()  # outside the session: the flag is cleared
    assert not tracing.counting("cpu") and int(tracing.buffer("cpu")[0]) == 0
    assert tracing.snapshot()["live_rays"] == first["live_rays"]
    with profile(activities=CPU_ACTS):
        r.animate(2, chain=2)
    second = tracing.snapshot()
    assert second["frames"] == 2
    assert second["live_rays"] == [2 * n for n in first["live_rays"]]


@pytest.mark.parametrize("handler", ["bvh", "pbvh"])
def test_frames_are_the_same_with_tracing_on(handler):
    r = renderer(handler)
    off = r.render_frame().clone()
    chain_off = r._run_chain(2, 5.0)[0].clone()
    with profile(activities=CPU_ACTS):
        on = r.render_frame().clone()
        chain_on = r._run_chain(2, 5.0)[0].clone()
    assert tracing.snapshot()["frames"] == 3
    assert torch.equal(on, off) and torch.equal(chain_on, chain_off)


def test_build_seconds_are_counted_always():
    before = tracing.snapshot()["build_s"]
    renderer("pbvh")
    assert tracing.snapshot()["build_s"] > before


def test_refit_counters_follow_each_other():
    """The wide refit adds ``refit_nodes`` right after ``refit_prims``."""
    assert tracing.INDEX["refit_nodes"] == tracing.INDEX["refit_prims"] + 1


def refit_case(device="cpu"):
    """A packed torus tree, its refit map and leaf-ordered corners."""
    from rt_rs_tpu_torch.bvh import build_bvh
    from rt_rs_tpu_torch.handlers.bvh import accel_from_bvh_data, reorder_scene_arrays

    scene = torus_scene()
    data = build_bvh(scene, eps=0.02, target_item_count=2)
    n = accel_from_bvh_data(data, scene, torch.device(device))
    a = reorder_scene_arrays(scene.pack(device=device), data.indices)
    tree = wide.pack_walk(
        n.node_min, n.node_max, n.hit_link, n.miss_link, n.leaf_count, n.leaf_start, a.pa, a.pb, a.pc,
        payload=False,
    )
    return tree, wide.refit_map(tree, rows=a.pa.shape[0]), a


def test_wide_refit_counts_what_it_writes():
    """Within a session, each call adds every packed prim to
    ``refit_prims`` and every used child slot to ``refit_nodes``;
    outside one, nothing."""
    from rt_rs_tpu_torch.ops import wide_refit

    tree, refit, a = refit_case()
    wide_refit.wide_refit(a.pa, a.pb, a.pc, tree, refit)
    with profile(activities=CPU_ACTS):
        tracing.begin("cpu", 1)
        for _ in range(3):
            wide_refit.wide_refit(a.pa, a.pb, a.pc, tree, refit)
    snap = tracing.snapshot()
    used = int((tree.nodes[:, 6 * wide.WIDTH : 7 * wide.WIDTH] != 0).sum())
    assert snap["refit_prims"] == 3 * tree.prims.shape[0] == 3 * torus_scene().num_prims
    assert snap["refit_nodes"] == 3 * used > 0


def test_rebuild_counters_follow_each_other():
    """The wide build adds ``rebuild_nodes`` right after ``rebuild_prims``."""
    assert tracing.INDEX["rebuild_nodes"] == tracing.INDEX["rebuild_prims"] + 1


def test_walked_rebuild_counts_its_build():
    """A walked-rebuild frame of ``DynamicRenderer`` under a profiler
    counts every prim record (P a frame) and every wide node the build
    writes, the twin's node count; outside a session, nothing."""
    from rt_rs_tpu_torch import DynamicRenderer
    from rt_rs_tpu_torch.ops import wide_build
    from rt_rs_tpu_torch.scene.presets import random_soup

    scene = random_soup(21, 150)
    r = DynamicRenderer(scene, size=SIZE, backend="threaded", device="cpu")
    r.render_frame()  # a check outside a session: the next one starts from zero
    with profile(activities=CPU_ACTS):
        for _ in range(2):
            r.render_frame()
    snap = tracing.snapshot()
    a = scene.pack(device="cpu")
    assert snap["frames"] == 2
    assert snap["rebuild_prims"] == 2 * scene.num_prims
    assert snap["rebuild_nodes"] == 2 * wide_build.wide_build_reference(a.pa, a.pb, a.pc).count > 0
    assert snap["walk_rays"] > 0
    tracing.begin("cpu", 0)  # outside the session: disarmed


@pytest.mark.parametrize("backend", ["packet", "threaded"])
def test_dynamic_renderer_times_its_build(backend):
    """``DynamicRenderer``'s set-up (the pack and the rest pose's order
    or tree) is one ``rt.build`` span, its seconds in ``build_s``."""
    from rt_rs_tpu_torch import DynamicRenderer

    before = tracing.snapshot()["build_s"]
    with profile(activities=CPU_ACTS) as prof:
        DynamicRenderer(torus_scene(), size=SIZE, refit=True, backend=backend, device="cpu")
    assert [n for n, _, _ in spans(prof)] == ["rt.build"]
    assert tracing.snapshot()["build_s"] > before


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("handler", ["bvh", "pbvh", "pbvh_fused", "pbvh_gather"])
def test_card_kernels_count_as_their_twins(handler, monkeypatch):
    """Every counting kernel call of a 96x72 torus frame, recorded, is
    replayed on the card with tracing on and against its twin's count on
    the same inputs, on the CPU."""
    dev = card()
    kw = {"pbvh_fused": dict(fuse_bounce=True), "pbvh_gather": dict(force_rows=False)}.get(handler, {})
    r = renderer(handler.split("_")[0], device=dev, size=(96, 72), **kw)
    logs = {}
    for owner, name in (
        (shade_tile, "shade_post"), (shade_tile, "shade_bounce"), (pt, "mt_trace"), (bvh_walk, "bvh_walk_tiled"),
    ):
        record(monkeypatch, owner, name, logs.setdefault(name, []))
    r.render_frame()
    monkeypatch.undo()
    fns = {"shade_post": shade_tile.shade_post, "shade_bounce": shade_tile.shade_bounce,
           "mt_trace": pt.mt_trace, "bvh_walk_tiled": bvh_walk.bvh_walk_tiled}
    assert any(logs.values())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        tracing.begin(dev, 0)
        tracing.begin("cpu", 0)
        for name, calls in logs.items():
            for args, kwargs in calls:
                fns[name](*args, **kwargs)
                fns[name](
                    *(_cpu_tree(a) for a in args), **{k: _cpu_tree(v) for k, v in kwargs.items()}
                )
                got, want = _by_device(dev), _by_device("cpu")
                assert got == want, (name, got, want)
    tracing.begin(dev, 0)  # outside the session: disarmed
    tracing.begin("cpu", 0)


@pytest.mark.card
def test_card_wide_refit_counts_as_its_twin():
    """The kernel's counts of one call equal the twin's on the CPU."""
    from rt_rs_tpu_torch.ops import wide_refit

    dev = card()
    tree, refit, a = refit_case(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        tracing.begin(dev, 0)
        tracing.begin("cpu", 0)
        wide_refit.wide_refit(a.pa, a.pb, a.pc, tree, refit)
        cpu_map = wide.RefitMap(
            refit.prim_meta.cpu(), refit.slot_word.cpu(), refit.slot_range.cpu(), refit.rows, refit.block_slots
        )
        cpu_tree = wide.WalkTree(binary=(), payload=False, nodes=tree.nodes.cpu(), prims=tree.prims.cpu())
        wide_refit.wide_refit(a.pa.cpu(), a.pb.cpu(), a.pc.cpu(), cpu_tree, cpu_map)
        got, want = _by_device(dev), _by_device("cpu")
        assert got == want == {"refit_prims": tree.prims.shape[0], "refit_nodes": refit.slot_word.shape[0]}
    tracing.begin(dev, 0)
    tracing.begin("cpu", 0)


def _cpu_tree(a):
    if torch.is_tensor(a):
        return a.cpu()
    if isinstance(a, wide.WalkTree):
        return wide.WalkTree(binary=tuple(x.cpu() for x in a.binary), payload=a.payload)
    return a


def _by_device(device) -> dict:
    buf = tracing.buffer(device).cpu()
    words = buf[1:].reshape(len(tracing.COUNTERS), tracing.SUB).sum(dim=1).tolist()
    return {n: v for n, v in zip(tracing.COUNTERS, words) if v}


@pytest.mark.card
def test_card_wide_build_counts_as_its_twin():
    """The build's kernels add P to ``rebuild_prims`` and the wide node
    count to ``rebuild_nodes``, as the twin counts, and nothing outside a
    session."""
    from rt_rs_tpu_torch.ops import wide_build

    dev = card()
    a = torus_scene().pack(device="cpu")
    p = a.pa.shape[0] - 1
    build = wide_build.workspace(p, dev)
    corners = [x.to(dev) for x in (a.pa, a.pb, a.pc)]
    got, want = {}, {}
    for d, args, out in (("cpu", (a.pa, a.pb, a.pc), want), (dev, (*corners, build), got)):
        wide_build.wide_build(*args)
        with profile(activities=CPU_ACTS):
            tracing.begin(d, 1)
            wide_build.wide_build(*args)
        snap = tracing.snapshot()
        out.update({k: snap[k] for k in ("rebuild_prims", "rebuild_nodes")})
        tracing.begin(d, 0)  # outside the session: disarmed
    assert got == want == {"rebuild_prims": p, "rebuild_nodes": int(build.work["count"][0])}


@pytest.mark.card
def test_card_chained_replays_with_the_flag_off_and_on():
    """One graph serves tracing off and on: the same frames bit for bit
    and the same launches, no capture inside the traced dispatches, and
    the counters count each replay's frames."""
    dev = card()
    r = renderer("pbvh", device=dev, size=(96, 72))
    captures = tracing.snapshot()["captures"]
    r._run_chain(4, 5.0)  # the capture, and its warm-up frame's launches
    assert tracing.snapshot()["captures"] == captures + 1
    runs = []
    for traced in (False, True, False):
        before = cuda.LAUNCHES.copy()
        captures = tracing.snapshot()["captures"]
        if traced:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                frames = r._run_chain(4, 5.0)[0].clone()
        else:
            frames = r._run_chain(4, 5.0)[0].clone()
        torch.cuda.synchronize()
        runs.append((frames, cuda.LAUNCHES - before, tracing.snapshot()["captures"] - captures))
    assert runs[0][2] == runs[1][2] == runs[2][2] == 0
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[1][0], runs[2][0])
    assert runs[0][1] == runs[1][1] == runs[2][1]
    snap = tracing.snapshot()
    assert snap["frames"] == 4 and snap["slots"][0] == 4 * 32 * 256  # 30 tiles padded to 32, four frames
    assert 0 < snap["live_rays"][1] <= snap["live_rays"][0] <= snap["slots"][0]


def test_load_profile_prints_the_snapshot(tmp_path, capsys):
    """``tools/load --profile`` (the operator's read path) prints the
    snapshot after the profiled run."""
    import json

    from rt_rs_tpu_torch.tools import load

    path = tmp_path / "torus.json"
    torus_scene().save(str(path))
    argv = ["--path", str(path), "--handler-pbvh", "--width", "16", "--height", "12", "--device", "cpu"]
    assert load.main([*argv, "--frames", "2", "--profile", str(tmp_path / "prof")]) == 0
    line = next(ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("tracing: "))
    snap = json.loads(line[len("tracing: "):])
    assert snap["frames"] == 2 and snap["build_s"] > 0.0
    assert 0 < snap["live_rays"][1] < snap["slots"][1]
    assert sum(snap["cull_entries"].values()) > 0
