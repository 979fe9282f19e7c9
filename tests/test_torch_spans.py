"""The port's spans (`go_raytracer_tpu_torch/utils/spans.py`): their
records (nesting, ids, counts, self time, the bound on what is kept), the
span tree of a `render_regen` call on a fused and a mesh scene and of a
train step, the drain watch's polling time, their events in a `torch.profiler` trace on the record's
clock, and that with no profiler running no span enters a profiler
range. CPU only, at small sizes."""

import collections
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from go_raytracer_tpu_torch.integrator import regen
from go_raytracer_tpu_torch.ops import _cuda
from go_raytracer_tpu_torch.ops import bounce as bounce_mod
from go_raytracer_tpu_torch.parallel import mesh as tmesh
from go_raytracer_tpu_torch.scenes import registry
from go_raytracer_tpu_torch.utils import spans

torch.set_num_threads(2)

RENDER_TREE = {"render": None, "render.setup": "render",
               "render.setup.scene": "render.setup",
               "render.windows": "render", "render.assemble": "render",
               "render.check": "render"}


def small(scene_fn, width=16, spp=4, depth=4):
    scene, cam = scene_fn()
    cam.width, cam.samples_per_pixel, cam.max_depth = width, spp, depth
    return scene, cam


def new_records(before: int) -> list:
    """The records made since `spans.records()` held `before` ids."""
    return [r for r in spans.records() if r.id > before]


def last_id() -> int:
    recs = spans.records()
    return max((r.id for r in recs), default=0)


def tree_of(recs) -> dict:
    """{name: [records]}, checking that each record lies inside its
    parent's."""
    by_id = {r.id: r for r in recs}
    out = collections.defaultdict(list)
    for r in recs:
        out[r.name].append(r)
        if r.parent is not None:
            assert by_id[r.parent].t0 <= r.t0 <= r.t1 <= by_id[r.parent].t1
    return out


def test_nesting_ids_counts_and_self_time():
    with spans.span("a", calls=0) as a:
        a.counts["calls"] += 3
        with spans.span("a.b") as b:
            spans.add("n")
            spans.add("n", 2)
            with spans.span("a.b.c"):
                pass
        with spans.span("a.d"):
            pass
    spans.add("nothing open")       # no span open: a no-op
    recs = spans.records()[-4:]
    c, b_rec, d, a_rec = recs
    assert [r.name for r in recs] == ["a.b.c", "a.b", "a.d", "a"]
    assert a_rec is a and b_rec is b
    assert a.parent is None and a.root == a.id
    assert b.parent == a.id and d.parent == a.id and c.parent == b.id
    assert {r.root for r in recs} == {a.id}
    assert a.counts == {"calls": 3} and b.counts == {"n": 3}
    assert all(r.t0 <= r.t1 for r in recs)
    assert a.t0 <= b.t0 <= c.t0 <= c.t1 <= b.t1 <= d.t0 <= d.t1 <= a.t1
    assert spans.self_ns(a, recs) == a.ns - b.ns - d.ns
    assert spans.self_ns(b, recs) == b.ns - c.ns
    assert spans.self_ns(c, recs) == c.ns
    [(root, rest)] = spans.trees("a", a.t0, a.t1)
    assert root is a and rest == [c, b, d]
    assert spans.trees("a", a.t0 + 1) == [] and spans.trees("a.b") == []


def test_records_keep_only_the_newest():
    first = last_id()
    for i in range(spans.MAX_RECORDS + 7):
        with spans.span("bulk", i=i):
            pass
    recs = spans.records()
    assert len(recs) == spans.MAX_RECORDS
    assert recs[0].counts["i"] == 7 and recs[-1].counts["i"] == \
        spans.MAX_RECORDS + 6
    assert recs[0].id == first + 8


def test_a_span_left_open_by_an_exception_ends_with_its_parent():
    before = last_id()
    with pytest.raises(ValueError):
        with spans.span("outer"):
            spans.span("outer.left").start()
            raise ValueError("stop")
    with spans.span("after") as after:
        pass
    assert [r.name for r in new_records(before)] == ["outer", "after"]
    assert after.parent is None and after.root == after.id


@pytest.mark.parametrize("scene", ["fused", "mesh"])
def test_render_regen_records_its_span_tree(scene, monkeypatch):
    """One render, one tree: the root `render` and the spans of
    RENDER_TREE once each, `render.sync` in `render.windows` once a read;
    `render.windows` counts the windows and the K1 calls (fused) or the
    levels run (mesh), and stats["elapsed_s"] is its duration."""
    calls = [0]
    k1 = bounce_mod.bounce_fused_q

    def counted(*a, **k):
        calls[0] += 1
        return k1(*a, **k)

    monkeypatch.setattr(bounce_mod, "bounce_fused_q", counted)
    if scene == "fused":
        # short windows, so that the render runs several
        sc, cam = small(registry.cornell_box)
        kw = dict(n_lanes=256, refill_len=8)
    else:
        sc, cam = small(registry.model_example, spp=1, depth=3)
        kw = dict(n_lanes=1024)
    before = last_id()
    _, st = regen.render_regen(sc, cam, seed=3, device="cpu", **kw)
    recs = new_records(before)
    names = tree_of(recs)
    [root] = names["render"]
    assert {r.root for r in recs} == {root.id}
    assert set(names) == set(RENDER_TREE) | {"render.sync"}
    by_id = {r.id: r for r in recs}
    for name, parent in RENDER_TREE.items():
        [r] = names[name]
        assert (by_id[r.parent].name if r.parent else None) == parent
    [win] = names["render.windows"]
    assert all(r.parent == win.id for r in names["render.sync"])
    assert 1 <= len(names["render.sync"]) <= win.counts["windows"]
    assert win.counts["windows"] == st["windows"] >= 1
    ran = calls[0] if scene == "fused" else st["levels_run"]
    assert win.counts["calls"] == st["calls"] == ran > 0
    # on the CPU the drain watch reads its rows directly: it never polls
    assert win.counts["wait_ns"] == 0
    if scene == "fused":
        assert st["windows"] > 1 and calls[0] > st["windows"]
    else:
        assert calls[0] == 0
    assert st["elapsed_s"] == win.ns / 1e9
    covered = sum(names[n][0].ns for n in (
        "render.setup", "render.windows", "render.assemble", "render.check"))
    assert covered <= root.ns


class _Event:
    """A device event that completes on its `n`-th query, 1 ms apart."""

    def __init__(self, n):
        self.n = n

    def query(self):
        self.n -= 1
        if self.n > 0:
            time.sleep(1e-3)
        return self.n <= 0


def test_drain_watch_sums_its_polls():
    """`DrainWatch.wait_ns` (`render.windows`' count `wait_ns` on the mesh
    path) holds the host's time polling a call `ahead` calls back, and
    nothing for a call that had completed."""
    watch = _cuda.DrainWatch(torch.zeros((3, 1), dtype=torch.int32),
                             ahead=1)
    watch.cuda, watch.host = True, torch.ones((3, 1), dtype=torch.int32)
    watch.pending = collections.deque([(0, _Event(5)), (1, _Event(1))])
    t0 = time.perf_counter_ns()
    assert not watch.drained()
    assert 2e6 <= watch.wait_ns <= time.perf_counter_ns() - t0
    assert not watch.pending
    waited = watch.wait_ns
    watch.pending.append((2, _Event(1)))
    assert not watch.drained() and watch.wait_ns == waited


def test_train_step_records_its_span_tree():
    sc, cam = small(registry.cornell_box, width=8, depth=3)
    step, params, _ = tmesh.make_train_step(sc, cam, n_rays=64,
                                            n_sample_batches=2, max_depth=3,
                                            device="cpu")
    ids = tmesh.pixel_ids(64, 2)
    target = torch.zeros((64, 3))
    before = last_id()
    losses = [step(params, ids, target) for _ in range(2)]
    recs = new_records(before)
    assert all(np.isfinite(losses))
    roots = [r for r in recs if r.name == "train.step"]
    assert len(roots) == 2
    for root in roots:
        kids = [r for r in recs if r.root == root.id and r is not root]
        assert [r.name for r in kids] == [
            "train.inputs", "train.launch", "train.loss_read"]
        assert all(r.parent == root.id for r in kids)
        tree_of(kids + [root])
        # the device split is the card's: no counts on the CPU
        assert root.counts == {}


def test_spans_appear_in_the_profiler_trace_on_its_clock():
    sc, cam = small(registry.cornell_box)
    before = last_id()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        regen.render_regen(sc, cam, seed=1, n_lanes=256, device="cpu")
    recs = new_records(before)
    events = collections.defaultdict(list)
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("render"):
            # a host op, never a user annotation, which the profiler
            # would copy onto the device's timeline
            assert not ev.is_user_annotation(), ev.name()
            events[ev.name()].append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    assert set(events) == {r.name for r in recs}
    assert sum(map(len, events.values())) == len(recs)
    matched = {}
    for r in recs:
        t0 = r.t0 + spans.CLOCK_OFFSET_NS
        ev = min(events[r.name], key=lambda e: abs(e[0] - t0))
        assert abs(ev[0] - t0) < 5e6, (r.name, ev[0] - t0)
        matched[r.id] = ev
    for r in recs:
        if r.parent is not None:
            (a, b), (pa, pb) = matched[r.id], matched[r.parent]
            assert pa <= a <= b <= pb, r.name


def test_no_profiler_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a profiler range {name!r} entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert not torch.autograd._profiler_enabled()
    sc, cam = small(registry.cornell_box, width=8)
    before = last_id()
    regen.render_regen(sc, cam, seed=2, n_lanes=256, device="cpu")
    assert len(new_records(before)) >= len(RENDER_TREE)
