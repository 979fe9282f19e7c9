"""The readers of the program's spans (`benchmark/metrics/`:
`render_setup_ms`, `window_host_us`, `image_tail_ms`, `graph_launch_ms`,
`forward_ms`, `backward_ms`) on synthetic span records and units: each
keeps only the roots of the units after the traced ones, subtracts the
host's waits (spans and the drain watch's count) from the window loop, returns None below its minimum, on an
empty record list and where the program has no spans."""

import statistics
import sys
import types
from pathlib import Path

import pytest

from benchmark import run as R
from go_raytracer_tpu_torch.utils import spans

METRICS = Path(R.__file__).resolve().parent / "metrics"
MS = 1_000_000          # ns


def reader(name):
    return R.load_module(METRICS / f"{name}.py", f"reader_{name}")


class Records:
    """Synthetic records on a clock of its own, in ns."""

    def __init__(self):
        self.recs, self.next_id, self.t = [], 1, 10_000 * MS

    def add(self, name, t0, t1, parent=None, **counts):
        s = spans.span(name, **counts)
        s.id, s.t0, s.t1 = self.next_id, t0, t1
        s.parent = parent.id if parent else None
        s.root = parent.root if parent else s.id
        self.next_id += 1
        self.recs.append(s)
        return s

    def render(self, setup_ms, loop_ms, waits_ms, calls, tail_ms,
               polled_ms=0):
        """One render from now: set-up, the window loop with its waits
        (render.sync, render.capture) inside and `polled_ms` of the
        drain watch's polls in its count `wait_ns`, then the tail, split
        as assemble and check; returns (unit start, unit end) in s."""
        t = self.t
        root = self.add("render", t + MS // 10, 0)
        setup = self.add("render.setup", root.t0, root.t0 + setup_ms * MS,
                         root)
        self.add("render.setup.scene", setup.t0, setup.t0 + MS // 2, setup)
        win = self.add("render.windows", setup.t1, setup.t1 + loop_ms * MS,
                       root, windows=len(waits_ms), calls=calls,
                       wait_ns=int(polled_ms * MS))
        t = win.t0
        for name, w in waits_ms:
            self.add(name, t + MS, t + MS + int(w * MS), win)
            t += MS + int(w * MS)
        a = self.add("render.assemble", win.t1, win.t1 + tail_ms * MS // 2,
                     root)
        c = self.add("render.check", a.t1, a.t1 + tail_ms * MS // 2, root)
        root.t1 = c.t1
        unit = ((root.t0 - MS // 10) / 1e9, (root.t1 + MS // 10) / 1e9)
        self.t = root.t1 + MS
        return unit

    def step(self, launch_ms, **counts):
        t = self.t
        root = self.add("train.step", t + MS // 10, t + 30 * MS, **counts)
        self.add("train.inputs", root.t0, root.t0 + MS, root)
        self.add("train.launch", root.t0 + MS,
                 root.t0 + MS + int(launch_ms * MS), root)
        self.add("train.loss_read", root.t0 + 2 * MS + int(launch_ms * MS),
                 root.t1, root)
        self.t = root.t1 + MS
        return ((root.t0 - MS // 10) / 1e9, (root.t1 + MS // 10) / 1e9)


def run_of(units, traced, config):
    units = [{"start": a, "end": b} for a, b in units]
    return types.SimpleNamespace(units=units, traced_units=units[:traced],
                                 config=config)


def renders(n, traced, mesh=False):
    """A traced run of n renders, the first `traced` under the profiler,
    after a warm-up render that is no unit; render i has set-up 2 + i ms,
    a loop of 23 + 2 i ms with waits of 1 + i and (one render in three)
    3 ms, 10 + i calls and a tail of 4 + 2 i ms, and on a mesh scene
    polls of 0.5 + i ms in the loop's count; one render more after
    the window. Returns (the records, the run, the untraced renders'
    parameters)."""
    rs = Records()
    rs.render(99, 99, [], 1, 99)            # the warm-up: no unit
    units, params = [], []
    for i in range(n):
        waits = [("render.sync", 1 + i)] + \
            ([("render.capture", 3)] if i % 3 == 0 else [])
        p = (2 + i, 20 + 2 * i + 3, waits, 10 + i, 4 + 2 * i,
             0.5 + i if mesh else 0)
        units.append(rs.render(*p))
        if i >= traced:
            params.append(p)
    rs.render(99, 99, [], 1, 99)            # after the window's last unit
    config = {"mesh": {}} if mesh else {}
    return rs.recs, run_of(units, traced, config), params


@pytest.mark.parametrize("mesh", [False, True])
def test_render_readers_read_the_untraced_renders(mesh, monkeypatch):
    recs, run, params = renders(14 if mesh else 25, 3, mesh)
    monkeypatch.setattr(spans, "records", lambda: recs)
    assert reader("render_setup_ms").read(run) == pytest.approx(
        statistics.median(p[0] for p in params))
    loop_self = sum(p[1] - sum(w for _, w in p[2]) - p[5] for p in params)
    assert reader("window_host_us").read(run) == pytest.approx(
        1e3 * loop_self / sum(p[3] for p in params))
    assert reader("image_tail_ms").read(run) == pytest.approx(
        statistics.median(p[4] for p in params))


@pytest.mark.parametrize("name", ["render_setup_ms", "window_host_us",
                                  "image_tail_ms"])
@pytest.mark.parametrize("mesh, least", [(False, 20), (True, 10)])
def test_render_readers_need_their_least_count(name, mesh, least,
                                               monkeypatch):
    recs, run, _ = renders(2 + least - 1, 2, mesh)
    monkeypatch.setattr(spans, "records", lambda: recs)
    assert reader(name).read(run) is None
    recs, run, _ = renders(2 + least, 2, mesh)
    monkeypatch.setattr(spans, "records", lambda: recs)
    assert reader(name).read(run) is not None


def steps(n, traced, counts=True):
    rs = Records()
    rs.step(50)                             # set-up's steps: no unit
    units, launches = [], []
    for i in range(n):
        c = dict(forward_ms=10.0 + i, backward_ms=15.0 + 2 * i,
                 adam_ms=0.5) if counts else {}
        units.append(rs.step(0.5 + 0.1 * i, **c))
        if i >= traced:
            launches.append(i)
    rs.step(50, forward_ms=1.0, backward_ms=1.0)
    return rs.recs, run_of(units, traced, {}), launches


def test_train_readers_read_the_untraced_steps(monkeypatch):
    recs, run, kept = steps(30, 10)
    monkeypatch.setattr(spans, "records", lambda: recs)
    assert reader("graph_launch_ms").read(run) == pytest.approx(
        statistics.median(0.5 + 0.1 * i for i in kept), rel=1e-6)
    assert reader("forward_ms").read(run) == statistics.median(
        10.0 + i for i in kept)
    assert reader("backward_ms").read(run) == statistics.median(
        15.0 + 2 * i for i in kept)


def test_train_readers_need_20_steps_and_the_device_split(monkeypatch):
    recs, run, _ = steps(10 + 19, 10)
    monkeypatch.setattr(spans, "records", lambda: recs)
    for name in ("graph_launch_ms", "forward_ms", "backward_ms"):
        assert reader(name).read(run) is None
    # on a device without timing events the step has no split
    recs, run, _ = steps(30, 10, counts=False)
    monkeypatch.setattr(spans, "records", lambda: recs)
    assert reader("graph_launch_ms").read(run) is not None
    assert reader("forward_ms").read(run) is None
    assert reader("backward_ms").read(run) is None


NAMES = ["render_setup_ms", "window_host_us", "image_tail_ms",
         "graph_launch_ms", "forward_ms", "backward_ms"]


@pytest.mark.parametrize("name", NAMES)
def test_an_empty_record_list_reads_none(name, monkeypatch):
    _, run, _ = renders(25, 3)
    monkeypatch.setattr(spans, "records", lambda: [])
    assert reader(name).read(run) is None


@pytest.mark.parametrize("name", NAMES)
def test_a_program_without_spans_reads_none(name, monkeypatch):
    """The parent of the change that added the spans has no
    `utils/spans.py`: the reader returns None and does not raise."""
    import go_raytracer_tpu_torch.utils as utils

    source = steps if name in NAMES[3:] else renders
    recs, run, _ = source(30, 3)
    monkeypatch.setattr(spans, "records", lambda: recs)
    assert reader(name).read(run) is not None
    monkeypatch.delattr(utils, "spans")
    monkeypatch.setitem(sys.modules, "go_raytracer_tpu_torch.utils.spans",
                        None)
    assert reader(name).read(run) is None
