"""Spans at the port's layer boundaries: a render's set-up, window loop,
image assembly and check (`integrator/regen.render_regen`), and a train
step's inputs, launch and loss read (`parallel/mesh.make_train_step`).

`span(name, **counts)` is a context manager that records, on leaving, the
span's name, its id, its parent's and its root's ids (the root is the
outermost open span of the thread: one render or one train step), its
start and end on `time.perf_counter_ns` and its `counts`, a dict the body
may add to (`add` adds to the innermost open span's). Where a `with`
block does not fit, `start()` and `end()` open and close a span; a span
that an exception left open ends, unrecorded, with the span around it.
Records are kept in memory, the newest `MAX_RECORDS`; `records()`
returns them, oldest first. `CLOCK_OFFSET_NS` moves a record's times
onto the epoch clock of `torch.profiler`'s events.

While a profiler runs, a span is also a range of its name in the
profiler's trace, beside the device's kernels, on the host thread that
ran it. The range is `torch._C._profiler._RecordFunctionFast`'s (a host
op), not `torch.profiler.record_function`'s: the profiler copies a
`record_function` range onto the device's timeline
(`gpu_user_annotation`), where a trace reader takes it for device work.
With no profiler running a span costs two clock reads and an append.
"""

from __future__ import annotations

import collections
import functools
import itertools
import threading
import time

import torch
from torch.autograd import _profiler_enabled

MAX_RECORDS = 1 << 16
CLOCK_OFFSET_NS = time.time_ns() - time.perf_counter_ns()

_records = collections.deque(maxlen=MAX_RECORDS)
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class span:
    """A span of work; a record once it has ended (see the module)."""

    __slots__ = ("name", "counts", "id", "parent", "root", "t0", "t1", "_rf")

    def __init__(self, name: str, **counts):
        self.name, self.counts = name, counts
        self.t0 = self.t1 = None

    def __enter__(self) -> "span":
        stack = _stack()
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = up.id if up else None
        self.root = up.root if up else self.id
        stack.append(self)
        self._rf = None
        if _profiler_enabled():
            self._rf = torch._C._profiler._RecordFunctionFast(self.name)
            self._rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        # spans an exception left open inside this one end unrecorded
        stack = _stack()
        while True:
            top = stack.pop()
            if top._rf is not None:
                top._rf.__exit__(*exc)
                top._rf = None
            if top is self:
                break
        _records.append(self)
        return False

    start = __enter__

    def end(self):
        self.__exit__(None, None, None)

    @property
    def ns(self) -> int:
        return self.t1 - self.t0


def traced(name: str):
    """Decorator: each call of the function is a span named `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def add(key: str, n=1):
    """Add n to `counts[key]` of this thread's innermost open span, if
    one is open."""
    stack = _stack()
    if stack:
        c = stack[-1].counts
        c[key] = c.get(key, 0) + n


def records() -> list:
    """The kept records, oldest first (a span is recorded when it ends,
    so a parent after its children)."""
    return list(_records)


def self_ns(rec, recs) -> int:
    """`rec`'s duration less the part of it its child spans in `recs`
    cover (children of one span do not overlap)."""
    return rec.ns - sum(r.ns for r in recs if r.parent == rec.id)


def trees(name: str, t0_ns=None, t1_ns=None, recs=None) -> list:
    """[(root, [the root's other records])] of the kept roots named `name`
    that started at or after t0_ns and ended by t1_ns (None: no limit),
    oldest first."""
    recs = records() if recs is None else recs
    by_root = collections.defaultdict(list)
    for r in recs:
        if r.id != r.root:
            by_root[r.root].append(r)
    return [(r, by_root[r.id]) for r in recs
            if r.id == r.root and r.name == name
            and (t0_ns is None or r.t0 >= t0_ns)
            and (t1_ns is None or r.t1 <= t1_ns)]
