"""The traced run's reading of the device: `torch.profiler` (CPU and CUDA)
over the first units of the window, reduced to the device's busy time,
each kernel's count and time, each layer's time through the kernel-name
tables of `benchmark/layers/` (in all, and of the kernels that a CUDA
graph's replay launched), the top device operations and the longest
idle gaps named by what the host was doing.
"""

from __future__ import annotations

import dataclasses
import json
import re
import sys
import time
from pathlib import Path

LAYERS = Path(__file__).resolve().parent / "layers"


def load_layers(directory: Path = LAYERS) -> dict:
    """{table id: (layer, compiled pattern)} of every kernel-name table."""
    out = {}
    for path in sorted(directory.glob("*.json")):
        spec = json.loads(path.read_text())
        out[path.stem] = (spec["layer"], re.compile("|".join(spec["kernels"])))
    return out


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    n_kernels: int
    kernels: dict          # name -> [count, seconds]
    layer_s: dict          # table id -> seconds
    layer_n: dict          # table id -> launches
    graph_layer_s: dict    # table id -> seconds launched by graph replays
    graph_kernels: dict    # name -> [count, seconds] of those launches
    unclaimed_s: float
    device_ops: list       # [[name, seconds]] top 10
    idle_gaps: list        # [[host activity, seconds]] top 10

    def kernel_count(self, pattern: str, graph: bool = False) -> int:
        """Launches of the kernels whose name matches; `graph`: only
        those that a CUDA graph's replay launched."""
        rx = re.compile(pattern)
        table = self.graph_kernels if graph else self.kernels
        return sum(c for name, (c, _) in table.items() if rx.search(name))


def _times(ev):
    try:
        return ev.start_ns(), ev.start_ns() + ev.duration_ns()
    except AttributeError:
        return ev.start_us() * 1000, (ev.start_us() + ev.duration_us()) * 1000


class Tracer:
    """Profiles from `start()` to `stop()`; `summary()` reduces the trace."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def summary(self, layers: dict) -> TraceSummary:
        from torch.autograd import DeviceType

        events = self.prof.profiler.kineto_results.events()
        # a kernel that a graph's replay launched carries the correlation
        # id of the cudaGraphLaunch call
        replays = {_corr(ev) for ev in events
                   if ev.device_type() != DeviceType.CUDA
                   and ev.name().startswith("cudaGraphLaunch")} - {None, 0}
        dev, host = [], []
        for ev in events:
            a, b = _times(ev)
            if ev.device_type() == DeviceType.CUDA:
                dev.append((a, b, ev.name(), _corr(ev) in replays))
            else:
                host.append((a, b, ev.name()))
        self.prof = None
        return reduce_events(dev, host, self.t1 - self.t0, layers)


def _corr(ev):
    try:
        return ev.correlation_id()
    except AttributeError:
        return None


def _is_kernel(name: str) -> bool:
    return not re.match(r"(Memcpy|Memset|memcpy|memset)", name)


def reduce_events(dev: list, host: list, window_s: float,
                  layers: dict) -> TraceSummary:
    """Reduce device events (start ns, end ns, name, launched by a graph's
    replay) and host events (start ns, end ns, name) to a summary; the
    busy time is the union of the device intervals."""
    dev.sort()
    busy, gaps, kernels, in_graph = 0, [], {}, {}
    cur_a = cur_b = None
    for a, b, name, graph in dev:
        for table in (kernels, in_graph) if graph else (kernels,):
            k = table.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += (b - a) / 1e9
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                gaps.append((a - cur_b, cur_b, a))
                busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
    layer_s = {k: 0.0 for k in layers}
    layer_n = {k: 0 for k in layers}
    graph_layer_s = {k: 0.0 for k in layers}
    unclaimed = 0.0
    for name, (c, s) in kernels.items():
        hit = False
        for lid, (_, rx) in layers.items():
            if rx.search(name):
                layer_s[lid] += s
                layer_n[lid] += c
                graph_layer_s[lid] += in_graph.get(name, (0, 0.0))[1]
                hit = True
        if not hit:
            unclaimed += s
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    named = [[host_activity(host, (a + b) / 2)[:160], length / 1e9]
             for length, a, b in sorted(gaps, reverse=True)[:10]]
    return TraceSummary(
        window_s=window_s, busy_s=busy / 1e9,
        n_kernels=sum(c for n, (c, _) in kernels.items() if _is_kernel(n)),
        kernels=kernels, layer_s=layer_s, layer_n=layer_n,
        graph_layer_s=graph_layer_s, graph_kernels=in_graph,
        unclaimed_s=unclaimed,
        device_ops=[[n[:160], s] for n, (_, s) in top], idle_gaps=named)


def host_activity(host: list, t: float) -> str:
    """What the host was doing at time t: the innermost host event that
    spans t, else the last one that ended before it."""
    inside = [(b - a, n) for a, b, n in host if a <= t <= b]
    if inside:
        return min(inside)[1]
    before = [(b, n) for a, b, n in host if b < t]
    return f"after {max(before)[1]}" if before else "no host event"


def report(summary: TraceSummary, layers: dict, out=sys.stderr):
    """Print each layer's device time, and the device time that no table
    claims (a kernel the port renamed shows here, not as a silent drop)."""
    total = sum(s for _, s in summary.kernels.values()) or 1.0
    for lid, (layer, _) in layers.items():
        print(f"trace: layer {lid} ({layer}): {summary.layer_s[lid]:.6f} s, "
              f"{summary.layer_n[lid]} launches, "
              f"{summary.graph_layer_s[lid]:.6f} s of them by graph replays",
              file=out)
    print(f"trace: device time no layer table claims: "
          f"{summary.unclaimed_s:.6f} s of {total:.6f} s "
          f"({100 * summary.unclaimed_s / total:.3f}%)", file=out)
    for name, (c, s) in sorted(summary.kernels.items(),
                               key=lambda kv: -kv[1][1]):
        if not any(rx.search(name) for _, rx in layers.values()):
            print(f"trace: unclaimed {s:.6f} s, {c} launches: {name[:160]}",
                  file=out)


def idle_percent(run):
    """The share of the traced window in which no device operation ran."""
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
