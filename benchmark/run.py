"""The benchmark of go_raytracer_tpu_torch, driven by data.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

`BENCHMARK.json` (at the root of the checkout) names the cell's
configuration and traffic. Everything else is found by name:

- `benchmark/workloads/<cell>.json`: the traffic's driver
  (`benchmark/traffic/<driver>.py`) and its parameters;
- `benchmark/configs/<config>.json`: the scene, as data;
- `benchmark/metrics/<metric>.py`: each per-layer metric's reader;
- `benchmark/layers/*.json`: the kernel-name table of each layer.

A metric named `<quantity>.<cells>` is one quantity split by the cells
that report it (`device_idle.render`, `device_idle.train`), each part
with its own bound or end-to-end metric: without a reader of its own
name it is read by `metrics/<quantity>.py`, and an end-to-end metric is
the driver's `<quantity>`.

A run loads and warms up (set-up, `setup_s`), then, its driving thread
kept on one core, runs units (images or steps) back to back for
`--seconds`; a unit started before the close runs to its end. With `--trace 1` the first units of the window run
under `torch.profiler`, and the line carries the per-layer metrics.
Once the window has closed and the program's state is freed, the plain
reference (`benchmark/reference/`) decides `correct`. The last line of
standard output is one JSON object.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import threading
import time
from pathlib import Path

T_START = time.perf_counter()
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that may not be loaded in the process that
# prints the result: JAX, and the JAX package the port sits beside
FORBIDDEN = ("jax", "jaxlib", "flax", "go_raytracer_tpu")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of BENCHMARK.json with its files, found by name."""

    def __init__(self, name: str, bench_path: Path = ROOT / "BENCHMARK.json",
                 root: Path = HERE):
        bench = json.loads(bench_path.read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in {bench_path.name}")
        self.entry = cells[name]
        self.name = name
        self.workload = json.loads((root / "workloads" / f"{name}.json").read_text())
        if self.workload["config"] != self.entry["config"] or \
                self.workload["traffic"] != self.entry["traffic"]:
            raise ValueError(f"{name}: the workload file's config and traffic "
                             "are not BENCHMARK.json's")
        self.config = json.loads(
            (root / "configs" / f"{self.entry['config']}.json").read_text())
        self.driver_path = root / "traffic" / f"{self.workload['driver']}.py"
        applies = lambda m: name in m.get("workloads", [name])
        self.end_to_end = [m for m in bench["end_to_end"] if applies(m)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m)]
        self.readers = {m["name"]: reader_path(root / "metrics", m["name"])
                        for m in self.per_layer}


def quantity(name: str) -> str:
    """The quantity that a metric's name splits by cells."""
    return name.split(".")[0]


def reader_path(directory: Path, name: str) -> Path:
    own = directory / f"{name}.py"
    return own if own.exists() else directory / f"{quantity(name)}.py"


class Run:
    """What a driver and the metric readers see of one run."""

    def __init__(self, cell: Cell, seed: int, device: str):
        self.cell, self.seed, self.device = cell, seed, device
        self.workload, self.config = cell.workload, cell.config
        self.units, self.trace, self.traced_units = [], None, []


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(run: Run, peak: int) -> dict:
    import torch

    if run.device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": peak,
            "power_limit": power_limit()}


def power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def pin_main_thread():
    """Keep the thread that drives the window on one core of those the
    process may use (the last), and the process's other threads off it,
    so that a loop that the host paces is not moved between cores. Threads
    that this one starts later share its core. Returns the core."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) < 2:
        return None
    main, rest = cpus[-1], set(cpus[:-1])
    me = threading.get_native_id()
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), {main} if int(tid) == me else rest)
        except OSError:     # a thread that has ended meanwhile
            pass
    return main


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> dict:
    """One run of `cell`: set-up, the window, the reference's comparison.
    Returns the result object (without printing it)."""
    import torch

    from benchmark import devtrace

    torch.set_num_threads(4)
    run = Run(cell, seed, device)
    driver = load_module(cell.driver_path, "bench_driver").Driver(run)
    if device == "cuda":
        from go_raytracer_tpu_torch.ops import _cuda
        _cuda.build_all()
        print(f"set-up: kernels built or found at "
              f"{time.perf_counter() - T_START:.3f} s", file=sys.stderr)
    driver.setup()
    if device == "cuda":
        torch.cuda.synchronize()
    # what the benchmark spent making its own inputs with the reference
    # (a train cell's target) is not the program's set-up
    setup_s = time.perf_counter() - T_START - driver.inputs_s
    print(f"set-up {setup_s:.4f} s (the benchmark's inputs "
          f"{driver.inputs_s:.4f} s more)", file=sys.stderr)

    if device == "cuda":
        print(f"window: driven from cpu {pin_main_thread()}", file=sys.stderr)
    tracer = devtrace.Tracer() if trace else None
    n_traced = cell.workload.get("trace_units", 1)
    if tracer:
        tracer.start()
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        run.units.append(driver.unit(i))
        i += 1
        if tracer and i == n_traced:
            # the window's clock stands while the profiler hands over its
            # trace, so that the untraced images after it fill the window
            t_stop = time.perf_counter()
            tracer.stop()
            t0 += time.perf_counter() - t_stop
    if tracer and tracer.t1 is None:
        tracer.stop()
    window_s = run.units[-1]["end"] - run.units[0]["start"]
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    e2e = driver.end_to_end(run.units, window_s)
    e2e["setup_s"] = setup_s
    e2e.update({m["name"]: e2e[quantity(m["name"])] for m in cell.end_to_end
                if m["name"] not in e2e})
    for k, v in e2e.items():
        print(f"window: {k} = {v!r}", file=sys.stderr)
    print(f"window: {window_s:.6f} s, {len(run.units)} units", file=sys.stderr)
    spans = sorted(u["end"] - u["start"] for u in run.units)
    gaps = window_s - sum(spans)
    print(f"window: unit seconds min {spans[0]:.6f}, median "
          f"{spans[len(spans) // 2]:.6f}, max {spans[-1]:.6f}; "
          f"{gaps:.6f} s between units", file=sys.stderr)

    result = {"correct": False, "attempted": len(run.units),
              "failed": sum(bool(u["failed"]) for u in run.units)}
    unit_of = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        layers = devtrace.load_layers()
        run.trace = tracer.summary(layers)
        run.traced_units = run.units[:n_traced]
        devtrace.report(run.trace, layers)
        metrics = {}
        for m in cell.per_layer:
            value = load_module(cell.readers[m["name"]],
                                "bench_metric").read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": unit_of[m["name"]]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}

    driver.release()
    t_ref = time.perf_counter()
    numbers = driver.compare()
    print(f"reference: {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    limits = cell.workload["limits"]
    # a NaN reads as over its limit
    correct = result["failed"] == 0 and all(
        numbers[k] <= limits[k] for k in limits)
    # JSON has no infinity: a reading past every limit is written as text
    checks = {k: {"value": numbers[k] if math.isfinite(numbers[k])
                  else str(numbers[k]), "limit": limits[k]} for k in limits}
    result.update(correct=correct, metrics=metrics,
                  device=device_info(run, peak))
    if trace:
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
        result["device"].update(busy_s=run.trace.busy_s,
                                window_s=run.trace.window_s)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    import torch

    print(f"set-up: torch imported at {time.perf_counter() - T_START:.3f} s",
          file=sys.stderr)
    need = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"this benchmark runs on CUDA: {need} device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    print(f"set-up: {need} CUDA device(s) found at "
          f"{time.perf_counter() - T_START:.3f} s", file=sys.stderr)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
