#!/usr/bin/env python3
"""What the port's spans (`go_raytracer_tpu_torch/utils/spans.py`) cost,
on one NVIDIA GPU, in a benchmark cell's own units (images or train
steps).

    python3 scripts/time_spans.py --cell cornellBox.final [--seed N]
                                  [--rounds R] [--out FILE]

- off: the host's ns a span with no profiler running (a root span, and a
  span inside one), and the records of one unit (the spans an image or a
  step makes); the ns a root span with the profiler running;
- on: the cell's traced units (its `trace_units`, under `torch.profiler`
  with CPU and CUDA activity, as `benchmark/devtrace.Tracer` runs them)
  timed with each span entering its profiler range, as the program does,
  and with the ranges cut by this script (it replaces the module's
  `_profiler_enabled` for the block), in turns on, off, off, on, R rounds;
  and the same number of units with no profiler;
- train cells: the host's us of the step's three `elapsed_time` reads,
  and the step's time with its timing events against a second train step
  of the same cell made with events that record nothing (in turns).

Prints one JSON line, also written to --out (default
chiprun_out/time_spans_<cell>.json). Without a GPU it exits non-zero.
"""

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def span_ns(spans, n=200_000):
    """ns a span, root and nested, with no profiler."""
    t = time.perf_counter_ns()
    for _ in range(n):
        with spans.span("x"):
            pass
    root = (time.perf_counter_ns() - t) / n
    with spans.span("outer"):
        t = time.perf_counter_ns()
        for _ in range(n):
            with spans.span("x"):
                pass
        nested = (time.perf_counter_ns() - t) / n
    return root, nested


def unit_ms(driver, first, k):
    """Run k units from unit index `first`; their ms."""
    out = []
    for i in range(first, first + k):
        u = driver.unit(i)
        out.append(1e3 * (u["end"] - u["start"]))
    return out


class NoEvent:
    """A timing event that records nothing."""

    def __init__(self, *a, **k):
        pass

    def record(self, *a, **k):
        pass

    def elapsed_time(self, other):
        return 0.0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, default=2654435761)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the spans' cost is measured on the card's "
              "host", file=sys.stderr)
        return 1
    from benchmark import devtrace, run as R
    from go_raytracer_tpu_torch.ops import _cuda
    from go_raytracer_tpu_torch.utils import spans

    _cuda.build_all()
    torch.set_num_threads(4)
    cell = R.Cell(args.cell)
    run = R.Run(cell, args.seed, "cuda")
    driver = R.load_module(cell.driver_path, "bench_driver").Driver(run)
    driver.setup()
    k = cell.workload.get("trace_units", 1)
    res = {"cell": args.cell, "seed": args.seed, "units": k,
           "device": torch.cuda.get_device_name(0),
           "power_limit": R.power_limit()}
    res["span_ns_root"], res["span_ns_nested"] = span_ns(spans)
    tracer = devtrace.Tracer()
    tracer.start()
    res["span_ns_root_profiled"], _ = span_ns(spans, 20_000)
    tracer.stop()
    tracer.prof = None

    # the records one unit makes
    before = max((r.id for r in spans.records()), default=0)
    driver.unit(0)
    mine = [r for r in spans.records() if r.id > before]
    res["spans_a_unit"] = len(mine)
    res["span_names"] = sorted({r.name for r in mine})

    i = 1
    plain, on, off = [], [], []
    enabled = spans._profiler_enabled
    for r in range(args.rounds):
        for mode in ("on", "off", "off", "on"):
            tracer = devtrace.Tracer()
            tracer.start()
            if mode == "off":
                spans._profiler_enabled = lambda: False
            try:
                ms = unit_ms(driver, i, k)
            finally:
                spans._profiler_enabled = enabled
            tracer.stop()
            tracer.prof = None
            (on if mode == "on" else off).extend(ms)
            i += k
        plain.extend(unit_ms(driver, i, k))
        i += k
    res["unit_ms_profiled_spans_on"] = statistics.median(on)
    res["unit_ms_profiled_spans_off"] = statistics.median(off)
    res["unit_ms_no_profiler"] = statistics.median(plain)
    res["range_us_a_span"] = (
        1e3 * (res["unit_ms_profiled_spans_on"]
               - res["unit_ms_profiled_spans_off"]) / res["spans_a_unit"])

    if cell.workload["driver"] == "train":
        root = [r for r in mine if r.name == "train.step"][0]
        res["step_split_ms"] = dict(root.counts)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        for e in ev:
            e.record()
        torch.cuda.synchronize()
        t = time.perf_counter_ns()
        for _ in range(1000):
            [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
        res["elapsed_time_reads_us_a_step"] = \
            (time.perf_counter_ns() - t) / 1000 / 1e3
        # a second train step of the cell whose timing events record
        # nothing: what the four events cost a step
        real = torch.cuda.Event
        torch.cuda.Event = NoEvent
        try:
            other = R.load_module(cell.driver_path, "bench_driver2") \
                .Driver(R.Run(cell, args.seed, "cuda"))
            other.setup()
        finally:
            torch.cuda.Event = real
        with_ev, without = [], []
        for _ in range(3):
            for d, out in ((driver, with_ev), (other, without),
                           (other, without), (driver, with_ev)):
                out.extend(unit_ms(d, i, 50))
                i += 50
        res["step_ms_with_events"] = statistics.median(with_ev)
        res["step_ms_without_events"] = statistics.median(without)

    line = json.dumps(res)
    print(line, flush=True)
    out = args.out or os.path.join(ROOT, "chiprun_out",
                                   f"time_spans_{args.cell}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
