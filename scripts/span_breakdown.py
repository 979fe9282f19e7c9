#!/usr/bin/env python3
"""Where a benchmark cell's units spend their time, by the port's spans:
one traced run of the cell (`benchmark/run.run_cell`, as `python3
benchmark/run.py --workload <cell> --trace 1` runs it), on one NVIDIA GPU,
with its span records and the trace's idle gaps kept.

    python3 scripts/span_breakdown.py --cell cornellBox.final [--seed N]
                                      [--seconds S] [--out FILE]

Over the units that ran after the profiler stopped it reports the median
ms of each span a unit (summed where a unit has several, as
`render.sync`), the spans a unit, the share of each root (`render`) that
its children cover, the median root against the median period from one
root's start to the next (the harness's time a unit), and on a train cell
the device split of the step (`forward_ms`, `backward_ms`, `adam_ms`)
beside the device's busy time a traced step. The window's units are the
run's last roots, the reference calling no code of the port. The ten
longest idle gaps are the run's breakdown, named by the innermost host
event over each (a span of the port's where no op of PyTorch's is inside
it). Prints one JSON line, also written to --out (default
chiprun_out/span_breakdown_<cell>.json). Without a GPU it exits
non-zero.
"""

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, default=2718281828)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the breakdown is the card's", file=sys.stderr)
        return 1
    from benchmark import run as R
    from go_raytracer_tpu_torch.utils import spans

    cell = R.Cell(args.cell)
    res = R.run_cell(cell, args.seed, args.seconds, True)
    root = "train.step" if cell.workload["driver"] == "train" else "render"
    n_traced = cell.workload.get("trace_units", 1)
    window = spans.trees(root)[-res["attempted"]:]
    traced, trees = window[:n_traced], window[n_traced:]
    names = sorted({r.name for _, rest in trees for r in rest})
    out = {"cell": cell.name, "seed": args.seed, "correct": res["correct"],
           "device": res["device"]["kind"],
           "power_limit": res["device"].get("power_limit"),
           "metrics": {k: v["value"] for k, v in res["metrics"].items()},
           "roots_after_profiler": len(trees),
           "spans_a_unit": statistics.median(1 + len(rest)
                                             for _, rest in trees),
           "span_ms": {n: statistics.median(
               sum(r.ns for r in rest if r.name == n) / 1e6
               for _, rest in trees) for n in names},
           "span_count": {n: statistics.median(
               sum(r.name == n for r in rest) for _, rest in trees)
               for n in names},
           "root_ms": statistics.median(r.ns / 1e6 for r, _ in trees),
           "period_ms": statistics.median(
               (b.t0 - a.t0) / 1e6 for (a, _), (b, _) in zip(trees,
                                                           trees[1:])),
           "gaps": res["breakdown"]["idle_gaps"]}
    cover = [sum(r.ns for r in rest if r.parent == top.id) / top.ns
             for top, rest in trees]
    out["children_cover_min"] = min(cover)
    out["children_cover_median"] = statistics.median(cover)
    loops = [r for _, rest in trees for r in rest
             if r.name == "render.windows"]
    if loops:
        out["loop_counts"] = {k: statistics.median(r.counts[k] for r in loops)
                              for k in loops[0].counts}
    if root == "train.step":
        for part, ts in (("traced", traced), ("after", trees)):
            split = [r.counts for r, _ in ts if "forward_ms" in r.counts]
            if split:
                out[f"device_split_ms_{part}"] = {
                    k: statistics.median(c[k] for c in split)
                    for k in split[0]}
                out[f"device_split_sum_ms_{part}"] = statistics.median(
                    sum(c.values()) for c in split)
        out["busy_ms_a_traced_step"] = \
            1e3 * res["device"]["busy_s"] / n_traced
    line = json.dumps(out)
    print(line, flush=True)
    path = args.out or os.path.join(ROOT, "chiprun_out",
                                    f"span_breakdown_{args.cell}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
