"""The readings that a cell's limits are set from, on the card at the
cell's own size: the control (the reference put in the program's place
and computed in bfloat16, the precision below the float32 the
configurations state) and the planted faults (the reference in the
program's place, broken), each against the float32 reference the run
compares with, on each seed given.

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> <n> <n>

Render cells, each with as many images as a run compares
(`compared_images`): `sound` (float32 reference images with numbers of
their own, the reference against itself), `control`, `half` (half of
each pixel's samples left out, the mean taken over the rest), `dim`
(every surface that emits no light reflects 0.9 of its colour: energy
lost at every bounce), `unchanged` (images of zeros: an accumulator
never written), `altered` (the upper half of one image left black where
it is produced), `repeated` (one image returned for every seed). Train cells: `control`, `half` (half of the sample
batches left out), `altered` (one leaf's gradient doubled before Adam);
a step that leaves its state unchanged reads 1 on `step` by the
measure's definition. One JSON line a seed and reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def render_readings(run, seed: int, device: str) -> dict:
    import numpy as np
    import torch

    from benchmark.reference import check_render as cr, pathtrace as pt
    from benchmark.traffic.render import ref_seed

    cfg, cam, p = run.config, run.config["camera"], run.workload["params"]
    h = max(1, int(cam["width"] / cam["aspect_ratio"]))
    pix = cr.sample_pixels(seed, h, cam["width"], p["pixels"])
    n_ref, k = p["reference_renders"], p["compared_images"]
    scenes = {t: pt.Scene(cfg, device, t) for t in (torch.float32, torch.bfloat16)}
    draw = lambda i, dtype=torch.float32, **kw: cr.render_pixels(
        cfg, pix, ref_seed(seed, i), device, dtype, scene=scenes[dtype], **kw)
    images = lambda first, **kw: np.stack([draw(first + i, **kw)
                                           for i in range(k)])
    refs = np.stack([draw(i) for i in range(n_ref)])
    # the reference in the program's place: as many images, of its own
    # numbers, as a run compares
    sound = images(n_ref)
    faults = {
        "sound": sound,
        "control": images(n_ref + k, dtype=torch.bfloat16),
        "half": images(n_ref + 2 * k, keep=0.5),
        "dim": images(n_ref + 3 * k, albedo=0.9),
        "unchanged": np.zeros_like(sound),
        "altered": np.concatenate([half_black(sound[:1]), sound[1:]]),
        "repeated": np.stack([sound[0]] * k),
    }
    return {name: cr.numbers(v, refs) for name, v in faults.items()}


def half_black(images):
    """The images with the first half of the sampled pixels (the upper part
    of the image: the ids are sorted) left black."""
    out = images.copy()
    out[:, :out.shape[1] // 2] = 0.0
    return out


def train_readings(run, seed: int, device: str) -> dict:
    import torch

    from benchmark.reference import check_train as ct

    drv = load_driver(run)
    drv.inputs()
    p = run.workload["params"]
    steps = lambda **kw: ct.train_steps(
        run.config, drv.camera_cfg(), drv.leaves0, drv.target, p["batches"],
        drv.n_rays, p["learning_rate"], drv.gen_seed, 3, device, **kw)
    ref = steps()
    second = ct.leaf_names(run.config)[1]
    out = {"control": steps(dtype=torch.bfloat16),
           "half": steps(keep_batches=p["batches"] // 2),
           "altered": steps(scale_grad=(second, 2.0))}
    return {k: ct.numbers(v, ref) for k, v in out.items()}


def load_driver(run):
    from benchmark.run import load_module

    return load_module(run.cell.driver_path, "bench_driver").Driver(run)


def main(argv=None) -> int:
    from benchmark.run import Cell, Run

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    for seed in args.seeds:
        run = Run(cell, seed, args.device)
        t0 = time.perf_counter()
        if cell.workload["driver"] == "render":
            readings = render_readings(run, seed, args.device)
        else:
            readings = train_readings(run, seed, args.device)
        for k, v in readings.items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "reading": k, **v}), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
