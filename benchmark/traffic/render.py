"""The `render` traffic: one client renders whole images back to back
(a closed loop), image i of the window with seed `--seed` + i, at the
configuration's published size and sample count. An image is timed from
the `render_regen` call until its linear image is back on the host.

Parameters (the workload file's `params`): `lanes`, `schedule`, `mesh`
(render_regen's arguments), `pixels` (how many pixels, drawn from the
seed, the comparison reads in every image), `compared_images` (how many
of the window's images, drawn from the seed, `bias`, `noise` and
`energy` read), `reference_renders` (how many times the reference
renders the pixels).
"""

from __future__ import annotations

import sys
import time

import numpy as np

T0 = time.perf_counter()


def ref_seed(seed: int, k: int) -> int:
    """The seed of the reference's k-th render."""
    return (seed * 0x2545F4914F6CDD1D + 1 + k) & ((1 << 63) - 1)


class Driver:
    # set-up seconds spent making the benchmark's own inputs: none here
    inputs_s = 0.0

    def __init__(self, run):
        self.run = run
        self.p = run.workload["params"]

    def setup(self):
        import torch

        from benchmark import scenes
        from benchmark.reference import check_render
        from go_raytracer_tpu_torch.integrator import regen

        self.regen = regen
        self.scene, self.cam = scenes.build(self.run.config)
        print(f"set-up: scene built at {time.perf_counter() - T0:.3f} s",
              file=sys.stderr)
        h, w = self.cam.image_height, self.cam.width
        self.pixels = check_render.sample_pixels(self.run.seed, h, w,
                                                 self.p["pixels"])
        self.rows, self.cols = self.pixels // w, self.pixels % w
        self.kw = dict(n_lanes=self.p["lanes"], schedule=self.p["schedule"],
                       device=self.run.device)
        if "mesh" in self.p:
            self.kw["mesh"] = self.p["mesh"]
        # the warm-up: the window's first image once, every kernel built,
        # loaded and (on the mesh path) its levels captured
        self.render(self.run.seed)
        print(f"set-up: warm-up image at {time.perf_counter() - T0:.3f} s",
              file=sys.stderr)
        self.samples = []
        self.torch = torch

    def render(self, seed):
        return self.regen.render_regen(self.scene, self.cam, seed=seed,
                                       **self.kw)

    def unit(self, i: int) -> dict:
        t0 = time.perf_counter()
        img, st = self.render(self.run.seed + i)
        t1 = time.perf_counter()
        self.samples.append(img[self.rows, self.cols].astype(np.float64))
        return {"start": t0, "end": t1, "paths": st["paths"],
                "segments": st["segments"], "occupancy": st["occupancy"],
                "failed": st["nonfinite"] > 0}

    def end_to_end(self, units, window_s) -> dict:
        return {"paths_per_s": sum(u["paths"] for u in units) / window_s / 1e6,
                "images": len(units)}

    def release(self):
        del self.scene
        if self.run.device == "cuda":
            self.torch.cuda.empty_cache()

    def compare(self) -> dict:
        from benchmark.reference import check_render, pathtrace

        sc = pathtrace.Scene(self.run.config, self.run.device)
        refs = np.stack([check_render.render_pixels(
            self.run.config, self.pixels, ref_seed(self.run.seed, k),
            self.run.device, scene=sc)
            for k in range(self.p["reference_renders"])])
        return check_render.numbers(
            np.stack(self.samples), refs, check_render.sample_images(
                self.run.seed, len(self.samples), self.p["compared_images"]))
