"""The `train` traffic: inverse rendering, steps back to back, each ending
in its loss read. `make_train_step` renders `batches` sample batches of
one camera ray per pixel of a `width` x `width` image at depth `depth`,
takes the MSE against a target, its gradient and one Adam step; on the
card it is one CUDA graph a step. Its random numbers come from a
`torch.Generator` on the device seeded from `--seed`.

The benchmark makes the target (the reference's render of the
configuration's own colours, with its own numbers) and the perturbed
starting leaves (each material's colour scaled, per channel, by a factor
in [0.6, 1.4], the background raised by up to 0.1, a metal's fuzz as
configured), both from the seed.
Set-up runs the first three steps through the window's own call; the
reference follows those three from the same leaves and numbers. The
seconds that making the target takes (`inputs_s`) are the benchmark's,
not the program's, and stay out of `setup_s`; so does the memory they
take, by a reset of the peak once the target is made.

Parameters: `width`, `batches`, `depth`, `learning_rate`.
"""

from __future__ import annotations

import sys
import time

import numpy as np

T0 = time.perf_counter()


def stage(what: str):
    print(f"set-up: {what} at {time.perf_counter() - T0:.3f} s",
          file=sys.stderr)


def sub_seed(seed: int, tag: int) -> int:
    return (seed * 0x9E3779B97F4A7C15 + tag) & ((1 << 63) - 1)


class Driver:
    def __init__(self, run):
        self.run = run
        self.p = run.workload["params"]

    def camera_cfg(self) -> dict:
        return dict(self.run.config["camera"], width=self.p["width"],
                    max_depth=self.p["depth"])

    def setup(self):
        import torch

        from benchmark import scenes
        from benchmark.reference import check_train
        from go_raytracer_tpu_torch.parallel import mesh as pmesh

        self.torch = torch
        dev = torch.device(self.run.device)
        cfg, cam_cfg = self.run.config, self.camera_cfg()
        s, depth = self.p["batches"], self.p["depth"]
        scene, cam = scenes.build(cfg, {k: cam_cfg[k] for k in
                                        ("width", "aspect_ratio", "max_depth")})
        stage("scene built")
        t_inputs = time.perf_counter()
        self.inputs()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        self.inputs_s = time.perf_counter() - t_inputs
        stage(f"target and starting leaves made in {self.inputs_s:.3f} s")
        step, params, opt = pmesh.make_train_step(
            scene, cam, n_rays=self.n_rays, n_sample_batches=s,
            max_depth=depth, learning_rate=self.p["learning_rate"],
            device=dev,
            generator=torch.Generator(device=dev).manual_seed(self.gen_seed))
        # the numbers a ray draws a level: nine, and one a medium row of
        # the program's table
        self.n_u = 9 + params["med_neg_inv_density"].shape[0]
        now = self.leaves_of(params)
        if not all(torch.equal(v, now[k]) for k, v in self.truth.items()):
            raise RuntimeError("the program's leaves are not the "
                               "configuration's materials in order")
        with torch.no_grad():
            for name, (k, i) in zip(check_train.leaf_names(cfg),
                                    self.modelled()):
                params[k][i] = self.leaves0[name].to(dev)
        self.before = {k: v.detach().clone() for k, v in params.items()}
        self.ids = torch.arange(self.n_rays, device=dev).repeat(s, 1)
        self.step, self.params, self.opt = step, params, opt
        # the first three steps, through the window's own call: the first
        # eager, the second captured, the third a replay
        stage("train step made")
        self.prog = {"losses": [self.step(params, self.ids, self.target)]}
        stage("step 1 (eager)")
        keys = list(params)
        # the first gradient as Adam got it: its first moment after one
        # step is 0.1 of it (none where the optimizer never stepped)
        g1 = {k: opt.state.get(params[k], {}).get(
            "exp_avg", torch.zeros_like(params[k])).detach() / 0.1 for k in keys}
        self.prog["losses"] += [self.step(params, self.ids, self.target)
                                for _ in range(2)]
        stage("steps 2 (capture) and 3")
        self.after = {k: v.detach().clone() for k, v in params.items()}
        self.prog["grad1"] = self.leaves_of(g1)
        delta = {k: self.after[k] - self.before[k] for k in keys}
        self.prog["delta"] = self.leaves_of(delta)
        # what the reference does not model must not move
        for k, i in self.modelled():
            delta[k] = delta[k].clone()
            delta[k][i] = 0.0
        self.other_moved = max(float(v.abs().max()) for v in delta.values()
                               if v.numel())

    def inputs(self):
        """The perturbed starting leaves and the target, from the seed:
        the benchmark's inputs, which it hands to both sides."""
        import torch

        from benchmark.reference import check_train, pathtrace as pt

        dev = torch.device(self.run.device)
        cfg, cam_cfg = self.run.config, self.camera_cfg()
        w, s, depth = self.p["width"], self.p["batches"], self.p["depth"]
        self.n_rays = w * max(1, int(w / cam_cfg["aspect_ratio"]))
        self.gen_seed = sub_seed(self.run.seed, 1)
        mats = cfg["materials"]
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)
        self.truth = {f"color.{m['name']}": f32(m["color"]) for m in mats}
        self.truth.update({f"fuzz.{m['name']}": f32(m["fuzz"]) for m in mats
                           if m["kind"] == "metal"})
        self.truth["background"] = f32(cfg["background"])
        rng = np.random.default_rng([self.run.seed & 0xFFFFFFFF,
                                     self.run.seed >> 32, 0x7EA1])
        self.leaves0 = dict(self.truth)
        for m in mats:
            k = f"color.{m['name']}"
            self.leaves0[k] = self.truth[k] * f32(rng.uniform(0.6, 1.4, 3))
        self.leaves0["background"] = self.truth["background"] \
            + f32(rng.uniform(0.0, 0.1, 3))
        # the target: the reference's render of the true leaves, with
        # numbers of its own
        tg = torch.Generator(device=dev).manual_seed(sub_seed(self.run.seed, 2))
        truth = {k: v.to(dev) for k, v in self.truth.items()}
        with torch.no_grad():
            ucam, ulev = check_train.draw_step(tg, s * self.n_rays, depth + 1,
                                               dev)
            self.target = check_train.render_batches(
                pt.Scene(cfg, dev), pt.camera_frame(cam_cfg), cam_cfg, truth,
                ucam, ulev, s, self.n_rays, torch.float32).contiguous()

    def modelled(self):
        """(program leaf, row) of each leaf the reference models, in
        `check_train.leaf_names` order."""
        mats = self.run.config["materials"]
        return [("tex_color", i) for i in range(len(mats))] \
            + [("fuzz", i) for i, m in enumerate(mats) if m["kind"] == "metal"] \
            + [("background", slice(None))]

    def leaves_of(self, t: dict) -> dict:
        """The program's tables cut into the reference's leaves (CPU)."""
        from benchmark.reference import check_train

        return {name: t[k][i].detach().float().cpu() for name, (k, i) in
                zip(check_train.leaf_names(self.run.config), self.modelled())}

    def unit(self, i: int) -> dict:
        t0 = time.perf_counter()
        loss = self.step(self.params, self.ids, self.target)
        t1 = time.perf_counter()
        return {"start": t0, "end": t1, "loss": loss,
                "failed": not np.isfinite(loss)}

    def end_to_end(self, units, window_s) -> dict:
        return {"step_ms": 1e3 * window_s / len(units), "steps": len(units)}

    def release(self):
        del self.step, self.params, self.opt
        if self.run.device == "cuda":
            self.torch.cuda.empty_cache()

    def compare(self) -> dict:
        from benchmark.reference import check_train

        ref = check_train.train_steps(
            self.run.config, self.camera_cfg(), self.leaves0, self.target,
            self.p["batches"], self.n_rays, self.p["learning_rate"],
            self.gen_seed, 3, self.run.device, n_u=self.n_u)
        ref = {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict)
                   else v) for k, v in ref.items()}
        out = check_train.numbers(self.prog, ref)
        out["other_moved"] = self.other_moved
        return out
