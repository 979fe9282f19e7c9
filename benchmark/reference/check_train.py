"""The reference's inverse-rendering steps and the comparison that decides
a train cell's `correct`.

A step renders S sample batches of one camera ray per pixel at stratum
(0, 0) (the camera's jitter within the first stratum, as the program's
`render_batches` renders them), takes the mean over the batches, the MSE
against the target, its gradient by autograd and one Adam update (beta
0.9 / 0.999, eps 1e-8 after the square root, bias-corrected moments).
The leaves are each material's colour (albedo or emission), each metal's
fuzz, and the background. A step's random numbers are drawn from a
`torch.Generator` on the device in the program's order (the camera's
(S N, 5), then each level's (S N, n_u)), so the reference follows the
program's paths; that order and the generator are the benchmark's, not
the program's making.

Plain PyTorch; imports nothing of the program.
"""

from __future__ import annotations

import statistics

import torch

from benchmark.reference import pathtrace as pt

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def leaf_names(cfg: dict) -> list:
    """Each material's colour, each metal's fuzz, the background."""
    return [f"color.{m['name']}" for m in cfg["materials"]] \
        + [f"fuzz.{m['name']}" for m in cfg["materials"]
           if m["kind"] == "metal"] + ["background"]


def draw_step(gen, rays: int, levels: int, device, n_u: int = pt.N_U):
    """One step's numbers: camera (rays, 5), levels (levels, rays, n_u),
    n_u >= 9 the numbers a ray takes at a level in the program's stream
    (the slots past the ninth go unread here)."""
    cam = torch.empty((rays, pt.N_U_CAMERA), device=device).uniform_(generator=gen)
    lv = torch.empty((levels, rays, n_u), device=device)
    for s in range(levels):
        lv[s].uniform_(generator=gen)
    return cam, lv


def render_batches(sc, frame, cam_cfg, leaves, ucam, ulev, batches: int,
                   n_rays: int, dtype, keep_batches=None):
    """The mean over the batches (n_rays, 3) of the radiance of each
    pixel's camera ray."""
    dev = ucam.device
    ids = torch.arange(n_rays, device=dev).repeat(batches)
    o, d = pt.camera_rays(frame, ids, 0.0, 0.0, ucam.to(dtype), dtype)
    colors = torch.stack([leaves[f"color.{m}"] for m in sc.mat_names]).to(dtype)
    fuzz = torch.stack([leaves.get(f"fuzz.{m}", sc.fuzz[i])
                        for i, m in enumerate(sc.mat_names)]).to(dtype)
    L = pt.radiance(sc, o, d, cam_cfg["max_depth"], cam_cfg["max_contribution"],
                    lambda s: ulev[s], colors=colors,
                    background=leaves["background"].to(dtype), fuzz=fuzz)
    L = L.view(batches, n_rays, 3)
    if keep_batches is not None:
        L = L[:keep_batches]
    return L.float().mean(0)


def train_steps(cfg: dict, cam_cfg: dict, leaves0: dict, target, batches: int,
                n_rays: int, lr: float, gen_seed: int, steps: int, device,
                dtype=torch.float32, keep_batches=None, scale_grad=None,
                n_u: int = pt.N_U):
    """`steps` reference steps from leaves0 ({name: (3,) tensor}). Returns
    {"losses": [...], "grad1": {name: first gradient}, "delta": {name:
    change after the steps}}. `keep_batches` (a planted fault) averages
    only the first batches; `scale_grad` = (name, factor) alters one
    leaf's gradient before Adam (another)."""
    frame = pt.camera_frame(cam_cfg)
    sc = pt.Scene(cfg, device, dtype)
    gen = torch.Generator(device=device).manual_seed(gen_seed)
    leaves = {k: v.detach().clone().to(device).float().requires_grad_(True)
              for k, v in leaves0.items()}
    m = {k: torch.zeros_like(v) for k, v in leaves.items()}
    v2 = {k: torch.zeros_like(v) for k, v in leaves.items()}
    out = {"losses": [], "grad1": None}
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for t in range(1, steps + 1):
            ucam, ulev = draw_step(gen, batches * n_rays,
                                   cam_cfg["max_depth"] + 1, device, n_u)
            img = render_batches(sc, frame, cam_cfg, leaves, ucam, ulev,
                                 batches, n_rays, dtype, keep_batches)
            loss = torch.mean((img - target.to(img.dtype)) ** 2)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
            grads = {k: (torch.zeros_like(p) if g is None else g.float())
                     for (k, p), g in zip(leaves.items(), grads)}
            if scale_grad is not None:
                grads[scale_grad[0]] = grads[scale_grad[0]] * scale_grad[1]
            out["losses"].append(float(loss.detach()))
            if out["grad1"] is None:
                out["grad1"] = {k: g.detach().clone() for k, g in grads.items()}
            with torch.no_grad():
                for k, p in leaves.items():
                    m[k].mul_(BETA1).add_(grads[k], alpha=1 - BETA1)
                    v2[k].mul_(BETA2).addcmul_(grads[k], grads[k], value=1 - BETA2)
                    denom = (v2[k] / (1 - BETA2 ** t)).sqrt() + EPS
                    p.sub_(lr * (m[k] / (1 - BETA1 ** t)) / denom)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    out["delta"] = {k: (leaves[k].detach() - leaves0[k].to(device).float())
                    for k in leaves}
    return out


def _gap(prog: dict, ref: dict, names) -> float:
    """The worst leaf's gap between the two sides' norms, over the larger
    of the reference leaf's norm and the median leaf's."""
    norms = {k: float(ref[k].norm()) for k in names}
    med = statistics.median(norms.values())
    return max(abs(float(prog[k].norm()) - norms[k]) / max(norms[k], med)
               for k in names)


def numbers(prog: dict, ref: dict) -> dict:
    """`loss` (the worst step's relative loss gap), `grad` (the first
    gradient's worst-leaf norm gap) and `step` (the worst-leaf gap of the
    change after the steps, over the leaves whose reference gradient is at
    least a thousandth of the median leaf's: a leaf the render all but
    never reads moves under Adam by round-off alone)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    g = {k: float(ref["grad1"][k].norm()) for k in ref["grad1"]}
    read = [k for k in g if g[k] > 0]
    med = statistics.median(g[k] for k in read)
    moved = [k for k in read if g[k] >= 1e-3 * med]
    return {"loss": loss, "grad": _gap(prog["grad1"], ref["grad1"], read),
            "step": _gap(prog["delta"], ref["delta"], moved)}
