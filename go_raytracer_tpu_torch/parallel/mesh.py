"""Scene parameters for inverse rendering and a differentiable training
step: the one-device part of the JAX package's `parallel/mesh.py`
(`extract_params`, `apply_params`, `make_train_step`).

The gradient is autograd over the reference engine
(`integrator/wavefront.radiance`, mode "scan", backend "xla"), which
stands in for `jax.grad`; `torch.optim.Adam` stands in for optax's
`adam` (the same update: beta 0.9/0.999, eps 1e-8 added after the square
root, bias-corrected moments).

On the card the backward of a table gather (a texture's colour, a
material's fuzz) is a scatter-add whose atomic order varies, so two runs'
gradients may differ in the last bits; on the CPU they are equal.
Device meshes and sharded rendering (`make_mesh`, `render_sharded`, the
sharded step) are not ported yet.
"""

from __future__ import annotations

import copy
import types as _pytypes

import numpy as np
import torch

from go_raytracer_tpu_torch.integrator import regen as regen_mod
from go_raytracer_tpu_torch.integrator import wavefront
from go_raytracer_tpu_torch.ops import trace as trace_mod
from go_raytracer_tpu_torch.render import camera as camera_mod
from go_raytracer_tpu_torch.scene import types as T


def extract_params(ds) -> dict:
    """Differentiable scene parameters of a device scene
    (`ops/trace.to_device`): texture colours (albedos and emission), the
    checker's even and odd colours, metal fuzz, dielectric index, medium
    density (as -1/density) and the background, under the JAX package's
    leaf names. The tensors are ds's own, on its device."""
    return trace_mod.param_tensors(ds)


def params_from_numpy(d) -> dict:
    """Parameters given as numpy arrays (e.g. `{k: np.asarray(v) for k, v
    in jax_params.items()}`) as float32 CPU tensors, copies."""
    unknown = set(d) - set(trace_mod.PARAMS)
    if unknown:
        raise ValueError(f"unknown parameter leaves {sorted(unknown)}")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in d.items()}


def apply_params(ds, params) -> _pytypes.SimpleNamespace:
    """A new device scene carrying `params` (a dict of some or all of
    `extract_params`' leaves, each of the same shape, on ds's device).
    Its textures, materials and media are shallow copies holding the
    given tensors, which keep their autograd graph; ds itself, and any K3
    launch prepared on it, stay as they were. The new scene's K3 launch
    is packed from its own tensors when it is first asked for
    (`integrator/wavefront.kernel_launch`)."""
    old = trace_mod.param_tensors(ds)
    for k, v in params.items():
        if k not in old:
            raise ValueError(f"unknown parameter leaf {k!r}")
        if tuple(v.shape) != tuple(old[k].shape) or v.device != old[k].device:
            raise ValueError(
                f"{k}: shape {tuple(v.shape)} on {v.device}, the scene's is "
                f"{tuple(old[k].shape)} on {old[k].device}")
    out = copy.copy(ds)
    for tab in {tab for k, (tab, _) in trace_mod.PARAMS.items()
                if tab is not None and k in params}:
        setattr(out, tab, copy.copy(getattr(ds, tab)))
    for k, v in params.items():
        tab, f = trace_mod.PARAMS[k]
        setattr(out if tab is None else getattr(out, tab), f, v)
    out.k3 = None
    return out


def render_batches(ds, arrays, width: int, ids, max_depth: int,
                   max_contribution: float, generator):
    """The mean over batches of the radiance of camera rays at stratum
    (0, 0), JAX's `loss_fn` render: ids (S, N) pixel ids. The S batches
    go through one `radiance` call of S * N rays (JAX vmaps them), the
    camera uniforms drawn first, then the path uniforms, from `generator`
    (on ds's device). Returns (image (N, 3), forward segments)."""
    s, n = ids.shape
    flat = ids.reshape(-1)
    u = torch.rand((s * n, camera_mod.N_U_RAYGEN), generator=generator,
                   device=flat.device)
    zero = torch.zeros((), device=flat.device)
    o, d, t = camera_mod.generate_rays(arrays, width, flat, zero, zero, u)
    L, st = wavefront.radiance(ds, o, d, t, generator, max_depth,
                               max_contribution, mode="scan")
    return L.reshape(s, n, 3).mean(dim=0), st["segments"]


def make_train_step(scene: T.Scene, cam: camera_mod.Camera, n_rays: int,
                    n_sample_batches: int, max_depth: int,
                    learning_rate: float = 1e-2, device=None,
                    generator=None):
    """Differentiable render + MSE loss + Adam update on one device (CUDA
    unless `device` says otherwise).

    Returns (train_step, params, optimizer): params are `extract_params`'
    leaves as fresh tensors that require a gradient, optimizer a
    `torch.optim.Adam(lr=learning_rate)` over them, and
    `train_step(params, ids, target)` renders `n_sample_batches` batches
    of `n_rays` camera rays (ids (n_sample_batches, n_rays) pixel ids;
    `pixel_ids(n_rays, n_sample_batches, device)` gives JAX's), takes the
    MSE of their mean against target (n_rays, 3), updates params in place
    and returns the loss as a float. Every leaf gets a gradient, zero
    where the render does not read it, as under optax. Uniforms come from
    `generator` (a torch.Generator on the device; seed 0 when None)."""
    device = regen_mod.resolve_device(device)
    ds = trace_mod.to_device(scene, device)
    arrays = cam.derived()
    w = cam.width
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in extract_params(ds).items()}
    optimizer = torch.optim.Adam(list(params.values()), lr=learning_rate)

    def train_step(params, ids, target):
        if tuple(ids.shape) != (n_sample_batches, n_rays):
            raise ValueError(f"ids of shape {tuple(ids.shape)}, the step "
                             f"renders ({n_sample_batches}, {n_rays})")
        optimizer.zero_grad(set_to_none=True)
        img, _ = render_batches(apply_params(ds, params), arrays, w, ids,
                                max_depth, cam.max_contribution, generator)
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        optimizer.step()
        return loss.item()

    return train_step, params, optimizer


def pixel_ids(n_rays: int, n_sample_batches: int, device=None):
    """JAX's ray layout for the step: ids 0 .. n_rays - 1 in every batch,
    (n_sample_batches, n_rays) int64."""
    return torch.arange(n_rays, device=device).repeat(n_sample_batches, 1)
