#!/usr/bin/env python3
"""The media-density gradient check of tests/test_grad.py
(`test_grad_medium_density_matches_fd`: a constant-medium box in front of
a quad light, 8192 jittered rays, depth 6, the leaf -1/density, central
differences of eps 2e-2 with common random numbers, held to rel 0.15 /
abs 2e-3) over many seeds, each package on its own random stream: the
JAX package on `jax.random.key(seed)` (rays' jitter and path uniforms),
the PyTorch port on a `torch.Generator` seeded `seed` (jitter by
`torch.randn`, path uniforms drawn by `radiance`). One package per
process, so the port's run imports no JAX.

  python3 scripts/density_grad_seeds.py --package torch --seeds 20
  python3 scripts/density_grad_seeds.py --package jax --seeds 20

Prints one JSON line per seed (analytic, FD, relative error, whether the
check's tolerance is missed) and a summary line: the mean and standard
deviation of the signed relative error (analytic - FD) / |FD|, of its
absolute value, and the miss count."""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_RAYS, DEPTH, MAX_C, EPS, REL, ABS = 8192, 6, 1.5, 2e-2, 0.15, 2e-3


def _build(SceneBuilder):
    b = SceneBuilder(background=(0.0, 0.0, 0.0))
    b.constant_medium_box((-2, -2, -2), (2, 2, 2), 0.4,
                          albedo=(0.8, 0.8, 0.8))
    q = b.quad((-3, -3, -6), (6, 0, 0), (0, 6, 0),
               b.diffuse_light((4, 4, 4)))
    b.add_light(q)
    return b.build()


def torch_row(seed):
    """(analytic, FD) of the port on its own stream at `seed`."""
    import torch

    from go_raytracer_tpu_torch.integrator import wavefront
    from go_raytracer_tpu_torch.ops import trace
    from go_raytracer_tpu_torch.parallel import mesh as pmesh
    from go_raytracer_tpu_torch.scene.builder import SceneBuilder

    ds = trace.to_device(_build(SceneBuilder), "cpu")
    g = torch.Generator().manual_seed(seed)
    o = torch.tensor([[0.0, 0.0, 5.0]]).repeat(N_RAYS, 1)
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(N_RAYS, 1) \
        + torch.randn((N_RAYS, 3), generator=g) * 0.1
    t = torch.zeros(N_RAYS)
    state = g.get_state()

    def f(p):
        g.set_state(state)              # common random numbers
        L, _ = wavefront.radiance(pmesh.apply_params(ds, p), o, d, t, g,
                                  DEPTH, MAX_C, mode="scan")
        return torch.nan_to_num(L).mean()

    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in pmesh.extract_params(ds).items()}
    f(params).backward()
    an = float(params["med_neg_inv_density"].grad[0])
    vals = []
    with torch.no_grad():
        for sgn in (1, -1):
            p2 = {k: v.detach().clone() for k, v in params.items()}
            p2["med_neg_inv_density"][0] += sgn * EPS
            vals.append(float(f(p2)))
    return an, (vals[0] - vals[1]) / (2 * EPS)


def jax_row(seed):
    """(analytic, FD) of the JAX package on jax.random.key(seed)."""
    import jax
    import jax.numpy as jnp

    from go_raytracer_tpu.integrator import wavefront
    from go_raytracer_tpu.parallel import mesh as pmesh
    from go_raytracer_tpu.scene.builder import SceneBuilder

    scene = _build(SceneBuilder)
    params = pmesh.extract_params(scene)
    k_jit, k_path = jax.random.split(jax.random.key(seed))
    o = jnp.tile(jnp.asarray([[0.0, 0.0, 5.0]]), (N_RAYS, 1))
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (N_RAYS, 1)) + \
        jax.random.normal(k_jit, (N_RAYS, 3)) * 0.1

    def f(p):
        L, _ = wavefront.radiance(pmesh.apply_params(scene, p), o, d,
                                  jnp.zeros(N_RAYS), k_path, DEPTH, MAX_C,
                                  mode="scan")
        return jnp.nan_to_num(L).mean()

    an = float(jax.grad(f)(params)["med_neg_inv_density"][0])
    leaf = params["med_neg_inv_density"]
    vals = [float(f(dict(params, med_neg_inv_density=leaf.at[0].add(s))))
            for s in (EPS, -EPS)]
    return an, (vals[0] - vals[1]) / (2 * EPS)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("torch", "jax"), required=True)
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--first", type=int, default=0)
    args = ap.parse_args()
    if args.package == "jax":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
    row = torch_row if args.package == "torch" else jax_row
    rels, misses = [], 0
    for seed in range(args.first, args.first + args.seeds):
        an, fd = row(seed)
        rel = (an - fd) / abs(fd)
        miss = abs(an - fd) > max(REL * abs(fd), ABS)
        misses += miss
        rels.append(rel)
        print(json.dumps(dict(seed=seed, analytic=an, fd=fd, rel=rel,
                              miss=bool(miss))), flush=True)
    r = np.asarray(rels)
    print(json.dumps(dict(
        package=args.package, seeds=len(r), mean_rel=float(r.mean()),
        sd_rel=float(r.std(ddof=1)) if len(r) > 1 else 0.0,
        mean_abs_rel=float(np.abs(r).mean()),
        sd_abs_rel=float(np.abs(r).std(ddof=1)) if len(r) > 1 else 0.0,
        misses=int(misses))))


if __name__ == "__main__":
    main()
