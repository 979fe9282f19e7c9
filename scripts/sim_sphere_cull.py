#!/usr/bin/env python3
"""Estimate, on the CPU, how many blocks of 8 sphere rows the bounce
kernels' culled scan (csrc/bounce_core.cuh, `sphere_block_hit`) makes a
warp test, on the lane pool the fused-kernel timings use.

    python3 scripts/sim_sphere_cull.py [--scene book1] [--lanes 131072]
                                       [--calls 9] [--cursor-step 0]

It ages a pool as scripts/time_fused_kernels.py does (`calls` calls of the
plain `bounce_fused_q` at one level from an empty pool, the item queue
starting at `cursor-step` x the call's index, 0: at item 0 every call), and
takes the rays that enter the last call's bounce: the refilled camera
rays and the lanes still alive. For each block of 8 rows of the sphere
section it takes the box of its active spheres swept over the motion,
unpadded, and counts the rays whose slab interval meets (T_MIN, inf): the
cull's test before any hit has shortened the interval, so an upper bound
of what the kernel tests. It prints the fraction of the blocks a lane
needs and the fraction a warp of 32 consecutive lanes needs (the union of
its lanes', which is what a warp executes). The plain version at 131,072
lanes and 389 spheres takes about a minute on a few CPU cores.
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from go_raytracer_tpu_torch.integrator import regen  # noqa: E402
from go_raytracer_tpu_torch.ops import bounce  # noqa: E402
from go_raytracer_tpu_torch.scenes import registry  # noqa: E402

T_MIN = 1e-3
BLOCK_ROWS = 8


def block_boxes(prims, n_sph):
    """(lo, hi) of each block of BLOCK_ROWS rows of the sphere section:
    the box of its active spheres at time 0 and 1, radius |r|; an empty
    block's box is empty (lo = inf, hi = -inf)."""
    g = prims[:n_sph]
    act = g[:, 0] >= 0
    c0, cd, r = g[:, 1:4], g[:, 4:7], np.abs(g[:, 7])[:, None]
    lo = np.minimum(c0, c0 + cd) - r
    hi = np.maximum(c0, c0 + cd) + r
    nb = (n_sph + BLOCK_ROWS - 1) // BLOCK_ROWS
    blo = np.full((nb, 3), np.inf)
    bhi = np.full((nb, 3), -np.inf)
    for k in np.nonzero(act)[0]:
        blo[k // BLOCK_ROWS] = np.minimum(blo[k // BLOCK_ROWS], lo[k])
        bhi[k // BLOCK_ROWS] = np.maximum(bhi[k // BLOCK_ROWS], hi[k])
    return blo, bhi


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default="book1")
    ap.add_argument("--lanes", type=int, default=1 << 17)
    ap.add_argument("--calls", type=int, default=9)
    ap.add_argument("--cursor-step", type=int, default=0)
    args = ap.parse_args()
    scene, cam = getattr(registry, args.scene)()
    tab = tuple(torch.from_numpy(t) for t in bounce.pack_scene(scene))
    st = bounce.scene_statics(scene)
    row = torch.from_numpy(bounce.pack_camera(cam.derived()))
    bg = torch.from_numpy(np.asarray(scene.background, np.float32))
    n, sq = args.lanes, cam.spp_sqrt
    npix = cam.width * cam.image_height
    kw = dict(has_defocus=cam.defocus_angle > 0, max_depth=cam.max_depth,
              n_inner=1, width=cam.width, sqrt_spp=sq, npix=npix)
    state = regen._init_state(n, torch.device("cpu"))
    rays = {}
    core = bounce._bounce_core_ref

    def capture(st_, prims, lights, bgl, ox, oy, oz, dx, dy, dz, alive, u,
                **k):
        rays["last"] = [x.double().numpy() for x in (ox, oy, oz, dx, dy, dz)]
        rays["alive"] = alive.numpy().copy()
        return core(st_, prims, lights, bgl, ox, oy, oz, dx, dy, dz, alive,
                    u, **k)

    bounce._bounce_core_ref = capture
    for i in range(args.calls):
        seed4 = torch.tensor([7, 1, i * args.cursor_step, npix * sq * sq],
                             dtype=torch.int32)
        out = bounce.bounce_fused_q(tab, st, row, bg, seed4, *state, **kw)
        state = [s.clone() for s in out[4:]]
    bounce._bounce_core_ref = core
    o, d = rays["last"][:3], rays["last"][3:]
    alive = rays["alive"]
    inv = [1.0 / np.where(np.abs(v) < 1e-30, np.copysign(1e-30, v), v)
           for v in d]
    blo, bhi = block_boxes(tab[0].numpy(), st["n_sph"])
    need = np.zeros((blo.shape[0], n), bool)
    for b in range(blo.shape[0]):
        t0 = [(blo[b][a] - o[a]) * inv[a] for a in range(3)]
        t1 = [(bhi[b][a] - o[a]) * inv[a] for a in range(3)]
        near = np.max([np.minimum(x, y) for x, y in zip(t0, t1)], axis=0)
        far = np.min([np.maximum(x, y) for x, y in zip(t0, t1)], axis=0)
        need[b] = (np.maximum(near, T_MIN) <= far) & alive
    warp_any = alive.reshape(-1, 32).any(axis=1)
    union = need.reshape(need.shape[0], -1, 32).any(axis=2)[:, warp_any]
    print(f"{args.scene}, {n} lanes, {args.calls} calls (cursor step "
          f"{args.cursor_step}), {blo.shape[0]} blocks of {BLOCK_ROWS} "
          f"sphere rows: lanes in the last call's bounce {alive.mean():.3f}; "
          f"blocks a lane needs {need[:, alive].mean():.3f}, a warp's union "
          f"{union.mean():.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
