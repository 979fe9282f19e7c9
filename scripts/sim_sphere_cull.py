#!/usr/bin/env python3
"""Estimate, on the CPU, how many blocks of the bounce kernels' culled scan
(csrc/bounce_core.cuh, `block_hit`) a warp tests, on a lane pool in the
middle of the image, before and after the scan's redesign.

    python3 scripts/sim_sphere_cull.py [--scene book2 book1] [--lanes 65536]
                                       [--calls 6] [--cursor N]
                                       [--cursor-step 0] [--sorted]

It ages a pool as scripts/time_fused_kernels.py does (`calls` calls of the
plain `bounce_fused_q` at one level from an empty pool, the item queue
starting at `cursor` + `cursor-step` x the call's index; the default
cursor starts the pool's items in the middle rows of the image, since from
item 0 book2's first rows see almost nothing but sky), and takes the rays
that enter the last call's bounce: the refilled camera rays and the lanes
still alive. On them it runs the plain model of the scan
(`ops/bounce.closest_culled_ref`, the same winners as the brute-force scan)
three ways:

* before: the scan as it was, spheres in declaration order culled by
  blocks of 8 (their bounds tested, the interval shortened by each hit),
  every quad and box row tested (the ray turned per box row);
* after: the kernels' scan (`scan_layout`): spheres in Morton order, every
  section of more than one block culled, boxes in declaration order;
* after, boxes in Morton order: the choice the kernels did not take;
* with `--sorted`, also after on the same rays put in the order of the
  lane coherence sort (`regen.coherence_sort`, `reorder=True`): the warps
  of a sorted `queue` call (the call's refill would fill the dead tail
  with camera rays, which the pool here holds in place).

For each it prints, per section, the share of the section's blocks the
union of a warp's 32 lanes needs (what a warp executes), the rows and
block tests a lane makes, and the scan's float operations per lane
(`scan_ops`, SCAN_OPS) beside the brute-force scan's. The plain version
at 65,536 lanes takes about a minute a scene on a few CPU cores.
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

SECTIONS = ("spheres", "quads", "boxes")


def bounce_rays(scene, cam, lanes, calls, cursor, step):
    """The rays entering the last of `calls` plain one-level calls of
    `bounce_fused_q` on an aged pool: (ox, oy, oz, dx, dy, dz, tm) of the
    alive lanes, and the alive mask over all lanes."""
    tab = tuple(torch.from_numpy(t) for t in bounce.pack_scene(scene))
    st = bounce.scene_statics(scene)
    row = torch.from_numpy(bounce.pack_camera(cam.derived()))
    bg = torch.from_numpy(np.asarray(scene.background, np.float32))
    sq = cam.spp_sqrt
    npix = cam.width * cam.image_height
    kw = dict(has_defocus=cam.defocus_angle > 0, max_depth=cam.max_depth,
              n_inner=1, width=cam.width, sqrt_spp=sq, npix=npix)
    state = regen._init_state(lanes, torch.device("cpu"))
    rays = {}
    core = bounce._bounce_core_ref

    def capture(st_, prims, lights, bgl, ox, oy, oz, dx, dy, dz, alive, u,
                tm=None, **k):
        rays["last"] = (ox, oy, oz, dx, dy, dz, tm)
        rays["alive"] = alive.clone()
        return core(st_, prims, lights, bgl, ox, oy, oz, dx, dy, dz, alive,
                    u, tm=tm, **k)

    bounce._bounce_core_ref = capture
    try:
        for i in range(calls):
            seed4 = torch.tensor([7, 1, cursor + i * step, npix * sq * sq],
                                 dtype=torch.int32)
            out = bounce.bounce_fused_q(tab, st, row, bg, seed4, *state,
                                        **kw)
            state = [s.clone() for s in out[4:]]
    finally:
        bounce._bounce_core_ref = core
    return tab[0], st, rays["last"], rays["alive"]


def warp_share(scanned, alive):
    """The share of a section's blocks the union of each warp's alive lanes
    scans, over the warps with an alive lane."""
    if scanned.shape[0] == 0:
        return float("nan")
    need = scanned & alive[None]
    warp_any = alive.reshape(-1, 32).any(dim=1)
    union = need.reshape(need.shape[0], -1, 32).any(dim=2)[:, warp_any]
    return union.float().mean().item()


def report(tag, lay, stats, alive, counts, extra_rows=(0, 0, 0)):
    """One line per way: per section the warp share, rows and block tests
    a lane makes; the scan's operations per lane."""
    parts = []
    for sec, name in enumerate(SECTIONS):
        if counts[sec] == 0:
            continue
        rows = stats["rows"][sec][alive].double().mean().item() \
            + extra_rows[sec]
        blocks = stats["blocks"][sec][alive].double().mean().item()
        share = 1.0 if extra_rows[sec] else warp_share(
            stats["scanned"][sec], alive)
        parts.append(f"{name} {share:.3f} of {len(lay.pad[sec])} blocks a "
                     f"warp, {rows:.1f} rows and {blocks:.1f} block tests a "
                     f"lane")
    return f"  {tag}: " + "; ".join(parts)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", nargs="*", default=["book2", "book1"])
    ap.add_argument("--lanes", type=int, default=1 << 16)
    ap.add_argument("--calls", type=int, default=6)
    ap.add_argument("--cursor", type=int, default=None,
                    help="first item (default: the pool's items in the "
                         "middle rows of the image)")
    ap.add_argument("--cursor-step", type=int, default=0)
    ap.add_argument("--sorted", action="store_true",
                    help="also scan the rays in the lane coherence order")
    args = ap.parse_args()
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    for sc in args.scene:
        scene, cam = getattr(registry, sc)()
        npix = cam.width * cam.image_height
        cursor = args.cursor if args.cursor is not None \
            else max(npix // 2 - args.lanes // 2, 0)
        prims, st, ray, alive = bounce_rays(scene, cam, args.lanes,
                                            args.calls, cursor,
                                            args.cursor_step)
        ways = {"after": bounce.scan_layout(prims, st),
                "after, boxes in Morton order": bounce.scan_layout(
                    prims, st, box_order="morton"),
                "before": bounce.scan_layout(prims, st, sphere_order="decl")}
        counts = ways["after"].counts
        if counts[2] == 0:
            del ways["after, boxes in Morton order"]
        rays = {tag: (ray, alive) for tag in ways}
        if args.sorted:
            bounds = [torch.from_numpy(b)
                      for b in bounce.coherence_bounds(scene)]
            planes = list(ray) + [alive.to(torch.int32),
                                  torch.zeros_like(alive, dtype=torch.int32)]
            _, idx = torch.sort(regen.coherence_keys(planes, *bounds),
                                stable=True)
            tag = "after, lanes in coherence order"
            ways[tag] = ways["after"]
            rays[tag] = (tuple(x[idx] for x in ray), alive[idx])
        print(f"{sc}: {args.lanes} lanes, {args.calls} calls from item "
              f"{cursor} (step {args.cursor_step}), {alive.float().mean():.3f}"
              f" of the lanes in the last call's bounce; {counts[0]} spheres,"
              f" {counts[1]} quads, {counts[2]} boxes", flush=True)
        for tag, lay in ways.items():
            ray, alive = rays[tag]
            stats = {}
            bounce.closest_culled_ref(st, prims, *ray, layout=lay,
                                      stats=stats)
            if tag == "before":
                # the earlier scan culled the spheres alone
                for sec in (1, 2):
                    stats["blocks"][sec].zero_()
                    stats["rows"][sec].zero_()
                print(report(tag, lay, stats, alive, counts,
                             (0, counts[1], counts[2])), flush=True)
                # (its box test turned the ray per row, rotated or not)
                ops = bounce.scan_ops(lay, stats)[alive].mean().item() \
                    + counts[1] * bounce.SCAN_OPS["quad"] \
                    + counts[2] * bounce.SCAN_OPS["box_rot"]
            else:
                print(report(tag, lay, stats, alive, counts), flush=True)
                ops = bounce.scan_ops(lay, stats)[alive].mean().item()
            print(f"    scan operations a lane {ops:.0f} (brute force "
                  f"{bounce.brute_ops(lay)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
