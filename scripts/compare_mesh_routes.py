#!/usr/bin/env python3
"""Where two closest-hit routes of the mesh path part over a whole render,
on one NVIDIA GPU.

    python3 scripts/compare_mesh_routes.py [--routes A B] [--spp N]
                                           [--out FILE]

Renders modelExample (`-S 8`, the registry configuration: 600x337, 250
spp = 225 strata, depth 50, 65,536 lanes; `--spp` cuts it) on route A
(default `walk`, the BVH8 walk) and route B (default `binned2`) and says
where they part, in three steps:

1. Is each route deterministic? Each renders twice; the two segment
   totals, per-window segment counts and images are compared.
2. The first differing level. A third render on route A hands the rays,
   caps and live lanes of every level of every window to route B too:
   every lane whose winner (t, idx) differs is counted as a tie (equal t:
   two triangles at one distance, each route keeping the first it meets)
   or not, and the first one is printed with both (t, idx).
3. Where the renders part. The per-window segment counts of A and B are
   compared; the first window that differs is run again on both routes
   from A's state at its start (saved in step 1, with the window's own
   random stream), and the first level whose records differ is printed:
   its refill (cursor, starts), the started lanes' ranks, the records
   (flags, V) and the first lane that differs.

A JSON summary goes to --out (default build/compare_mesh_routes.json,
git-ignored). Without a GPU it exits non-zero.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--routes", nargs=2, default=["walk", "binned2"])
    ap.add_argument("--spp", type=int, default=0,
                    help="cut the registry's 250 spp (0: uncut)")
    ap.add_argument("--out", default=os.path.join(
        "build", "compare_mesh_routes.json"))
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from go_raytracer_tpu_torch.integrator import regen
    from go_raytracer_tpu_torch.ops import trace
    from go_raytracer_tpu_torch.scenes import registry

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    scene, cam = registry.model_example()
    if args.spp:
        cam.samples_per_pixel = args.spp
    route_a, route_b = args.routes
    summary = {"card": card, "routes": args.routes,
               "spp": cam.samples_per_pixel}
    real_window = regen._mesh_window

    def render(route, record):
        """One render on `route`; `record` gets per window (input state,
        next item, kwargs, segments, levels)."""
        def spy(ctx, acc, state, next_item, gen, item_end, **kw):
            saved = ([s.clone() for s in state], int(next_item), kw)
            res = real_window(ctx, acc, state, next_item, gen, item_end,
                              **kw)
            # segments and levels recorded, from the window's device counts
            record.append(saved + tuple(res[1][1:].tolist()))
            return res
        regen._mesh_window = spy
        try:
            t0 = time.perf_counter()
            img, st = regen.render_regen(scene, cam, seed=0, device=dev,
                                         mesh=route)
            torch.cuda.synchronize()
        finally:
            regen._mesh_window = real_window
        return img, st, time.perf_counter() - t0

    # ---- step 1: each route twice ------------------------------------------
    runs = {}
    for route in (route_a, route_b):
        for k in range(2):
            rec = []
            img, st, wall = render(route, rec)
            runs[(route, k)] = (img, st, rec)
            print(f"[1] {route} run {k}: segments {st['segments']}, windows "
                  f"{st['windows']}, levels {sum(r[4] for r in rec)}, loop "
                  f"{st['elapsed_s']:.3f} s (wall {wall:.1f} s) on {card}")
        (i0, s0, r0), (i1, s1, r1) = runs[(route, 0)], runs[(route, 1)]
        same = (s0["segments"] == s1["segments"]
                and [r[3] for r in r0] == [r[3] for r in r1]
                and np.array_equal(i0, i1))
        summary[f"{route}_deterministic"] = same
        print(f"[1] {route}: the two runs "
              + ("are equal (segments, per-window segments, image)" if same
                 else f"DIFFER: segments {s0['segments']} / {s1['segments']}"
                 f", per window {[r[3] for r in r0]} / {[r[3] for r in r1]}"
                 f", image max abs diff {np.abs(i0 - i1).max()}"))
    sa, sb = runs[(route_a, 0)][1], runs[(route_b, 0)][1]
    summary["segments"] = {route_a: sa["segments"], route_b: sb["segments"]}
    print(f"[1] {route_a} against {route_b}: segments {sa['segments']} / "
          f"{sb['segments']} (rel {(sb['segments'] - sa['segments']) / sa['segments']:.3e})")

    # ---- step 2: route B fed route A's rays at every level ------------------
    real_mc = trace.mesh_closest
    parts = {"levels": 0, "lanes": 0, "ties": 0, "non_ties": 0,
             "first": None, "window": -1}
    kw_b = {"walk": dict(mesh="walk"), "binned2": dict(mesh="binned2"),
            "binned": dict(mesh="binned"),
            "walk+bvh2": dict(mesh="walk", traverse8=False)}[route_b]

    def mc_spy(ms_, o_, d_, t_cap=None, alive=None, **kw):
        t_a, i_a = real_mc(ms_, o_, d_, t_cap, alive, **kw)
        t_b, i_b = real_mc(ms_, o_, d_, t_cap, alive, **kw_b)
        diff = (i_b != i_a) | (t_b != t_a)
        tie = diff & (t_b == t_a)
        parts["ties"] += int(tie.sum())
        parts["non_ties"] += int((diff & ~tie).sum())
        parts["lanes"] += int(alive.sum())
        if parts["first"] is None and bool(diff.any()):
            k = int(torch.nonzero(diff)[0, 0])
            parts["first"] = (
                f"window {parts['window']}, level {parts['levels']} of the "
                f"render, lane {k}: {route_a} t {t_a[k].item():.9g} idx "
                f"{int(i_a[k])}, {route_b} t {t_b[k].item():.9g} idx "
                f"{int(i_b[k])} ({'tie' if bool(tie[k]) else 'not a tie'}); "
                f"cap {t_cap[k].item():.9g}")
        parts["levels"] += 1
        return t_a, i_a

    def window_count(ctx, *a, **kw):
        parts["window"] += 1
        # the spy reads the host at every level: no level is a CUDA graph
        ctx.graph = False
        return real_window(ctx, *a, **kw)

    trace.mesh_closest = mc_spy
    regen._mesh_window = window_count
    try:
        regen.render_regen(scene, cam, seed=0, device=dev, mesh=route_a)
        torch.cuda.synchronize()
    finally:
        trace.mesh_closest = real_mc
        regen._mesh_window = real_window
    summary["step2"] = parts
    print(f"[2] {route_b} fed {route_a}'s rays over the whole render "
          f"({parts['levels']} levels, {parts['lanes']} live lanes): "
          f"winners differ on {parts['ties']} ties and {parts['non_ties']} "
          f"non-ties; first: {parts['first']}")

    # ---- step 3: the first window whose segments differ ---------------------
    rec_a, rec_b = runs[(route_a, 0)][2], runs[(route_b, 0)][2]
    segs_a, segs_b = [r[3] for r in rec_a], [r[3] for r in rec_b]
    w = next((k for k, (x, y) in enumerate(zip(segs_a, segs_b)) if x != y),
             None)
    summary["step3"] = {"segs_" + route_a: segs_a, "segs_" + route_b: segs_b,
                        "first_window": w}
    print(f"[3] per-window segments {route_a} {segs_a}; {route_b} {segs_b}; "
          f"first differing window {w}")
    if w is not None:
        state_a, next_a, kw_a = rec_a[w][:3]
        state_b, next_b, _ = rec_b[w][:3]
        same_in = next_a == next_b and all(
            torch.equal(x, y) for x, y in zip(state_a, state_b))
        print(f"[3] window {w} starts from the same state on both routes: "
              f"{same_in} (next item {next_a} / {next_b})")
        # the accumulator is written only by the window's harvest: a
        # scratch one of the render's rows
        outs = {}
        for route in (route_a, route_b):
            ctx = regen.MeshContext.build(scene, cam, dev, mesh=route)
            bufs = regen.WindowBuffers.empty(state_a[0].shape[0],
                                             kw_a["window"], 1, dev)
            acc = torch.zeros((int(sa["paths"]) + state_a[0].shape[0], 3),
                              device=dev)
            _, cur, _ = real_window(
                ctx, acc, [s.clone() for s in state_a], next_a,
                regen.window_generator(0, w, dev), int(sa["paths"]),
                **dict(kw_a, bufs=bufs))
            res = cur.tolist()      # next item, segments, levels recorded
            outs[route] = (bufs, res)
            print(f"[3] window {w} again on {route}: segments {res[1]}, "
                  f"levels {res[2]}, next item {res[0]}")
        (ba, ra), (bb, rb) = outs[route_a], outs[route_b]
        levels = min(ra[2], rb[2])
        first = None
        for s in range(levels):
            if not (torch.equal(ba.base[s], bb.base[s])
                    and all(torch.equal(x[s], y[s])
                            for x, y in zip(ba.rec, bb.rec))):
                first = s
                break
        info = {"window": w, "first_level": first}
        if first is not None:
            s = first
            fa, fb = ba.rec[3][s], bb.rec[3][s]
            lanes = torch.nonzero((fa != fb)
                                  | (ba.rec[0][s] != bb.rec[0][s])
                                  | (ba.rec[1][s] != bb.rec[1][s])
                                  | (ba.rec[2][s] != bb.rec[2][s]))[:, 0]
            k = int(lanes[0]) if lanes.numel() else -1
            info.update(
                cursor=[int(ba.base[s, 0]), int(bb.base[s, 0])],
                starts=[int(((fa & 4) != 0).sum()), int(((fb & 4) != 0).sum())],
                lanes_differing=int(lanes.numel()),
                ranks_differ=bool(((fa >> 3) != (fb >> 3)).any()),
                flags_differ=int(((fa & 7) != (fb & 7)).sum()))
            if k >= 0:
                info["first_lane"] = {
                    "lane": k, "flags": [int(fa[k]), int(fb[k])],
                    "V": [[float(r[s, k]) for r in ba.rec[:3]],
                          [float(r[s, k]) for r in bb.rec[:3]]]}
        summary["step3"].update(info)
        print(f"[3] window {w}: first level whose refill or records differ: "
              f"{json.dumps(info)}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(summary, fh, indent=1, default=str)
    print(json.dumps({k: v for k, v in summary.items()
                      if k not in ("step3",)}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
