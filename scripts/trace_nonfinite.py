#!/usr/bin/env python3
"""Find the path behind each non-finite pixel of a `queue_ik` render, on
one NVIDIA GPU.

    python3 scripts/trace_nonfinite.py [SCENE ...]

For each registry scene named (default: simple_light book1), at its
registry configuration and seed 0: render once, keeping the accumulator
and the window's records; list the items whose radiance is not finite;
for the first two, find the lane and level where each started, print its
records level by level up to the first non-finite one, then render again
to capture that kernel call's input state, and run that one level through
K1 (`bounce_fused_q`) and its plain version (`bounce_fused_q_ref`) on the
same inputs: the lane's input ray and both outputs are printed. A
non-finite value that the plain version gives too is the algorithm's, not
the kernel's. Needs a render of one window (both scenes are). Without a
GPU it exits non-zero.
"""

import os
import sys


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from go_raytracer_tpu_torch.integrator import regen
    from go_raytracer_tpu_torch.ops import bounce
    from go_raytracer_tpu_torch.scenes import registry

    dev = torch.device("cuda")
    real_q = bounce.bounce_fused_q
    real_h = regen.harvest_mod.harvest_levels_into
    real_a = regen._assemble_image
    for name in sys.argv[1:] or ["simple_light", "book1"]:
        scene, cam = getattr(registry, name)()
        keep = {}

        def spy_h(acc, Vr, Vg, Vb, FL, bases, **kw):
            keep["rec"] = [x.clone() for x in (Vr, Vg, Vb, FL)]
            keep["base"] = bases.clone()
            return real_h(acc, Vr, Vg, Vb, FL, bases, **kw)

        def spy_a(acc, **kw):
            keep["acc"] = acc.clone()
            return real_a(acc, **kw)

        regen.harvest_mod.harvest_levels_into, regen._assemble_image = \
            spy_h, spy_a
        try:
            _, st = regen.render_regen(scene, cam, seed=0, device=dev)
        finally:
            regen.harvest_mod.harvest_levels_into = real_h
            regen._assemble_image = real_a
        acc = keep["acc"][:st["paths"]]
        bad = torch.nonzero(~torch.isfinite(acc).all(1))[:, 0].tolist()
        print(f"{name}: {st['paths']} paths, {st['windows']} window(s), "
              f"{st['nonfinite']} non-finite pixel values; items with a "
              f"non-finite radiance: {bad[:10]}")
        if st["windows"] != 1:
            print(f"{name}: more than one window, not traced")
            continue
        Vr, Vg, Vb, FL = keep["rec"]
        base = keep["base"]
        S = FL.shape[0]
        item_of = base[:S, None].long() + (FL >> 3).long()
        for item in bad[:2]:
            s0, lane = torch.nonzero(((FL & 4) != 0)
                                     & (item_of == item))[0].tolist()
            level = None
            for s in range(s0, S):
                if s > s0 and int(FL[s, lane]) & 4:
                    break
                v = [float(r[s, lane]) for r in (Vr, Vg, Vb)]
                print(f"  item {item}, lane {lane}, level {s}: V {v}, "
                      f"flags {int(FL[s, lane]) & 7}")
                if not np.isfinite(v).all():
                    level = s
                    break
            if level is None:
                continue
            cap = {}

            def spy_q(tables, statics, cam_row, bg, seed4, *state, out=None,
                      **kw):
                if cap.setdefault("calls", 0) == level:
                    cap["args"] = (tables, statics, cam_row, bg,
                                   seed4.clone(), [x.clone() for x in state],
                                   kw)
                cap["calls"] += 1
                return real_q(tables, statics, cam_row, bg, seed4, *state,
                              out=out, **kw)

            bounce.bounce_fused_q = spy_q
            try:
                regen.render_regen(scene, cam, seed=0, device=dev)
            finally:
                bounce.bounce_fused_q = real_q
            tables, statics, cam_row, bg, seed4, state, kw = cap["args"]
            print(f"  call {level}: seed4 {seed4.tolist()}, the lane's input "
                  f"ray {[float(x[lane]) for x in state[:7]]}, alive "
                  f"{int(state[7][lane])}, depth {int(state[8][lane])}")
            n = state[0].shape[0]
            for label, fn in (("kernel", real_q),
                              ("plain", bounce.bounce_fused_q_ref)):
                o = bounce.FusedQOut.empty(n, kw["n_inner"], dev)
                fn(tables, statics, cam_row, bg, seed4,
                   *[x.clone() for x in state], out=o, **kw)
                print(f"  {label}: V {[float(r[0, lane]) for r in o.rec[:3]]}"
                      f", flags {int(o.rec[3][0, lane]) & 7}, new ray "
                      f"{[float(x[lane]) for x in o.state[:6]]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
