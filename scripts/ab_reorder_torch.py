#!/usr/bin/env python3
"""A/B of the lane coherence sort (`render_regen(reorder=True)`) on the
card: the port's counterpart of scripts/ab_reorder.py, with the same cell
(book1 and book2 at 25 spp, cadence 4, 131,072 lanes) by default.

    python3 scripts/ab_reorder_torch.py [--scenes book1 book2] [--spp 25]
        [--cadence 4] [--lanes 131072] [--flagship] [--repeats 2]
        [--profile]

Every arm runs in a fresh process (a render timed after another in one
process, or after `torch.profiler`, runs slower), and renders twice there:
the first render pays the allocations and the kernels' loading, the second
is reported. The arms, in turns per scene: `queue_ik` unsorted (the JAX
script's unsorted arm, the default schedule), `queue` unsorted, and
`queue` sorted (reorder=True, the JAX script's other arm; the sort turns
the in-kernel queue off). `--flagship` renders the scenes at their
registry configuration instead (PERF.md §4: cornellBox, book1, book2 at
100 spp, their registry cadence) and drops the `queue_ik` arm;
`--repeats` runs the arms that many times in turns (plain order, then
reversed). One JSON line per run: scene, arm, loop seconds, rays/s,
segments, windows, occupancy, the card's name and power limit.
`--profile` renders a third time in the arm's process, after the timed
render, under torch.profiler, and adds K6's launches and device µs a call
there, the render's device µs and its busy share (device time over the
profiled loop; the profile slows the loop, so its loop time is not a
timing).
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARMS = {"queue_ik": dict(schedule="queue_ik"),
        "queue": dict(schedule="queue"),
        "queue_sorted": dict(schedule="queue", reorder=True)}


def one_arm(scene_name, arm, spp, cadence, lanes, profile=False):
    """Render `scene_name` twice with the arm's options; returns the second
    render's row (with `profile`, plus K6's device time a call in a third,
    profiled render)."""
    import torch

    sys.path.insert(0, ROOT)
    from go_raytracer_tpu_torch.integrator import regen
    from go_raytracer_tpu_torch.ops import bounce
    from go_raytracer_tpu_torch.scenes import registry

    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU: this script times the card")
    scene, cam = getattr(registry, scene_name)()
    if spp:
        cam.samples_per_pixel = spp
    kw = dict(ARMS[arm], n_lanes=lanes, cadence=cadence, seed=0)
    regen.render_regen(scene, cam, **kw)
    _, st = regen.render_regen(scene, cam, **kw)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    row = {"scene": scene_name, "arm": arm,
           "reorder": ARMS[arm].get("reorder", False),
           "schedule": st["schedule"], "spp": cam.samples_per_pixel,
           "cadence": cadence or cam.regen_cadence, "lanes": lanes,
           "loop_s": st["elapsed_s"], "rays_per_s": st["rays_per_s"],
           "segments": st["segments"], "windows": st["windows"],
           "occupancy": st["occupancy"], "device": st["device"],
           "card": card}
    if profile:
        row.update(profile_k6(regen, bounce, scene, cam, kw))
    return row


def profile_k6(regen, bounce, scene, cam, kw):
    """K6's launches and device µs a call in one render under
    torch.profiler, the render's device µs and busy share."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    bounce.launches_fused = 0
    with torch.profiler.profile(activities=acts) as prof:
        _, st = regen.render_regen(scene, cam, **kw)
    calls = bounce.launches_fused
    k6_us = total_us = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t <= 0 or "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        total_us += t
        if e.key.startswith(("bounce_fused_levels",
                             "void bounce_fused_levels<")):
            k6_us += t
    return {"k6_calls": calls,
            "k6_device_us_a_call": k6_us / calls if calls else None,
            "device_us": total_us,
            "device_busy": total_us / 1e6 / st["elapsed_s"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenes", nargs="*", default=None)
    ap.add_argument("--spp", type=int, default=25)
    ap.add_argument("--cadence", type=int, default=4)
    ap.add_argument("--lanes", type=int, default=1 << 17)
    ap.add_argument("--flagship", action="store_true")
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--arm", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    spp, cadence = (0, 0) if args.flagship else (args.spp, args.cadence)
    if args.arm:
        print(json.dumps(one_arm(args.scenes[0], args.arm, spp, cadence,
                                 args.lanes, args.profile)), flush=True)
        return 0
    scenes = args.scenes or (["cornell_box", "book1", "book2"]
                             if args.flagship else ["book1", "book2"])
    arms = [a for a in ARMS if not (args.flagship and a == "queue_ik")]
    rc = 0
    for sc in scenes:
        for rep in range(args.repeats):
            for arm in (arms if rep % 2 == 0 else arms[::-1]):
                cmd = [sys.executable, os.path.abspath(__file__), "--arm",
                       arm, "--scenes", sc, "--spp", str(args.spp),
                       "--cadence", str(args.cadence), "--lanes",
                       str(args.lanes)] + (["--flagship"] if args.flagship
                                           else []) \
                    + (["--profile"] if args.profile else [])
                out = subprocess.run(cmd, capture_output=True, text=True)
                if out.returncode != 0:
                    print(json.dumps({"scene": sc, "arm": arm,
                                      "error": out.stderr[-600:]}),
                          flush=True)
                    rc = 1
                    continue
                print(out.stdout.strip().splitlines()[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
