#!/usr/bin/env python3
"""Render dense registry scenes through the port's CLI on one NVIDIA GPU
and report, per scene and schedule, what the render did and how long its
window loop took, so that two checkouts compare in one call.

    python3 scripts/time_renders.py [--repo DIR] [--scene NAME ...]
                                    [--schedule NAME ...] [--reps N]
                                    [--spp N] [--out FILE]

Each scene (default: simple_light, cornell_box; also book1, book2, book3,
quads_scene, cornell_smoke) renders at its registry
configuration (`python -m go_raytracer_tpu_torch -S n --stats`) under each
schedule (default: queue_ik, queue, positional; `wavefront` is the
reference engine, `--integrator wavefront`, whose bounce is K3 `bounce`),
`--reps` times (default 2; the first run of a process carries its
warm-up); `--spp N` cuts the samples per pixel. Per run it prints the
window loop's seconds (`elapsed_s`), paths, segments, windows (levels on
the wavefront integrator), the kernels' launches (K1 `bounce_fused_q` is
one call per window level group, K6 `bounce_fused`, K8
`bounce_fused_pos`, K3 `bounce`), and the image's SHA-256 and channel
means: two checkouts whose kernels compute the same thing bit for bit
render the same image with the same launches.

--repo DIR imports the package from another checkout (the parent commit,
unpacked with `git archive` into a git-ignored directory such as
build/parent): run parent, change, change, parent in one call. JSON to
--out (default build/time_renders.json). Without a GPU it exits
non-zero.
"""

import argparse
import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys

SCENE_NUMBERS = {"book1": 1, "book2": 2, "book3": 3, "simple_light": 4,
                 "quads_scene": 5, "cornell_box": 6, "cornell_smoke": 7}
SCHEDULE_FLAGS = {"queue_ik": [], "queue": ["--schedule", "queue"],
                  "positional": ["--schedule", "positional"],
                  "wavefront": ["--integrator", "wavefront"]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose package renders")
    ap.add_argument("--scene", nargs="*", default=["simple_light",
                                                   "cornell_box"],
                    choices=sorted(SCENE_NUMBERS))
    ap.add_argument("--schedule", nargs="*",
                    default=["queue_ik", "queue", "positional"],
                    choices=sorted(SCHEDULE_FLAGS))
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--spp", type=int, default=None,
                    help="samples per pixel in place of the registry's")
    ap.add_argument("--out", default=os.path.join("build",
                                                  "time_renders.json"))
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.repo))
    from go_raytracer_tpu_torch import cli
    from go_raytracer_tpu_torch.ops import bounce

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    img_dir = os.path.join(os.path.dirname(os.path.abspath(args.out)),
                           "time_renders")
    os.makedirs(img_dir, exist_ok=True)
    results = {"repo": os.path.abspath(args.repo), "card": card, "runs": []}
    for sc in args.scene:
        for sched in args.schedule:
            for rep in range(args.reps):
                bounce.launches = bounce.launches_fused = 0
                bounce.launches_fused_pos = bounce.launches_bounce = 0
                image = os.path.join(img_dir, f"{sc}_{sched}.ppm")
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    rc = cli.main(["-S", str(SCENE_NUMBERS[sc]), "-o", image,
                                   "--stats", "--quiet",
                                   *SCHEDULE_FLAGS[sched], *(
                                       ["--spp", str(args.spp)]
                                       if args.spp else [])])
                if rc != 0:
                    print(f"{sc} {sched}: the CLI returned {rc}",
                          file=sys.stderr)
                    return 1
                st = json.loads(buf.getvalue().strip().splitlines()[-1])
                with open(image, "rb") as fh:
                    raw = fh.read()
                tok = raw.split()
                w, h = int(tok[1]), int(tok[2])
                px = np.array(tok[4:4 + 3 * w * h], np.float64).reshape(-1, 3)
                run = dict(scene=sc, schedule=sched, rep=rep,
                           elapsed_s=st["elapsed_s"], paths=st["paths"],
                           segments=st["segments"],
                           windows=st.get("windows", st.get("levels")),
                           nonfinite=st["nonfinite"],
                           k1_calls=bounce.launches,
                           k6_calls=bounce.launches_fused,
                           k8_calls=bounce.launches_fused_pos,
                           k3_calls=bounce.launches_bounce,
                           image_sha256=hashlib.sha256(raw).hexdigest(),
                           means=px.mean(0).tolist())
                results["runs"].append(run)
                print(f"{sc} {sched} run {rep}: loop {run['elapsed_s']} s, "
                      f"paths {run['paths']}, segments {run['segments']}, "
                      f"windows {run['windows']}, K1 calls {run['k1_calls']},"
                      f" K6 calls {run['k6_calls']}, K8 calls "
                      f"{run['k8_calls']}, K3 calls {run['k3_calls']}, image {run['image_sha256'][:16]}, "
                      f"means {np.round(run['means'], 4).tolist()}; {card}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
