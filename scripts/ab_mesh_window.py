#!/usr/bin/env python3
"""The mesh window of two checkouts on one NVIDIA GPU, each run in a
fresh process: parent (P) against change (C).

    python3 scripts/ab_mesh_window.py [--parent DIR] [--out DIR]

With the parent unpacked into a git-ignored directory (`git archive
HEAD | tar -x -C build/parent`, the default), it runs, in this order:
the walk level's cost (`tune_mesh_kernels.py --kernels none --level`:
wall ms, device and host-issued launches and waits a level) P, C, C, P;
the uncut modelExample renders on the walk and on `binned2`
(`--uncut`) P, C, C, P each; the change's uncut walk at 131,072 and
65,536 lanes in turns (`--mesh-lanes`); each checkout's five routes at
25 spp (`--renders`) and its one-rank sharded 4-spp render
(`sharded_mesh_render.py`). Every render but the lane comparison runs
65,536 lanes, so that two checkouts with other lane caps render the same
images. Each process's lines of interest are printed
with its exit code and wall time; its whole output goes to --out
(default chiprun_out/m19).

    python3 scripts/ab_mesh_window.py --lanes [--out DIR]

times the change alone at 65,536 and 131,072 lanes in turns (65,536,
131,072, 131,072, 65,536), each in a fresh process: every route at 25
spp (`--renders`: binned, binned2, walk, `--b1-fused`, `--no-traverse8`;
`--more-renders`: the reference engine's bounce and `positional` on the
statue) and the uncut `binned2` render."""
import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=os.path.join("build", "parent"))
    ap.add_argument("--out", default=os.path.join("chiprun_out", "m19"))
    ap.add_argument("--lanes", action="store_true",
                    help="only the change's routes at both lane pools")
    args = ap.parse_args()
    P, C, out = args.parent, os.path.dirname(HERE), args.out
    os.makedirs(out, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)

    def run(tag, argv, timeout=900):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable] + argv, capture_output=True,
                           text=True, timeout=timeout)
        wall = time.perf_counter() - t0
        keep = [ln for ln in r.stdout.splitlines() if ln.startswith(
            ("render ", "level:", "SHARDED8", "package", "built"))]
        print(f"== {tag} rc {r.returncode} wall {wall:.1f} s", flush=True)
        for ln in keep:
            print("  " + ln[:3000], flush=True)
        if r.returncode:
            print(r.stdout[-3000:], r.stderr[-5000:], flush=True)
        with open(os.path.join(out, tag + ".log"), "w") as fh:
            fh.write(r.stdout + "\n---\n" + r.stderr)

    tune = os.path.join(HERE, "tune_mesh_kernels.py")
    name = lambda repo: "P" if repo == P else "C"

    def tuned(repo, *a):
        return [tune, "--repo", repo, "--kernels", "none", *a]

    if args.lanes:
        for k, lanes in enumerate((65536, 131072, 131072, 65536)):
            run(f"lanes_routes_{lanes}_{k}",
                tuned(C, "--renders", "--more-renders", "--uncut", "binned2",
                      "--mesh-lanes", str(lanes),
                      "--out", f"{out}/lanes_routes_{k}.json"), timeout=1200)
        return 0
    for k, repo in enumerate((P, C, C, P)):
        run(f"level_{k}_{name(repo)}",
            tuned(repo, "--level", "--out", f"{out}/level_{k}.json"))
    for route in ("walk", "binned2"):
        for k, repo in enumerate((P, C, C, P)):
            run(f"uncut_{route}_{k}_{name(repo)}",
                tuned(repo, "--uncut", route, "--mesh-lanes", "65536",
                      "--out", f"{out}/uncut_{route}_{k}.json"))
    for k, lanes in enumerate((131072, 65536, 131072, 65536)):
        run(f"lanes_{lanes}_{k}",
            tuned(C, "--uncut", "walk", "--mesh-lanes", str(lanes),
                  "--out", f"{out}/lanes_{k}.json"))
    for repo in (P, C):
        run(f"renders25_{name(repo)}",
            tuned(repo, "--renders", "--mesh-lanes", "65536",
                  "--out", f"{out}/renders25_{name(repo)}.json"),
            timeout=1200)
        run(f"sharded8_{name(repo)}",
            [os.path.join(HERE, "sharded_mesh_render.py"), repo, "65536"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
