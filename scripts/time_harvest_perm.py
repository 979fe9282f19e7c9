#!/usr/bin/env python3
"""Time K7's unwinding entry `grt_harvest_rows_perm` beside K7 on the same
records, on the first sorted `queue` window of cornellBox, book1 and book2
at 131,072 lanes (chip_smoke.py phase 29 (b)'s windows), on one NVIDIA
GPU.

    python3 scripts/time_harvest_perm.py [--repo DIR] [--out FILE]

The windows are recorded with this checkout's `chip_smoke.sorted_window`
through the package of --repo (default: this checkout), so the parent
commit, unpacked with `git archive` into a git-ignored directory, times
its kernels on the same records: run parent, change, change, parent in
one call, each in a fresh process. For each scene it prints the entry's
and K7's ms a window (CUDA events around 10 calls, the least of three
batches; entry, K7, K7, entry) and a SHA-256 of each one's output up to
the window's last started item, so checkouts that agree bit for bit print
the same digests. One JSON line per run is appended to --out (default
build/time_harvest_perm.jsonl, git-ignored). Without a GPU it exits
non-zero.
"""

import argparse
import hashlib
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=ROOT)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "build", "time_harvest_perm.jsonl"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    sys.path.insert(0, os.path.abspath(args.repo))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from go_raytracer_tpu_torch.ops import _cuda, harvest

    _cuda.build_all()
    dev = torch.device("cuda")
    run = {"repo": os.path.abspath(args.repo), "card": smoke.nvidia_smi_line(),
           "kernel": [ln for ln in _cuda.ptxas_report("harvest_rows")
                      if ln.startswith("harvest_rows")], "scenes": {}}
    for sc in smoke.REORDER_SCENES:
        w = smoke.sorted_window(dev, sc, smoke.REORDER_LANES)
        rec, bufs, q = w["rec"], w["bufs"], w["paths"]
        out = {tag: torch.full_like(w["acc"], float("nan"))
               for tag in ("entry", "k7")}
        ms = {"entry": [], "k7": []}
        for tag in ("entry", "k7", "k7", "entry"):
            perms = bufs.perm if tag == "entry" else None
            ms[tag].append(smoke.time_ms(
                lambda: harvest.reverse_harvest_into(
                    out[tag], *rec, bufs.sts, bufs.nis, item_base=0,
                    perms=perms, **w["hkw"]), 10))
        run["scenes"][sc] = dict(
            outer=w["outer"], cadence=w["hkw"]["cadence"], rows=w["rows"],
            paths=q, ms=ms, sha256={
                tag: hashlib.sha256(a[:q].cpu().numpy().tobytes()).hexdigest()
                for tag, a in out.items()})
        print(sc, json.dumps(run["scenes"][sc]), flush=True)
        del w, rec, bufs, out
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "a") as fh:
        fh.write(json.dumps(run) + "\n")
    print(json.dumps(run))


if __name__ == "__main__":
    main()
