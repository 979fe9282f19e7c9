#!/usr/bin/env python3
"""Where the port's gradient step spends its time, on one NVIDIA GPU.

    python3 scripts/profile_grad.py [--scene NAME ...] [--width 128]
                                    [--spp 16] [--depth 10] [--reps 3]
                                    [--camera] [--indexing] [--out FILE]

Each scene (default cornell_box; also book3, cornell_smoke) renders at
GRAD.md's configuration (128x128 @ 16 spp, depth 10: 262,144 rays) through
`wavefront.radiance` (mode "scan", backend "xla") with every
`parallel/mesh.extract_params` leaf requiring a gradient (and, with
--camera, the camera origin), then `backward()`. Per scene it prints the
forward's and the backward's wall ms (between synchronizes; `--reps`
runs, the first a warm-up) and the backward's device time by kernel
under torch.profiler (the top 12), with the peak memory above what was
allocated before the first run.

--indexing gathers the parameter tables as `table[idx]` (whose backward
is a sorted accumulation that runs each row's contributions one after
another) instead of `sampling.param_rows`' `index_select` (an atomic
scatter-add), to compare the two in one call. JSON to --out (default
build/profile_grad.json). Without a GPU it exits non-zero.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", nargs="+", default=["cornell_box"])
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--camera", action="store_true")
    ap.add_argument("--indexing", action="store_true")
    ap.add_argument("--out", default="build/profile_grad.json")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_grad.py needs a GPU", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from go_raytracer_tpu_torch.integrator import sampling, wavefront
    from go_raytracer_tpu_torch.ops import trace
    from go_raytracer_tpu_torch.parallel import mesh as pmesh
    from go_raytracer_tpu_torch.render import camera as camera_mod
    from go_raytracer_tpu_torch.scenes import registry

    if args.indexing:
        sampling.param_rows = lambda table, idx: table[idx]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rows = []
    for name in args.scene:
        scene, cam = getattr(registry, name)()
        cam.width, cam.aspect_ratio = args.width, 1.0
        cam.samples_per_pixel, cam.max_depth = args.spp, args.depth
        arrays = cam.derived()
        npix = args.width * cam.image_height
        sq = cam.spp_sqrt
        ids = torch.arange(npix, device=dev).repeat(sq * sq)
        st = torch.arange(sq * sq, device=dev).repeat_interleave(npix)
        s_i = torch.div(st, sq, rounding_mode="floor").float()
        s_j = (st % sq).float()
        ds = trace.to_device(scene, dev)
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in pmesh.extract_params(ds).items()}
        delta = torch.zeros(3, device=dev, requires_grad=args.camera)
        c0 = torch.from_numpy(arrays.center).to(dev)
        p0 = torch.from_numpy(arrays.pixel00).to(dev)

        def forward():
            g = torch.Generator(device=dev).manual_seed(5)
            u = torch.rand((ids.shape[0], camera_mod.N_U_RAYGEN),
                           generator=g, device=dev)
            arr = dataclasses.replace(arrays, center=c0 + delta,
                                      pixel00=p0 + delta)
            o, d, t = camera_mod.generate_rays(arr, args.width, ids, s_i,
                                               s_j, u)
            L, stt = wavefront.radiance(pmesh.apply_params(ds, params), o,
                                        d, t, g, args.depth,
                                        cam.max_contribution)
            return torch.nan_to_num(L).mean(), stt["segments"]

        fwd_ms, bwd_ms = [], []
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for _ in range(args.reps):
            for v in params.values():
                v.grad = None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, segs = forward()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss.backward()
            torch.cuda.synchronize()
            fwd_ms.append((t1 - t0) * 1e3)
            bwd_ms.append((time.perf_counter() - t1) * 1e3)
        peak = torch.cuda.max_memory_allocated() - base
        loss, _ = forward()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            loss.backward()
            torch.cuda.synchronize()
        kernels = {}
        launches = 0
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0))
            if t > 0 and "CUDA" in str(getattr(e, "device_type", "")):
                kernels[e.key] = (t / 1e3, e.count)
                launches += e.count
        dev_ms = sum(t for t, _ in kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
        row = dict(scene=name, card=card, gather="table[idx]"
                   if args.indexing else "index_select", camera=args.camera,
                   rays=int(ids.shape[0]), fwd_segments=segs,
                   forward_ms=fwd_ms, backward_ms=bwd_ms,
                   backward_device_ms=dev_ms, backward_launches=launches,
                   peak_bytes=peak,
                   top=[dict(kernel=k[:120], ms=t, count=c)
                        for k, (t, c) in top])
        rows.append(row)
        print(f"{name} on {card}, gathers {row['gather']}, camera "
              f"{args.camera}: forward {[round(x, 2) for x in fwd_ms]} ms, "
              f"backward {[round(x, 2) for x in bwd_ms]} ms, backward "
              f"device {dev_ms:.2f} ms over {launches} launches, peak "
              f"{peak / 2**30:.3f} GiB", flush=True)
        for r in row["top"]:
            print(f"  {r['ms']:9.3f} ms  x{r['count']:5d}  {r['kernel']}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(rows, fh, indent=1)
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
