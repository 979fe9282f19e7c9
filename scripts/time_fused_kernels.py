#!/usr/bin/env python3
"""Time the bounce kernels K1 `bounce_fused_q`, K9
`bounce_fused_q_direct`, K6 `bounce_fused`, K8 `bounce_fused_pos` and K3
`bounce` (dense mode, one level) on one NVIDIA GPU at the flagships' shapes
(131,072 lanes, the scene's cadence, an aged pool), and split a call's
time into the host's and the device's.

    python3 scripts/time_fused_kernels.py [--repo DIR] [--scene NAME ...]
                                          [--out FILE]

For each scene (default: cornell_box, book3, cornell_smoke, simple_light,
book1, quads_scene, book2; also scan_spheres and scan_quads, the synthetic
scan scene's two mixes of chip_smoke.py phase 23 under a camera over its
floor; a scene the checkout's kernels do not take is skipped, and K9 on a
scene with image textures, which it refuses), at its registry width,
height, cadence and defocus, and kernel it prints (K3 on the rays of K1's
aged pool, from fixed uniforms, and K3cam on chip_smoke.py phase 25's
pool: camera rays through random pixels, a tenth of the lanes dead; where
the checkout has it, K3 through a launch prepared once, `K3Launch`):

* ms per call between two CUDA events around 20 calls, the least of three
  batches (what chip_smoke.py reports);
* host us per call: the wall time of 40 calls enqueued back to back,
  before the synchronize (under the launch queue's depth, so the host
  never waits for the device); when it is near the per-call time above,
  the call is host-bound;
* device us per call: the kernel's launches in a torch.profiler trace of
  20 calls, summed, over 20.

--repo DIR imports the package from another checkout (the parent commit,
unpacked with `git archive` into a git-ignored directory) and times its
kernels the same way, so two commits compare in one call: parent, change,
change, parent. The results go to --out as JSON (default
build/time_fused_kernels.json, git-ignored). Without a GPU it exits
non-zero.

--save FILE keeps each kernel's input planes (its aged pool) and its
outputs of one call on them (records, counts and lane state; the calls
are deterministic), and --compare FILE runs each kernel once more on the
inputs another checkout saved and holds the outputs against that
checkout's: per scene and kernel, the planes that differ, their
differing elements and largest difference. Two checkouts whose kernels
compute the same thing bit for bit show none.
Where the kernel reports it (`_cuda.kernel_info`), each kernel's
registers, staged shared bytes and resident blocks per SM are printed.
"""

import argparse
import json
import os
import subprocess
import sys
import time

# the kernels' names in a profile, per wrapper
DEVICE_NAMES = {"K1": ("fused_q_level", "count_dead"),
                "K9": ("fused_q_level", "count_dead"),
                "K6": ("bounce_fused_levels",),
                "K8": ("bounce_fused_pos_levels",),
                "K3": ("bounce_level",), "K3cam": ("bounce_level",)}
# the synthetic scan scene's mixes (spheres, quads, boxes), and the camera
# the timings look at its 24 x 24 floor with
SYNTH = {"scan_spheres": (3500, 300, 296), "scan_quads": (200, 1800, 2096)}
SYNTH_CAMERA = dict(aspect_ratio=1.0, width=400, samples_per_pixel=16,
                    max_depth=50, vertical_fov=60.0, regen_cadence=1,
                    background=(0.5, 0.6, 0.7))


def synth_scene(name):
    """(scene, camera, packed tables with the inactive rows cleared,
    statics) of a scan mix, its camera 18 units off the floor's middle."""
    from go_raytracer_tpu_torch.render.camera import Camera
    from go_raytracer_tpu_torch.scenes import synthetic

    scene, _, tabs, st = synthetic.build(*SYNTH[name], dielectric=False)
    cam = Camera(**SYNTH_CAMERA)
    cam.position((0.0, 10.0, 18.0), (0.0, 0.5, 0.0), (0, 1, 0))
    return scene, cam, tabs, st


def time_ms(fn, reps):
    """Milliseconds per call between two CUDA events around `reps` calls,
    after one warm-up call; the least of three batches."""
    import torch
    fn()
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1) / reps)
    return best


def host_us(fn, reps=40):
    """Host microseconds per call, enqueueing `reps` calls back to back
    (the least of three batches)."""
    import torch
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, (time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    return best


def device_us(fn, names, reps=20):
    """Device microseconds per call of the kernels `names` under
    torch.profiler; None when the profiler records no device time."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0 and any(e.key.startswith(nm) or e.key.startswith(
                "void " + nm + "<") for nm in names):
            total += t
    return total / reps if total > 0 else None


def compare_planes(mine, theirs):
    """[(plane, differing elements, largest difference, elements beyond
    rtol = atol = 2e-3, differing elements where theirs is NaN)] of two
    lists of output planes, NaN equal to NaN."""
    import torch
    diffs = []
    for i, (a, b) in enumerate(zip(mine, theirs)):
        if a.shape != b.shape or a.dtype != b.dtype:
            diffs.append((i, "shape or type", None, None, None))
            continue
        ne = (a != b) & ~(torch.isnan(a) & torch.isnan(b)) \
            if a.is_floating_point() else a != b
        if ne.any():
            d = (a[ne].double() - b[ne].double()).abs()
            far = int((~torch.isclose(a.double(), b.double(), rtol=2e-3,
                                      atol=2e-3, equal_nan=True)).sum())
            theirs_nan = int((ne & torch.isnan(b)).sum()) \
                if b.is_floating_point() else 0
            diffs.append((i, int(ne.sum()),
                          float(d.nan_to_num(float("inf")).max()), far,
                          theirs_nan))
    return diffs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose package is timed")
    ap.add_argument("--scene", nargs="*",
                    default=["cornell_box", "book3", "cornell_smoke",
                             "simple_light", "book1", "quads_scene",
                             "book2"])
    ap.add_argument("--kernels", nargs="*",
                    default=["K1", "K9", "K6", "K8", "K3", "K3cam"])
    ap.add_argument("--out", default=os.path.join("build",
                                                  "time_fused_kernels.json"))
    ap.add_argument("--save", help="file for the kernels' outputs")
    ap.add_argument("--compare", help="outputs saved by another run")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.repo))
    from go_raytracer_tpu_torch.integrator import regen
    from go_raytracer_tpu_torch.ops import _cuda, bounce
    from go_raytracer_tpu_torch.scenes import registry

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    _cuda.build_all()
    for name in ("bounce_fused_q", "bounce_fused", "bounce_fused_pos"):
        print(f"{name}.cu: " + " | ".join(_cuda.ptxas_report(name)))
    dev = torch.device("cuda")
    n = 1 << 17
    results = {"repo": os.path.abspath(args.repo), "card": card,
               "scenes": {}}
    saved = {}
    other = torch.load(args.compare) if args.compare else {}
    libs = {"K1": "bounce_fused_q", "K9": "bounce_fused_q",
            "K6": "bounce_fused", "K8": "bounce_fused_pos", "K3": "bounce",
            "K3cam": "bounce"}
    for sc in args.scene:
        if sc in SYNTH:
            scene, cam, packed, st = synth_scene(sc)
        else:
            scene, cam = getattr(registry, sc)()
            packed, st = bounce.pack_scene(scene), bounce.scene_statics(scene)
        if not bounce.supported(scene):
            print(f"{sc}: outside this checkout's kernels, skipped")
            continue
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        tab = tuple(to(t) for t in packed)
        # the section sizes the kernels launch with: the scan table's rows
        # where the checkout has one
        counts = (bounce.scan_tables(tab[0], st)[0].counts
                  if hasattr(bounce, "scan_tables")
                  else (st["n_sph"], st["n_quad"], st["n_box"]))
        row = to(bounce.pack_camera(cam.derived()))
        bg = to(np.asarray(scene.background, np.float32))
        cad, sq = cam.regen_cadence, cam.spp_sqrt
        width, dfc = cam.width, cam.defocus_angle > 0
        npix = width * cam.image_height
        qkw = dict(has_defocus=dfc, max_depth=cam.max_depth, n_inner=cad,
                   width=width, sqrt_spp=sq, npix=npix)
        seed4 = torch.tensor([7, cad, 0, npix * sq * sq], dtype=torch.int32,
                             device=dev)
        out = bounce.FusedQOut.empty(n, cad, dev)
        state = regen._init_state(n, dev)
        for _ in range(8):      # age the pool with a deep queue
            bounce.bounce_fused_q(tab, st, row, bg, seed4, *state, out=out,
                                  **qkw)
            state = [s.clone() for s in out.state]
        bufs = regen.WindowBuffers.empty(n, 2, cad, dev).rec
        base = torch.zeros(1, dtype=torch.int32, device=dev)
        refill = regen.queue_refill_planes(
            torch.tensor(0, device=dev), state[7], npix * sq * sq,
            width=width, npix=npix, sqrt_spp=sq)
        fout = bounce.FusedOut.empty(n, cad, dev)
        seed1 = torch.tensor([11], dtype=torch.int32, device=dev)
        quota, lane_base, _, _ = regen.pos_tables(npix, sq * sq, n)
        pstate = regen._init_state_pos(n, dev, quota, lane_base, sq * sq,
                                       width)
        pout = bounce.FusedOut.empty(n, cad, dev, positional=True)
        seed2 = torch.tensor([13, cad], dtype=torch.int32, device=dev)
        # K3 on the pool's rays, its uniforms fixed
        k3_in = [torch.stack(state[:3], 1).contiguous(),
                 torch.stack(state[3:6], 1).contiguous(), state[6],
                 state[7] > 0, torch.rand(
                     (n, bounce.N_U + st["n_media"]), device=dev,
                     generator=torch.Generator(dev).manual_seed(3))]
        k3_out = bounce.bounce_out(n, dev)
        # phase 25's pool: camera rays through random pixels, a tenth dead
        from go_raytracer_tpu_torch.render import camera as camera_mod
        g25 = torch.Generator(device=dev).manual_seed(25)
        pid = torch.randint(0, npix, (n,), generator=g25, device=dev)
        s0 = torch.zeros(n, device=dev)
        c_o, c_d, c_t = camera_mod.generate_rays(
            cam.derived(), width, pid, s0, s0, torch.rand(
                (n, camera_mod.N_U_RAYGEN), generator=g25, device=dev))
        k3c_in = [c_o.contiguous(), c_d.contiguous(), c_t.contiguous(),
                  torch.rand(n, generator=g25, device=dev) > 0.1,
                  torch.rand((n, bounce.N_U + st["n_media"]), generator=g25,
                             device=dev)]
        k3c_out = bounce.bounce_out(n, dev)
        if hasattr(bounce, "K3Launch"):     # prepared once for the scene
            k3 = bounce.K3Launch(tab, st, bg)
            k3_call = lambda s, o_: k3(*s, out=o_)
        else:
            k3_call = lambda s, o_: bounce.bounce(tab, st, *s, bg, out=o_)
        # each kernel as a function of its input planes, and its outputs
        runs = {
            "K1": (state, lambda s: bounce.bounce_fused_q(
                tab, st, row, bg, seed4, *s, out=out, **qkw)),
            "K9": (state, lambda s: bounce.bounce_fused_q_direct(
                tab, st, row, bg, seed4, base, bufs, *s, out=out, **qkw)),
            "K6": (list(state) + list(refill), lambda s: bounce.bounce_fused(
                tab, st, row, bg, seed1, *s, out=fout, has_defocus=dfc,
                max_depth=cam.max_depth, n_inner=cad)),
            "K8": (pstate, lambda s: bounce.bounce_fused_pos(
                tab, st, row, bg, seed2, *s, out=pout, has_defocus=dfc,
                max_depth=cam.max_depth, n_inner=cad, width=width,
                sqrt_spp=sq)),
            "K3": (k3_in, lambda s: k3_call(s, k3_out)),
            "K3cam": (k3c_in, lambda s: k3_call(s, k3c_out))}
        outputs = {
            "K1": lambda: list(out.rec) + [out.seg, out.take, out.base,
                                           out.cursor] + list(out.state),
            "K9": lambda: [b[:cad] for b in bufs] + [out.seg, out.take]
            + list(out.state),
            "K6": lambda: list(fout.rec) + [fout.seg] + list(fout.state),
            "K8": lambda: list(pout.rec) + [pout.seg] + list(pout.state),
            "K3": lambda: list(k3_out), "K3cam": lambda: list(k3c_out)}

        def run_on(k, inputs):
            """The outputs of one call of kernel k on these inputs (K3's
            buffers zeroed first: it writes no dead lane's ray)."""
            if libs[k] == "bounce":
                for t in (k3c_out if k == "K3cam" else k3_out):
                    t.zero_()
            runs[k][1]([x.to(dev) for x in inputs])
            torch.cuda.synchronize()
            return [t.detach().cpu().clone() for t in outputs[k]()]

        if scene.has_image:
            del runs["K9"]
        runs = {k: v for k, v in runs.items() if k in args.kernels}
        res = {}
        for k, (inputs, fn) in runs.items():
            call = lambda: fn(inputs)
            res[k] = dict(ms=time_ms(call, 20), host_us=host_us(call),
                          device_us=device_us(call, DEVICE_NAMES[k]))
            if hasattr(_cuda, "kernel_info"):
                res[k]["info"] = _cuda.kernel_info(
                    libs[k], bounce.fused_features(st), *counts)
            lv = 1 if libs[k] == "bounce" else cad
            print(f"{sc} {k} ({lv} levels, {n} lanes): {res[k]['ms']:.4f} ms "
                  f"per call, host {res[k]['host_us']:.1f} us, device "
                  f"{res[k]['device_us']} us; {res[k].get('info', '')}; "
                  f"{card}")
            key = f"{sc}/{k}"
            saved[key] = dict(inputs=[x.cpu().clone() for x in inputs],
                              outputs=run_on(k, inputs))
            if key in other:
                diffs = compare_planes(run_on(k, other[key]["inputs"]),
                                       other[key]["outputs"])
                results.setdefault("compare", {})[key] = diffs
                print(f"{key} on the inputs of {args.compare}: "
                      + ("bit for bit" if not diffs else "; ".join(
                          f"plane {i}: {c} elements differ ({nn} where "
                          f"theirs is NaN), largest {m}, {f} beyond 2e-3"
                          for i, c, m, f, nn in diffs)))
        results["scenes"][sc] = res
    if args.save:
        torch.save(saved, args.save)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
