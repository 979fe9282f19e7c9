#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is swallowed):
  1. environment: torch / CUDA versions, the card's name and power limit,
     and the build of every CUDA kernel from csrc/ (one nvcc each, in
     parallel);
  2. K1 `bounce_fused_q` against its plain PyTorch version on the card
     (cornellBox tables, 131072 lanes = 512 blocks as in the flagship, 8
     levels, a mixed alive/depth state), and every level's starts taking
     the items base .. base+take-1 once each;
  3. K2 `harvest_levels_into` against its plain version on K1's records;
  4. exact accounting through the kernels (quad-only scene, background 1:
     image exactly 1; a multi-window render chaining the queue cursor),
     and a small cornellBox render on the kernels against the same render
     on the plain versions;
  5. the flagship through `go_raytracer_tpu_torch.cli.main`: cornellBox
     600x600, 100 spp, depth 50, 1<<17 lanes, launch counts read around
     it;
  6. per-kernel timings at the flagship's shapes (CUDA events), with one
     flagship window's starts checked item by item over all its levels
     and K2 held against its plain version on that window;
then the `kernels` JSON line, the nvidia-smi line, and the final
{"ok": true, "device": ...} line.

Without CUDA, or outside the repository, it exits non-zero and prints no
result.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import time

# peak rates of one H100 SXM (NVIDIA data sheet): HBM3 and float32 outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float operations per traced segment of bounce_fused_q on cornellBox,
# counted from csrc/bounce_fused_q.cu: 6 quads x ~38, 2 rotated boxes x
# ~50, shading + light sample + pdf ~150 (the 14 hashes are integer work)
K1_OPS_PER_SEGMENT = 480
# plain-vs-kernel tolerances (module docstrings of ops/bounce.py and
# csrc/bounce_fused_q.cu: FMA contraction, rsqrtf and __sincosf differ
# from the plain ops by ~1e-6 relative, and a lane grazing an edge may
# branch the other way)
K1_RTOL = K1_ATOL = 2e-3
K1_MISMATCH_FRAC = 2e-3


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps, warmup=1):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def started_ranks_are_a_prefix(fl, take):
    """Per level, the started lanes' ranks (FL bits 3..) are exactly
    0 .. take-1: no item is skipped or given to two lanes."""
    import torch
    s, n = fl.shape
    started = (fl & 4) != 0
    lvl = torch.arange(s, device=fl.device)[:, None].expand(s, n)[started]
    hits = torch.zeros(s * n, dtype=torch.int32, device=fl.device)
    hits.index_add_(0, lvl * n + (fl[started] >> 3).long(),
                    torch.ones_like(lvl, dtype=torch.int32))
    want = torch.arange(n, device=fl.device)[None, :] < take[:, None]
    return torch.equal(hits.view(s, n), want.to(torch.int32))


def cornell_inputs(dev, n, seed=0):
    """cornellBox tables and a mixed lane state at the flagship's camera."""
    import numpy as np
    import torch
    from go_raytracer_tpu_torch.ops import bounce
    from go_raytracer_tpu_torch.scenes import registry

    scene, cam = registry.cornell_box()
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    tables = tuple(to(t) for t in bounce.pack_scene(scene))
    statics = bounce.scene_statics(scene)
    cam_row = to(bounce.pack_camera(cam.derived()))
    bg = to(np.asarray(scene.background, np.float32))
    rs = np.random.default_rng(seed)
    o = rs.uniform(50, 500, (n, 3)).astype(np.float32)
    d = (rs.normal(size=(n, 3)) * 300).astype(np.float32)
    state = [to(o[:, 0]), to(o[:, 1]), to(o[:, 2]), to(d[:, 0]),
             to(d[:, 1]), to(d[:, 2]),
             to(rs.uniform(0, 1, n).astype(np.float32)),
             to((rs.uniform(size=n) < 0.6).astype(np.int32)),
             to(rs.integers(0, 50, n).astype(np.int32))]
    return scene, cam, tables, statics, cam_row, bg, state


def main():
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"needs torch and numpy: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from go_raytracer_tpu_torch import cli
        from go_raytracer_tpu_torch.integrator import regen
        from go_raytracer_tpu_torch.ops import _cuda, bounce, harvest
        from go_raytracer_tpu_torch.render.camera import Camera
        from go_raytracer_tpu_torch.scene.builder import SceneBuilder
    except ImportError as e:
        fail(f"run from the repository root ({e})")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi_line()

    # ---- 1. environment and build --------------------------------------
    print(f"[1] python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}"
          f"  ({card})")
    t0 = time.perf_counter()
    libs = _cuda.build_all()
    print(f"[1] kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc wall {_cuda.build_seconds}): "
          + ", ".join(os.path.basename(p) for p in libs.values()))
    for p in libs.values():
        log = p[:-3] + ".log"
        if os.path.exists(log):
            with open(log) as fh:
                regs = [l.strip() for l in fh if "registers" in l
                        or "spill" in l]
            print(f"[1] {os.path.basename(log)}: " + " | ".join(regs))

    # ---- 2. K1 against its plain version -------------------------------
    # (a) starts at level 0 only: every lane's path is then its own, and
    #     per-lane mismatches stay local;
    # (b) refill at every level: one lane that branches the other way
    #     shifts the items of every later dead lane in flat order, so only
    #     the counts, the cursor chain and level 0 are compared per lane.
    n, n_inner = 1 << 17, 8
    scene, cam, tables, statics, cam_row, bg, state = cornell_inputs(dev, n)
    npix, sqrt_spp, width = 600 * 600, 10, 600
    kw = dict(has_defocus=False, max_depth=50, n_inner=n_inner, width=width,
              sqrt_spp=sqrt_spp, npix=npix)

    def k1_pair(refill_levels):
        seed4 = torch.tensor([-123456789, refill_levels, 1000, npix * 100],
                             dtype=torch.int32, device=dev)
        k_out = bounce.FusedQOut.empty(n, n_inner, dev)
        bounce.bounce_fused_q(tables, statics, cam_row, bg, seed4, *state,
                              out=k_out, **kw)
        torch.cuda.synchronize()
        p_out = bounce.FusedQOut.empty(n, n_inner, dev)
        bounce.bounce_fused_q_ref(tables, statics, cam_row, bg, seed4,
                                  *state, out=p_out, **kw)
        torch.cuda.synchronize()
        kt, pt = k_out.take.tolist(), p_out.take.tolist()
        print(f"[2] K1 refill {refill_levels} level(s): takes kernel {kt}\n"
              f"[2]                        plain  {pt}")
        check(kt[0] == pt[0] and k_out.base[0].item() == p_out.base[0].item(),
              "K1: level-0 take count / base differ")
        for o in (k_out, p_out):
            b_, t_ = o.base.tolist(), o.take.tolist()
            check(all(b_[j + 1] == b_[j] + t_[j] for j in range(n_inner - 1))
                  and o.cursor.item() == b_[-1] + t_[-1],
                  "K1: per-level bases do not chain the cursor")
        check(all(abs(a - b) <= K1_MISMATCH_FRAC * n for a, b in zip(kt, pt)),
              "K1: take counts differ beyond the mismatch fraction")
        check(started_ranks_are_a_prefix(k_out.rec[3], k_out.take),
              "K1: a level's starts skip or repeat an item")
        return k_out, p_out

    k_out, p_out = k1_pair(1)
    fl_k, fl_p = k_out.rec[3], p_out.rec[3]
    check(torch.equal(fl_k[0] & 4, fl_p[0] & 4)
          and torch.equal(fl_k[0] >> 3, fl_p[0] >> 3),
          "K1: level-0 starts or their ranks differ")
    fl_mis = ((fl_k & 7) != (fl_p & 7)).float().mean().item()
    alive_mis = (k_out.state[7] != p_out.state[7]).float().mean().item()
    close = torch.ones_like(fl_k, dtype=torch.bool)
    for a, b in zip(k_out.rec[:3], p_out.rec[:3]):
        close &= torch.isclose(a, b, rtol=K1_RTOL, atol=K1_ATOL,
                               equal_nan=True)
    v_mis = (~close).float().mean().item()
    agree0 = fl_k[0] == fl_p[0]
    k1_err = max((a[0] - b[0])[agree0].abs().max().item()
                 for a, b in zip(k_out.rec[:3], p_out.rec[:3]))
    alive_both = (k_out.state[7] > 0) & (p_out.state[7] > 0)
    o_mis = max((~torch.isclose(a[alive_both], b[alive_both], rtol=K1_RTOL,
                                atol=K1_ATOL)).float().mean().item()
                for a, b in zip(k_out.state[:3], p_out.state[:3]))
    print(f"[2] K1 mismatch fractions over {n_inner} levels: FL {fl_mis:.2e}"
          f"  alive {alive_mis:.2e}  V {v_mis:.2e}  origin {o_mis:.2e} "
          f"(limit {K1_MISMATCH_FRAC}, rtol=atol={K1_RTOL}); level-0 V max "
          f"abs err {k1_err:.3e}")
    for name, frac in (("FL", fl_mis), ("alive", alive_mis), ("V", v_mis),
                       ("origin", o_mis)):
        check(frac <= K1_MISMATCH_FRAC, f"K1: {name} mismatch {frac}")
    k_out, p_out = k1_pair(n_inner)
    seg_k, seg_p = k_out.seg.tolist(), p_out.seg.tolist()
    check(all(abs(a - b) <= K1_MISMATCH_FRAC * n for a, b in zip(seg_k, seg_p)),
          f"K1: alive counts {seg_k} vs {seg_p}")

    # ---- 3. K2 against its plain version -------------------------------
    base0 = int(k_out.base[0])
    end = int(k_out.cursor[0])
    rows = end - base0 + n
    acc_k = torch.zeros((rows, 3), dtype=torch.float32, device=dev)
    acc_p = torch.zeros_like(acc_k)
    hk = dict(item_base=base0, s_run=n_inner, refill_levels=n_inner,
              max_contribution=cam.max_contribution)
    harvest.harvest_levels_into(acc_k, *k_out.rec, k_out.base, **hk)
    h_rows = harvest.reverse_harvest_levels_ref(
        *k_out.rec, refill_levels=n_inner,
        max_contribution=cam.max_contribution, s_run=n_inner)
    harvest.write_rows_ref(acc_p, h_rows, k_out.base, item_base=base0,
                           n_rows=n_inner)
    torch.cuda.synchronize()
    k2_err = (acc_k[:end - base0] - acc_p[:end - base0]).abs().max().item()
    print(f"[3] K2 accumulator over {end - base0} items: max abs err {k2_err}")
    check(k2_err == 0.0, "K2: accumulator differs from the plain version")

    # ---- 4. exact accounting, and kernels vs plain on a small render ---
    def quad_scene(bg_):
        b = SceneBuilder(background=bg_)
        m = b.lambertian((0.5, 0.5, 0.5))
        b.quad((0, 0, 1e8), (1, 0, 0), (0, 1, 0), m)
        b.add_light(b.quad((0, 0, 1e8), (1, 0, 0), (0, 1, 0),
                           b.diffuse_light((1, 1, 1))))
        return b.build()

    c = Camera(width=32, aspect_ratio=1.0, samples_per_pixel=9, max_depth=4)
    c.position((0, 0, 5), (0, 0, 0))
    img, st = regen.render_regen(quad_scene((1.0, 1.0, 1.0)), c, seed=0,
                                 n_lanes=4096, cadence=3, device=dev)
    check(np.abs(img - 1.0).max() == 0.0 and st["segments"] == 32 * 32 * 9,
          f"exact accounting: max |img-1| {np.abs(img - 1.0).max()}, "
          f"segments {st['segments']}")
    c = Camera(width=64, aspect_ratio=1.0, samples_per_pixel=16, max_depth=3)
    c.position((0, 0, 5), (0, 0, 0))
    img, st = regen.render_regen(quad_scene((0.25, 0.5, 0.75)), c, seed=1,
                                 n_lanes=4096, cadence=2, refill_len=8,
                                 device=dev)
    err = np.abs(img - np.array([0.25, 0.5, 0.75], np.float32)).max()
    check(st["windows"] > 1 and err == 0.0,
          f"multi-window chaining: windows {st['windows']}, err {err}")
    print(f"[4] exact accounting ok; multi-window ok ({st['windows']} windows)")
    sc, cm = scene, cam
    cm.width, cm.samples_per_pixel, cm.max_depth = 32, 16, 50
    img_k, st_k = regen.render_regen(sc, cm, seed=3, n_lanes=4096, device=dev)
    img_p, st_p = regen.render_regen(sc, cm, seed=3, n_lanes=4096,
                                     device="cpu")
    pix_mis = (~np.isclose(img_k, img_p, rtol=1e-3, atol=1e-3)).any(-1).mean()
    print(f"[4] cornellBox 32 px, 16 spp: kernels vs plain: segments "
          f"{st_k['segments']} / {st_p['segments']}, mismatched pixels "
          f"{pix_mis:.4f}, mean {img_k.mean():.6f} / {img_p.mean():.6f}")
    check(abs(img_k.mean() - img_p.mean()) < 0.01 * img_p.mean()
          and pix_mis < 0.05, "kernels vs plain render disagree")

    # ---- 5. the flagship through the CLI -------------------------------
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    bounce.launches = 0
    harvest.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["-S", "6", "-o",
                       os.path.join(out_dir, "cornellBox_flagship.ppm"),
                       "--stats", "--quiet"])
    k1_launches, k2_launches = bounce.launches, harvest.launches
    check(rc == 0, f"cli.main returned {rc}")
    stats = json.loads(buf.getvalue().strip().splitlines()[-1])
    ratio = stats["segments"] / stats["paths"]
    print(f"[5] flagship cornellBox 600x600 100spp depth 50, 131072 lanes on "
          f"{card}: paths {stats['paths']}, segments {stats['segments']} "
          f"({ratio:.4f}/path), {stats['rays_per_s']:.6g} rays/s, elapsed "
          f"{stats['elapsed_s']:.4f} s, windows {stats['windows']}, "
          f"occupancy {stats['occupancy']:.4f}, nonfinite "
          f"{stats['nonfinite']}; launches K1 {k1_launches} K2 {k2_launches}")
    check(stats["paths"] == 36_000_000, "flagship: paths != 36,000,000")
    check(stats["nonfinite"] == 0, "flagship: non-finite pixels")
    check(2.78 <= ratio <= 3.08, f"flagship: segments/path {ratio}")
    check(k1_launches > 0 and k2_launches > 0,
          "flagship did not launch both kernels")
    # spread over repeats, and the device's busy share under the profiler
    from go_raytracer_tpu_torch.scenes import registry
    fscene, fcam = registry.cornell_box()
    reps = [regen.render_regen(fscene, fcam, seed=s, device=dev)[1]
            for s in (1, 2, 3)]
    print("[5] repeats (seeds 1-3): rays/s " + ", ".join(
        f"{r['rays_per_s']:.6g}" for r in reps) + "; elapsed s " + ", ".join(
        f"{r['elapsed_s']:.5f}" for r in reps))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, pst = regen.render_regen(fscene, fcam, seed=4, device=dev)
    # device-side events only (kernels and copies; the host ops that
    # launched them would count the same time twice)
    dev_us = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0 and "CUDA" in str(getattr(e, "device_type", "")):
            dev_us[e.key] = t
    render_us = sum(v for k, v in dev_us.items() if k.startswith(
        ("fused_q_level", "count_dead", "harvest_levels")))
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:6]
    if dev_us:
        print(f"[5] profiled render (seed 4): elapsed {pst['elapsed_s']:.5f} s"
              f" (render loop only), the port's kernels "
              f"{render_us / 1e6:.5f} s = {render_us / 1e6 / pst['elapsed_s']:.3f}"
              f" of it; all device events in the profile (incl. set-up and "
              f"image readback), ms: " + ", ".join(
                  f"{k[:40]} {v / 1e3:.3f}" for k, v in top))
    else:
        print("[5] profiler reported no device time: busy share not measured")

    # ---- 6. timings at the flagship's shapes ---------------------------
    n = 1 << 17
    scene, cam, tables, statics, cam_row, bg, _ = cornell_inputs(dev, n)
    n_inner = cam.regen_cadence
    state = regen._init_state(n, dev)
    kw = dict(has_defocus=False, max_depth=50, n_inner=n_inner, width=600,
              sqrt_spp=10, npix=npix)
    out = bounce.FusedQOut.empty(n, n_inner, dev)
    # steady state: a few calls with a deep queue fill and age the pool
    seed4 = torch.tensor([7, n_inner, 0, npix * 100], dtype=torch.int32,
                         device=dev)
    for _ in range(8):
        bounce.bounce_fused_q(tables, statics, cam_row, bg, seed4, *state,
                              out=out, **kw)
        state = [s.clone() for s in out.state]
    st0 = [s.clone() for s in state]

    def run_k1():
        bounce.bounce_fused_q(tables, statics, cam_row, bg, seed4, *st0,
                              out=out, **kw)

    def run_k1_plain():
        bounce.bounce_fused_q_ref(tables, statics, cam_row, bg, seed4, *st0,
                                  out=out, **kw)

    k1_ms = time_ms(run_k1, 20)
    segs = int(out.seg.sum())
    k1_plain_ms = time_ms(run_k1_plain, 3)
    k1_bytes = n * (36 + 36) + n_inner * n * 16 \
        + sum(t.numel() * 4 for t in tables)
    k1_bound = max(k1_bytes / HBM_BYTES_PER_S,
                   segs * K1_OPS_PER_SEGMENT / FP32_OPS_PER_S) * 1e3
    k1_bound_by = "bytes" if k1_bytes / HBM_BYTES_PER_S >= \
        segs * K1_OPS_PER_SEGMENT / FP32_OPS_PER_S else "operations"
    print(f"[6] K1 {n} lanes x {n_inner} levels ({segs} segments): kernel "
          f"{k1_ms:.4f} ms, plain {k1_plain_ms:.3f} ms, bound "
          f"{k1_bound:.4f} ms ({k1_bound_by}) on {card}")

    # K2 on one flagship window's records
    _, cam = cornell_inputs(dev, 8)[:2]
    d1 = cam.max_depth + 1
    total = npix * 100
    refill = regen._auto_refill(total, n, d1, n_inner, cam)
    window = -(-(refill + d1) // n_inner) * n_inner
    bufs = regen.WindowBuffers.empty(n, window // n_inner, n_inner, dev)
    acc = torch.zeros((total + n, 3), dtype=torch.float32, device=dev)
    state = regen._init_state(n, dev)
    _, _, cur = regen._window_impl(
        tables, statics, cam_row, bg, acc, state,
        torch.zeros(1, dtype=torch.int32, device=dev),
        regen.window_seeds(0, 0, window // n_inner), 0, total, width=600,
        npix=npix, sqrt_spp=10, window=window, refill=refill,
        cadence=n_inner, max_depth=50, max_contribution=cam.max_contribution,
        bufs=bufs)
    next_item, _, s_run = (int(x) for x in cur.tolist())
    rec = [r[:s_run] for r in bufs.rec]
    bases = bufs.base.reshape(-1)
    takes = bufs.take.reshape(-1)[:s_run]
    b_, t_ = bases[:s_run].tolist(), takes.tolist()
    check(next_item == total and b_[0] == 0
          and all(b_[j + 1] == b_[j] + t_[j] for j in range(s_run - 1))
          and b_[-1] + t_[-1] == next_item,
          "flagship window: per-level bases do not chain the cursor")
    check(started_ranks_are_a_prefix(rec[3], takes),
          "flagship window: a level's starts skip or repeat an item")
    print(f"[6] flagship window: {s_run} levels, {next_item} items, each "
          f"started once at its own slot")
    hk = dict(item_base=0, s_run=s_run, refill_levels=refill,
              max_contribution=cam.max_contribution)
    acc2 = torch.zeros_like(acc)
    k2_ms = time_ms(lambda: harvest.harvest_levels_into(acc2, *rec, bases,
                                                       **hk), 10)
    check(torch.equal(acc2[:next_item], acc[:next_item]),
          "K2 timing run differs from the window's harvest")

    acc3 = torch.zeros_like(acc)

    def run_k2_plain():
        rows_ = harvest.reverse_harvest_levels_ref(
            *rec, refill_levels=refill,
            max_contribution=cam.max_contribution, s_run=s_run)
        harvest.write_rows_ref(acc3, rows_, bases, item_base=0,
                               n_rows=min(s_run, refill))

    k2_plain_ms = time_ms(run_k2_plain, 1, warmup=0)
    k2_win_err = (acc3[:next_item] - acc[:next_item]).abs().max().item()
    print(f"[6] K2 vs plain on the flagship window ({s_run} levels, "
          f"{next_item} paths): max abs err {k2_win_err}")
    check(k2_win_err == 0.0,
          "K2 differs from its plain version on the flagship window")
    k2_err = max(k2_err, k2_win_err)
    k2_bytes = s_run * n * 16 + next_item * 12 + s_run * 4
    k2_bound = k2_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[6] K2 {n} lanes x {s_run} levels, {next_item} paths: kernel "
          f"{k2_ms:.4f} ms, plain {k2_plain_ms:.2f} ms, bound {k2_bound:.4f}"
          f" ms (bytes) on {card}")

    kernels = [
        {"name": "bounce_fused_q", "route": "cuda",
         "source": "go_raytracer_tpu_torch/ops/csrc/bounce_fused_q.cu",
         "replaces": "go_raytracer_tpu/ops/pallas/bounce.py:2196",
         "launches": k1_launches, "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_bound_by, "library_ms": None},
        {"name": "reverse_harvest_levels", "route": "cuda",
         "source": "go_raytracer_tpu_torch/ops/csrc/harvest.cu",
         "replaces": "go_raytracer_tpu/ops/pallas/harvest.py:273",
         "launches": k2_launches, "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": "bytes", "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
