#!/usr/bin/env python3
"""Time and check the mesh kernels K4 `stream_rows`, K10
`stream_round_rows`, K11 `stream2_rows`, K12 `bvh_closest` and K5
`bvh8_closest` on one NVIDIA GPU, at one real bounce level of scene 8
(modelExample, 65,536 lanes), with their compile-time choices swept.

    python3 scripts/tune_mesh_kernels.py [--repo DIR] [--kernels LIST]
                                         [--sweep] [--renders]
                                         [--uncut ROUTES] [--out FILE]

It builds the kernels, prints each one's registers, shared memory and
spills, makes the level the way chip_smoke.py phase 7 does (three levels
of a real window, then a refill: camera rays, bounced rays, dead and
capped lanes), and then:

* K4: records the arguments of every round of one `binned_closest`, holds
  the kernel on each round against `stream_rows_ref` (idx and t bit for
  bit), and times every round (CUDA events; the least of three batches):
  the round-0 time, the sum over the rounds and the largest round, with
  the lengths of the blocks' group ranges (mean, max) per round;
* K10: the same for every round of one `binned_closest(b1_fused=True)`
  (t, idx, next key and bits bit for bit against `stream_round_rows_ref`),
  timed per round beside K4's rounds;
* K11: sorts the level's rays as `binned2_closest` does, holds the kernel
  against `stream2_rows_ref` (idx, t and rounds per unit equal) and times
  it;
* K12: sorts the level's rays as the walk route does (chip_smoke.py phase
  18), holds the kernel against `bvh_closest_ref` (idx equal, t bit for
  bit) and times it, with the walk's work (node visits, triangle tests);
* K5: holds the kernel against `bvh8_closest_ref` (idx equal, t bit for
  bit) on the level's rays as they lie and sorted as the walk route sorts
  them, times it on both with its bound, and gives the plain walk's steps
  per ray (node visits plus group tests) and the most steps of a ray in
  each warp of 4, 8 and 32 consecutive sorted rays (the rays a warp holds
  at 8 or 4 lanes a ray, and at one).

--kernels picks which of k4, k10, k11, k12 and k5 run (default all).
--k5-tail times K5 on the sorted level's heaviest rays alone (4, 128 and
8,192 of them) and on the level with every ray above 20 or 40 steps given a
zero cap; --k5-lines times it against the same kernel reading
scene/bvh8's line tables instead of `traverse8.pack_tables`' rows (its
source rewritten from csrc/traverse8.cu and built beside the kernels), in
turns, on the sorted and unsorted rays.
--level measures the walk route's bounce level at that level's rays
(`MeshContext.bounce_level`: the dense cap, the walk's sort and K5, K3 and
its gather) and at 16 levels of a real window (`_mesh_window`: the
refill, camera rays, uniforms, the bounce, the records; a CUDA graph a
level where the package replays one): host us per call (calls enqueued
back to back), device launches per call (kernels, copies and fills under
torch.profiler, a graph's nodes included), host-issued launches a level
(the runtime calls that put work on the card: kernel and graph launches,
copies, fills), the calls that wait on the device (torch.cuda's sync
debug mode, with the source lines that make them) and the window's wall
time a level. The renders of a call that
also takes --level run after the profiler; time them in a call of their
own.
--renders also renders modelExample at 25 spp (600x337, depth 50) on the
binned, binned2 and walk routes, `--b1-fused` and `--mesh walk
--no-traverse8`, and prints each render loop's wall time, its paths,
segments, windows, lanes, whether its levels replayed as a CUDA graph and
the image's SHA-256; --more-renders does the same at 25 spp for the
statue's other bounces: the reference engine's (backend "xla") and the
`positional` schedule; --uncut binned,binned2,walk
renders those routes at
the full registry configuration (250 spp) too, with --mesh-lanes N on a
pool of N lanes (the mesh path's cap, MESH_MAX_LANES, set to N). Time
renders in a process of their own (`--kernels none --uncut walk`): a
render timed after torch.profiler in one process runs slower.

--repo DIR imports the package from another checkout (the parent commit,
unpacked with `git archive`) and times its kernels the same way, so two
commits compare in one call: parent, change, change, parent. --sweep
times K4 at `stream.CH` in (16, 32, 64), K11 at `stream2.RANGE_W` in
(2, 4, 8, 16, 32) with `stream2.TEAM` in (1, 2, 4, 8) warps per unit, and
K12 at `traverse.WARP_RAYS` in (32, 16, 8) with `traverse.LEAF_BATCH` in
(1, 2, 4, 8) where the package has them, each variant held against its
plain version first, in two passes (forward, then reversed), and K5 at
`traverse8.TEAM` in (8, 4) with `traverse8.BLOCK` in (64, 128, 256) and
`traverse8.LEAF_BATCH` in 1 .. 32 / TEAM, on the sorted and unsorted rays.
The results go to --out as JSON (default build/tune_mesh_kernels.json,
git-ignored) beside a printed summary. Without a GPU it exits non-zero.
"""

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time


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


# the runtime calls that put work on the card, as torch.profiler names them
HOST_LAUNCH_APIS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                    "cuGraphLaunch", "cudaMemcpyAsync", "cuMemcpyAsync",
                    "cudaMemsetAsync", "cuMemsetD")


def launches(fn, calls):
    """Launches per call of `fn` under torch.profiler, over `calls` calls:
    (device launches: kernels, copies and fills on the card, a CUDA
    graph's nodes included; host-issued launches: the runtime calls of
    HOST_LAUNCH_APIS, a graph's replay one; {runtime call: count})."""
    import collections
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    host = collections.Counter(
        e.name for e in prof.events() if e.device_type == DeviceType.CPU
        and e.name.startswith(HOST_LAUNCH_APIS))
    device = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    return device / calls, sum(host.values()) / calls, dict(host)


def host_syncs(fn):
    """Calls that wait on the device (torch.cuda's sync debug mode) in one
    call of `fn`: their number and the five source lines that make the
    most of them, as "file:line count"."""
    import collections
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(
        f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    return sum(sites.values()), [f"{k} {v}" for k, v in sites.most_common(5)]


def level_cost(ctx, rays, geo, paths, cam8, n8, dev):
    """The walk route's bounce level on the level's rays: host us per call,
    device launches per call and calls that wait on the device; and over
    16 levels of a real window (its buffers kept from one run to the next,
    as a render keeps them), wall ms, device and host-issued launches and
    calls that wait a level."""
    import torch
    from go_raytracer_tpu_torch.integrator import regen
    o8, d8, t8, alive8 = rays
    u = torch.rand((n8, ctx.n_u), device=dev)
    out_b = regen.bounce_mod.bounce_out(n8, dev)
    call = lambda: ctx.bounce_level(o8, d8, t8, alive8, u, out_b)
    res = {"bounce_launches": launches(call, 5)[0]}
    res["bounce_syncs"], res["bounce_sync_sites"] = host_syncs(call)
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            call()
        best = min(best, (time.perf_counter() - t0) / 20 * 1e6)
        torch.cuda.synchronize()
    res["bounce_host_us"] = best
    window = 16
    bufs = regen.WindowBuffers.empty(n8, window, 1, dev)
    acc = torch.zeros((paths + n8, 3), dtype=torch.float32, device=dev)

    def run_window():
        regen._mesh_window(
            ctx, acc, regen._init_state_mesh(n8, dev), 0,
            regen.window_generator(0, 0, dev), paths, window=window,
            refill=window, max_depth=cam8.max_depth,
            max_contribution=cam8.max_contribution, bufs=bufs, **geo)

    run_window()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_window()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / window * 1e3)
    res["window_ms_per_level"] = min(walls)
    dev_l, host_l, apis = launches(run_window, 1)
    res["window_launches_per_level"] = dev_l / window
    res["window_host_launches_per_level"] = host_l / window
    res["window_host_apis"] = apis
    n_sync, res["window_sync_sites"] = host_syncs(run_window)
    res["window_syncs_per_level"] = n_sync / window
    res["graph"] = bool(getattr(ctx, "graph", False))
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose package is timed")
    ap.add_argument("--kernels", default="k4,k10,k11,k12,k5",
                    help="comma-separated kernels to check and time")
    ap.add_argument("--sweep", action="store_true",
                    help="time every variant of CH, RANGE_W, TEAM, "
                         "WARP_RAYS, LEAF_BATCH and K5's TEAM and BLOCK")
    ap.add_argument("--renders", action="store_true",
                    help="time the 25-spp renders of the five routes")
    ap.add_argument("--more-renders", action="store_true",
                    help="time the 25-spp renders of the statue's other "
                         "bounces: backend xla, positional")
    ap.add_argument("--level", action="store_true",
                    help="host time and launches of the walk's bounce "
                         "level")
    ap.add_argument("--k5-tail", action="store_true",
                    help="time K5 on the heaviest sorted rays alone")
    ap.add_argument("--k5-lines", action="store_true",
                    help="time K5 against the same kernel reading the BVH8 "
                         "line tables")
    ap.add_argument("--uncut", default="",
                    help="comma-separated routes (binned, binned2, walk) "
                         "rendered at the full registry configuration")
    ap.add_argument("--mesh-lanes", type=int, default=0,
                    help="lane pool of the renders (default: the "
                         "package's MESH_MAX_LANES)")
    ap.add_argument("--out", default=os.path.join("build",
                                                  "tune_mesh_kernels.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.repo))
    from go_raytracer_tpu_torch.integrator import regen
    from go_raytracer_tpu_torch.ops import _cuda, intersect, stream, stream2
    from go_raytracer_tpu_torch.ops import trace, traverse, traverse8
    from go_raytracer_tpu_torch.scenes import registry

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"package {os.path.abspath(args.repo)} on {card}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _cuda.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s")
    report = {}
    if hasattr(_cuda, "ptxas_report"):
        for name in ("stream", "stream_round", "stream2", "traverse",
                     "traverse8"):
            report[name] = _cuda.ptxas_report(name)
            for line in report[name]:
                print(f"ptxas {name}: {line}")
    dev = torch.device("cuda")

    kernels = set(args.kernels.split(","))

    # ---- the level (chip_smoke.py phase 7) --------------------------------
    scene8, cam8 = registry.model_example()
    ctx = regen.MeshContext.build(scene8, cam8, dev, mesh="walk")
    ms, bvh = ctx.ms, ctx.ms.tri_bvh
    n8 = 1 << 16     # the level's lanes (the lane cap up to PR 18)
    geo = dict(width=cam8.width, npix=cam8.width * cam8.image_height,
               sqrt_spp=cam8.spp_sqrt)
    paths = cam8.width * cam8.image_height * cam8.spp_sqrt ** 2
    gen = regen.window_generator(0, 0, dev)
    bufs = regen.WindowBuffers.empty(n8, 3, 1, dev)
    acc = torch.zeros((4 * n8, 3), dtype=torch.float32, device=dev)
    res = regen._mesh_window(
        ctx, acc, regen._init_state_mesh(n8, dev), 0, gen, paths, window=3,
        refill=2, max_depth=cam8.max_depth,
        max_contribution=cam8.max_contribution, bufs=bufs, **geo)
    # (state, next item, segments, levels) before the window's counts
    # stayed on the device, (state, [next item, ...] on the device, levels
    # run) since
    state = res[0]
    nxt = int(res[1]) if len(res) == 4 else int(res[1][0])
    if hasattr(regen, "refill_lanes"):
        # a checkout whose window refills in tensor code
        o8, d8, t8, alive8, _, _, _ = regen.refill_lanes(
            ctx.arrays, state, torch.tensor(nxt, device=dev), gen, True,
            nxt + n8 // 4, **geo)
    else:
        # the level's refill through the glue's entry
        from go_raytracer_tpu_torch.ops import mesh_level
        lv = mesh_level.MeshLevel.empty(n8, 1, ctx.n_u, dev)
        lv.begin(state, nxt)
        lv.u_cam.uniform_(generator=gen)
        mesh_level.refill(lv, ctx.arrays, ctx.cam_row,
                          torch.zeros(1, dtype=torch.int32, device=dev),
                          item_end=nxt + n8 // 4, refill=1, cadence=1, **geo)
        o8, d8, t8, alive8 = lv.o, lv.d, lv.t, lv.alive
    cap8 = intersect.sphere_ts(ms.spheres, o8, d8, t8, 1e-3,
                               float("inf")).amin(dim=1)
    del bufs, acc
    print(f"level: {n8} lanes, {int(alive8.sum())} alive")

    # ---- K4: every round of one binned_closest ----------------------------
    calls = []
    real = stream.stream_rows

    def spy(*a):
        calls.append(a)
        return real(*a)

    stream.stream_rows = spy
    try:
        trace.binned_closest(ms, o8, d8, cap8, alive8)
    finally:
        stream.stream_rows = real
    spans = [(a[2] - a[1]).clamp(min=0).float() for a in calls]
    k4_rounds = [{"rays": a[3].numel(),
                  "span_mean": float(s.mean()), "span_max": int(s.max()),
                  "groups": int(s.sum())} for a, s in zip(calls, spans)]

    def k4_items(ch):
        n_groups = bvh.cl_lines.shape[0]
        tot = 0
        for a in calls:
            lo, hi = a[1].clamp(min=0).long(), a[2].clamp(max=n_groups).long()
            tot += int(torch.where(hi > lo, (hi - 1) // ch - lo // ch + 1,
                                   0).sum())
        return tot

    def k4_check():
        for a in calls:
            kt, ki = real(*a)
            pt, pi = stream.stream_rows_ref(*a)
            if not (torch.equal(ki, pi) and torch.equal(kt, pt)):
                raise SystemExit("K4 differs from its plain version")

    def k4_time():
        per = [time_ms(lambda a=a: real(*a), 20) for a in calls]
        return {"round0_ms": per[0], "sum_ms": sum(per), "max_ms": max(per),
                "per_round_ms": per}

    # ---- K10: every round of one fused binned_closest ----------------------
    calls10 = []
    real10 = stream.stream_round_rows

    def spy10(*a):
        calls10.append(a)
        return real10(*a)

    stream.stream_round_rows = spy10
    try:
        trace.binned_closest(ms, o8, d8, cap8, alive8, b1_fused=True)
    finally:
        stream.stream_round_rows = real10
    k_cl = bvh.cl_lo.shape[0]
    n_mask = (k_cl + 31) // 32

    def k10_bound_ms(a):
        """Operations or bytes of one round, as chip_smoke.py phase 20."""
        n_r = a[7].numel()
        tests = int((a[4] - a[3]).clamp(min=0).long().sum()) * 8 * 128
        nbytes = (bvh.cl_lines.numel() * 4 + n_r * 40 + 16 * (n_r // 128)
                  + n_r * 4 * (3 + n_mask))
        return max(nbytes / 3.35e12,
                   (tests * 46 + n_r * k_cl * 12) / 67e12) * 1e3

    def k10_check():
        for a in calls10:
            k = real10(*a)
            p = stream.stream_round_rows_ref(*a)
            if not all(torch.equal(x, y) for x, y in zip(k, p)):
                raise SystemExit("K10 differs from its plain version")

    def k10_time():
        per = [time_ms(lambda a=a: real10(*a), 20) for a in calls10]
        return {"round0_ms": per[0], "sum_ms": sum(per), "max_ms": max(per),
                "mean_ms": sum(per) / len(per), "per_round_ms": per,
                "bound_ms": [k10_bound_ms(a) for a in calls10]}

    # ---- K12: the level's rays sorted as the walk route sorts them ---------
    cap0 = torch.where(alive8, cap8, 0.0)
    keyw = torch.where(alive8, trace.coherence_key(bvh, o8, d8), 0x7FFFFFFF)
    permw = torch.sort(keyw).indices
    k12_args = (bvh.bvh_nodes, bvh.bvh_tris, o8[permw].contiguous(),
                d8[permw].contiguous(), cap0[permw].contiguous())

    def k12_check():
        kt, ki = traverse.bvh_closest(*k12_args, n_nodes=bvh.n_nodes)
        torch.cuda.synchronize()
        work = {}
        pt, pi = traverse.bvh_closest_ref(*k12_args, n_nodes=bvh.n_nodes,
                                          visits=work)
        if not (torch.equal(ki, pi) and torch.equal(kt, pt)):
            raise SystemExit("K12 differs from its plain version")
        if "ray_visits" not in work:     # a package without the counts
            return work
        # the walk's shape per ray and per warp (the kernel's WARP_RAYS
        # consecutive sorted rays): what a warp's dependent steps follow
        v, lv = work.pop("ray_visits"), work.pop("ray_leaves")
        wr = traverse.WARP_RAYS
        wv, wl = v.view(-1, wr), lv.view(-1, wr)
        stat = lambda x: {"mean": float(x.float().mean()), "max": int(x.max())}
        work.update(warp_rays=wr, ray_visits=stat(v), ray_leaves=stat(lv),
                    warp_max_visits=stat(wv.amax(dim=1)),
                    warp_sum_leaves=stat(wl.sum(dim=1)),
                    warp_max_leaves=stat(wl.amax(dim=1)))
        return work

    def k12_time():
        return time_ms(lambda: traverse.bvh_closest(
            *k12_args, n_nodes=bvh.n_nodes), 20)

    # ---- K11: the level's coherence-sorted rays ---------------------------
    key = torch.where(cap0 > 0, trace.coherence_key(bvh, o8, d8), 0x7FFFFFFF)
    perm = torch.sort(key).indices
    k11_args = (bvh.cl2_lines, bvh.cl2_lo, bvh.cl2_hi, bvh.cl2_gs,
                *(x[perm, k].contiguous() for x in (o8, d8) for k in range(3)),
                cap0[perm].contiguous(),
                torch.full((n8,), -1, dtype=torch.int32, device=dev))
    unit = getattr(stream2, "UNIT", None) or stream2.BLOCK

    def k11_check():
        rounds = torch.zeros(n8 // unit, dtype=torch.int32, device=dev)
        kt, ki = stream2.stream2_rows(*k11_args, rounds=rounds)
        torch.cuda.synchronize()
        work = {}
        pt, pi = stream2.stream2_rows_ref(*k11_args, work=work)
        if not (torch.equal(ki, pi) and torch.equal(kt, pt)
                and torch.equal(rounds.long(), work["rounds"])):
            raise SystemExit("K11 differs from its plain version")
        r = rounds.float()
        return {"unit": unit, "rounds_mean": float(r.mean()),
                "rounds_max": int(r.max()), "box_tests": work["box_tests"],
                "group_tests": work["group_tests"]}

    def k11_time():
        return time_ms(lambda: stream2.stream2_rows(*k11_args), 10)

    # ---- K5: the level's rays as they lie, and sorted as the walk sorts -
    k5_runs = {"unsorted": (o8, d8, cap0),
               "sorted": (o8[permw].contiguous(), d8[permw].contiguous(),
                          cap0[permw].contiguous())}
    max_stack = bvh.max_stack
    if hasattr(traverse8, "pack_tables"):    # the kernel reads packed rows
        k5_tables, k5_kw = (bvh.bvh8_nodes, bvh.bvh8_tris), {}
    else:                                    # the line tables as they are
        k5_tables = (bvh.nodes8, bvh.tris8)
        k5_kw = dict(dense_nodes=bvh.bvh8_dense)

    def k5_check(order):
        o_, d_, c_ = k5_runs[order]
        kt, ki = traverse8.bvh8_closest(*k5_tables, o_, d_, c_,
                                        max_stack=max_stack, **k5_kw)
        torch.cuda.synchronize()
        work = {}
        pt, pi = traverse8.bvh8_closest_ref(*k5_tables, o_, d_, c_,
                                            visits=work, **k5_kw)
        if not (torch.equal(ki, pi) and torch.equal(kt, pt)):
            raise SystemExit(f"K5 differs from its plain version ({order})")
        nbytes = sum(x.numel() for x in k5_tables) * 4 + n8 * (28 + 8)
        ops = (work["node_visits"] * 8 * 12
               + work["group_tests"] * 8 * 46)
        work["bound_ms"] = max(nbytes / 3.35e12, ops / 67e12) * 1e3
        work["bound_by"] = ("bytes" if nbytes / 3.35e12 >= ops / 67e12
                            else "operations")
        if "ray_visits" in work:    # a package with the per-ray counts
            steps = work.pop("ray_visits") + work.pop("ray_groups")
            work["ray_steps"] = {"mean": float(steps.float().mean()),
                                 "max": int(steps.max())}
            for wr in (4, 8, 32):
                w = steps.view(-1, wr).amax(dim=1).float()
                work[f"warp{wr}_max_steps"] = {"mean": float(w.mean()),
                                               "max": int(w.max())}
        return work

    def k5_time(order):
        o_, d_, c_ = k5_runs[order]
        return time_ms(lambda: traverse8.bvh8_closest(
            *k5_tables, o_, d_, c_, max_stack=max_stack, **k5_kw), 20)

    def k5_tail():
        """K5 on the sorted level's heaviest rays alone (by the plain
        walk's steps), and on the level with every ray heavier than a
        limit given a zero cap: what the longest chains cost."""
        o_, d_, c_ = k5_runs["sorted"]
        work = {}
        traverse8.bvh8_closest_ref(*k5_tables, o_, d_, c_, visits=work)
        steps = work["ray_visits"] + work["ray_groups"]
        heavy = torch.argsort(steps, descending=True)
        res = {}
        for nh in (4, 128, 8192):
            h = heavy[:nh]
            sub_ = tuple(x[h].contiguous() for x in (o_, d_, c_))
            res[f"heaviest_{nh}"] = {
                "steps": [int(steps[h].min()), int(steps[h].max())],
                "ms": time_ms(lambda: traverse8.bvh8_closest(
                    *k5_tables, *sub_, max_stack=max_stack), 20)}
        for lim in (20, 40):
            cl = torch.where(steps <= lim, c_, 0.0)
            res[f"steps_le_{lim}"] = {
                "rays": int((steps <= lim).sum()),
                "ms": time_ms(lambda: traverse8.bvh8_closest(
                    *k5_tables, o_, d_, cl, max_stack=max_stack), 20)}
        print(f"k5 tail: {res}")
        return res

    def k5_lines():
        """K5 against the same kernel reading scene/bvh8's line tables (the
        padded node lines, the packed group lines) in place of
        `pack_tables`' rows, in turns: the source is csrc/traverse8.cu with
        its row addressing rewritten, built beside the kernels."""
        lib_dir = os.path.dirname(_cuda._target("traverse8"))
        src = open(os.path.join(_cuda._CSRC, "traverse8.cu")).read()
        for a, b in (
                ("const float4* nodes;", "const float* nodes;"),
                ("const float4* tris;", "const float* tris;"),
                ("void lane_leaf(const float4* tris,",
                 "void lane_leaf(const float* tris,"),
                ("void team_leaf(const float4* tris,",
                 "void team_leaf(const float* tris,"),
                ("      const float4* row = tris + ((size_t)(g + (two ? q : 0))"
                 " * 8 + k + j * T) * 3;\n"
                 "      r[q][j][0] = __ldg(row);\n"
                 "      r[q][j][1] = __ldg(row + 1);\n"
                 "      r[q][j][2] = __ldg(row + 2);",
                 "      const float* row = tris + packed_offset(g + (two ? q : 0))"
                 " + (k + j * T) * 128;\n"
                 "      r[q][j][0] = __ldg(reinterpret_cast<const float4*>(row));\n"
                 "      r[q][j][1] = __ldg(reinterpret_cast<const float4*>(row + 4));\n"
                 "      const float2 c2 = __ldg(reinterpret_cast<const float2*>(row + 8));\n"
                 "      r[q][j][2] = make_float4(c2.x, c2.y, 0.0f, 0.0f);"),
                ("const float4* e = a.nodes + (size_t)(is_node ? m : 0) * 16;",
                 "const float* e = a.nodes + (size_t)(is_node ? m : 0) * 1024;"),
                ("const float4 lo = __ldg(e + 2 * (k + j * T)), "
                 "hi = __ldg(e + 2 * (k + j * T) + 1);",
                 "const float4 lo = __ldg(reinterpret_cast<const float4*>("
                 "e + (k + j * T) * 128));\n"
                 "          float4 hi = __ldg(reinterpret_cast<const float4*>("
                 "e + (k + j * T) * 128 + 4));\n"
                 "          hi.z = __ldg(e + 8 + k + j * T);")):
            if src.count(a) != 1:
                raise SystemExit(f"k5_lines: csrc/traverse8.cu changed: {a!r}")
            src = src.replace(a, b)
        cu = os.path.join(lib_dir, "traverse8_lines.cu")
        with open(cu, "w") as fh:
            fh.write(src)
        so = cu[:-3] + ".so"
        subprocess.run([_cuda._nvcc(), *_cuda._flags("traverse8"),
                        "-I", _cuda._CSRC, "-o", so, cu], check=True,
                       capture_output=True)
        lib = ctypes.CDLL(so)
        lib.grt_bvh8_closest.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        if bvh.bvh8_dense:
            raise SystemExit("k5_lines reads the padded node layout only")

        def lines(o_, d_, c_):
            n = o_.shape[0]
            t_out = torch.empty(n, dtype=torch.float32, device=dev)
            i_out = torch.empty(n, dtype=torch.int32, device=dev)
            p = lambda x: x.data_ptr()
            a = traverse8._Traverse8Args(
                nodes=p(bvh.nodes8), tris=p(bvh.tris8), o=p(o_), d=p(d_),
                t_cap=p(c_), t_out=p(t_out), idx_out=p(i_out), n=n,
                team=traverse8.TEAM, block=traverse8.BLOCK,
                stride=max_stack | 1, leaf_batch=traverse8.LEAF_BATCH)
            if lib.grt_bvh8_closest(ctypes.addressof(a),
                                    torch.cuda.current_stream().cuda_stream):
                raise SystemExit("k5_lines: launch failed")
            return t_out, i_out

        rows = lambda o_, d_, c_: traverse8.bvh8_closest(
            *k5_tables, o_, d_, c_, max_stack=max_stack)
        res = {}
        for order, r_ in k5_runs.items():
            if not all(torch.equal(x, y) for x, y in zip(rows(*r_),
                                                        lines(*r_))):
                raise SystemExit(f"k5_lines: the two layouts differ ({order})")
            for name, fn in (("rows", rows), ("lines", lines),
                             ("lines", lines), ("rows", rows)):
                res.setdefault(f"{name}_{order}_ms", []).append(
                    time_ms(lambda: fn(*r_), 20))
        print(f"k5 layouts: {res}")
        return res

    out = {"card": card, "package": os.path.abspath(args.repo),
           "ptxas": report, "k4_rounds": k4_rounds}
    if not args.sweep:
        if "k4" in kernels:
            k4_check()
            out["k4"] = k4_time()
            if hasattr(stream, "CH"):
                out["k4"].update(ch=stream.CH, items=k4_items(stream.CH))
        if "k10" in kernels:
            k10_check()
            out["k10"] = k10_time()
        if "k11" in kernels:
            out["k11"] = dict(k11_check(), ms=k11_time())
        if "k12" in kernels:
            out["k12"] = dict(k12_check(), ms=k12_time())
        if "k5" in kernels:
            out["k5"] = {order: dict(k5_check(order), ms=k5_time(order))
                         for order in k5_runs}
            out["k5"]["schedule"] = {k: getattr(traverse8, k, None)
                                     for k in ("TEAM", "BLOCK", "LEAF_BATCH")}
    else:
        chs = (16, 32, 64) if "k4" in kernels else ()
        k11_vars = [(team, w) for team in (1, 2, 4, 8)
                    for w in (2, 4, 8, 16, 32)] if "k11" in kernels else []
        saved = stream.CH, stream2.RANGE_W, stream2.TEAM
        k4_res = {ch: [] for ch in chs}
        k11_res = {v: [] for v in k11_vars}
        k11_work = {}
        try:
            for ch in chs:
                stream.CH = ch
                k4_check()
            for v in k11_vars:
                stream2.TEAM, stream2.RANGE_W = v
                k11_work[v] = k11_check()
            for order in (1, -1):
                for ch in chs[::order]:
                    stream.CH = ch
                    k4_res[ch].append(k4_time())
                for v in k11_vars[::order]:
                    stream2.TEAM, stream2.RANGE_W = v
                    k11_res[v].append(k11_time())
        finally:
            stream.CH, stream2.RANGE_W, stream2.TEAM = saved
        out["k4_sweep"] = [
            {"ch": ch, "items": k4_items(ch),
             "round0_ms": [r["round0_ms"] for r in k4_res[ch]],
             "sum_ms": [r["sum_ms"] for r in k4_res[ch]],
             "max_ms": [r["max_ms"] for r in k4_res[ch]]} for ch in chs]
        out["k11_sweep"] = [
            dict(k11_work[v], team=v[0], range_w=v[1], ms=k11_res[v])
            for v in k11_vars]
        if hasattr(traverse, "WARP_RAYS") and "k12" in kernels:
            k12_vars = [(wr, b) for wr in (32, 16, 8) for b in (1, 2, 4, 8)]
            saved = traverse.WARP_RAYS, traverse.LEAF_BATCH
            res = {v: [] for v in k12_vars}
            try:
                for v in k12_vars:
                    traverse.WARP_RAYS, traverse.LEAF_BATCH = v
                    k12_check()
                for order in (1, -1):
                    for v in k12_vars[::order]:
                        traverse.WARP_RAYS, traverse.LEAF_BATCH = v
                        res[v].append(k12_time())
            finally:
                traverse.WARP_RAYS, traverse.LEAF_BATCH = saved
            out["k12_sweep"] = [{"warp_rays": v[0], "leaf_batch": v[1],
                                 "ms": res[v]} for v in k12_vars]
        if hasattr(traverse8, "TEAM") and "k5" in kernels:
            k5_vars = [(team, blk, lb) for team in (8, 4)
                       for blk in (64, 128, 256)
                       for lb in ((1, 2, 3, 4) if team == 8
                                  else (1, 2, 4, 8))]
            names = ("TEAM", "BLOCK", "LEAF_BATCH")
            saved = tuple(getattr(traverse8, k) for k in names)

            def k5_set(v):
                for name, x in zip(names, v):
                    setattr(traverse8, name, x)

            res = {v: [] for v in k5_vars}
            try:
                for v in k5_vars:
                    k5_set(v)
                    k5_check("sorted")
                    k5_check("unsorted")
                for order in (1, -1):
                    for v in k5_vars[::order]:
                        k5_set(v)
                        res[v].append((k5_time("sorted"),
                                       k5_time("unsorted")))
            finally:
                k5_set(saved)
            out["k5_sweep"] = [{"team": v[0], "block": v[1],
                                "leaf_batch": v[2],
                                "sorted_ms": [r[0] for r in res[v]],
                                "unsorted_ms": [r[1] for r in res[v]]}
                               for v in k5_vars]
            best = sorted(out["k5_sweep"], key=lambda r: min(r["sorted_ms"]))
            for r in best[:6]:
                print(f"k5 sweep: team {r['team']} block {r['block']} "
                      f"leaf_batch {r['leaf_batch']}: sorted "
                      f"{min(r['sorted_ms']):.4f} ms, unsorted "
                      f"{min(r['unsorted_ms']):.4f} ms")
    if args.k5_tail:
        out["k5_tail"] = k5_tail()
    if args.k5_lines:
        out["k5_lines"] = k5_lines()
    if args.level:
        out["level"] = level_cost(ctx, (o8, d8, t8, alive8), geo, paths,
                                  cam8, n8, dev)
        print(f"level: {out['level']}", flush=True)
    route_kw = {"binned": dict(mesh="binned"),
                "binned2": dict(mesh="binned2"), "walk": dict(mesh="walk"),
                "b1_fused": dict(mesh="binned", b1_fused=True),
                "walk_bvh2": dict(mesh="walk", traverse8=False)}
    renders = [(name, 25) for name in route_kw] if args.renders else []
    # the statue's other bounces: the reference engine's (its hit on the
    # walk) and the `positional` schedule
    more_kw = {"xla": dict(backend="xla"),
               "positional": dict(schedule="positional")}
    renders += [(name, 25) for name in more_kw] if args.more_renders else []
    renders += [(name, None) for name in args.uncut.split(",") if name]
    if renders:
        out["renders"] = {}
    for name, spp in renders:
        kw = route_kw.get(name) or more_kw[name]
        sc, cm = registry.model_example()
        if spp is not None:
            cm.samples_per_pixel = spp
        if args.mesh_lanes:
            regen.MESH_MAX_LANES = args.mesh_lanes
        img, st = regen.render_regen(sc, cm, seed=0, device=dev,
                                     n_lanes=max(args.mesh_lanes, 1 << 17),
                                     **kw)
        key = name if spp is not None else f"{name}_uncut"
        out["renders"][key] = {
            "elapsed_s": st["elapsed_s"], "levels": st["levels"],
            "levels_run": st.get("levels_run"),
            "paths": st["paths"], "segments": st["segments"],
            "windows": st["windows"], "lanes": st["lanes"],
            "route": st["mesh"]["route"],
            "graph": st["mesh"].get("graph", False),
            "sha256": hashlib.sha256(img.tobytes()).hexdigest()[:16]}
        print(f"render {key}: {out['renders'][key]}", flush=True)
    # the earlier schedule's work (blocks of 128, a window of 32) on the
    # same rays, for the bound's like-for-like comparison
    if unit != 128:
        w128 = {}
        stream2.stream2_rows_ref(*k11_args, unit=128, range_w=32, work=w128)
        r = w128["rounds"].float()
        out["k11_128"] = {"rounds_mean": float(r.mean()),
                          "rounds_max": int(r.max()),
                          "box_tests": w128["box_tests"],
                          "group_tests": w128["group_tests"]}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "ptxas"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
