"""Rank workers of the port's multi-process tests (tests/test_torch_parallel.py,
tests/test_torch_regen_sharded.py): gloo process groups of CPU ranks.

This module imports torch and the port only, never JAX or the JAX package:
each rank is a spawned process that imports it to find its work, and so
loads no JAX. A test starts one group per file (`run_ranks`): every rank
runs the file's scenarios in turn and writes what the test checks under
the output directory, rank 0 then forms a one-rank group for the one-rank
scenarios. The group's timeout and the join's bound the spawn, so a hang
fails the test that waits on it and not the suite."""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import time
import traceback

import numpy as np

GROUP_TIMEOUT_S = 60.0     # the process group's: forming and collectives
JOIN_TIMEOUT_S = 240.0     # the whole spawn's


def run_ranks(scenarios: str, out_dir, n_ranks: int = 4,
              timeout: float = JOIN_TIMEOUT_S) -> float:
    """Run `scenarios` (a function of this module, by name) on `n_ranks`
    spawned ranks; raise with the ranks' tracebacks where one fails or the
    spawn outlasts `timeout` seconds. Returns the spawn's wall seconds."""
    out_dir = str(out_dir)
    ctx = mp.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_entry,
                         args=(scenarios, r, n_ranks, out_dir))
             for r in range(n_ranks)]
    for p in procs:
        p.start()
    deadline = t0 + timeout
    for p in procs:
        p.join(max(deadline - time.perf_counter(), 0.1))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    codes = [p.exitcode for p in procs]
    if hung or any(c != 0 for c in codes):
        errs = ""
        for r in range(n_ranks):
            path = os.path.join(out_dir, f"error_{r}.txt")
            if os.path.exists(path):
                with open(path) as fh:
                    errs += f"--- rank {r}\n{fh.read()}"
        raise RuntimeError(f"ranks hung past {timeout} s: {hung}; exit codes "
                           f"{codes}\n{errs}")
    return time.perf_counter() - t0


def _entry(scenarios, rank, n_ranks, out_dir):
    import torch
    torch.set_num_threads(1)
    try:
        globals()[scenarios](rank, n_ranks, out_dir)
    except BaseException:
        with open(os.path.join(out_dir, f"error_{rank}.txt"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def _group(out_dir, tag, n_ranks, rank):
    from go_raytracer_tpu_torch.parallel import distributed
    ok = distributed.initialize(
        coordinator_address="file://" + os.path.join(out_dir, f"rdzv_{tag}"),
        num_processes=n_ranks, process_id=rank, device="cpu",
        timeout=GROUP_TIMEOUT_S)
    assert ok


def _raises(fn):
    """The name and message of what fn() raises, or None."""
    try:
        fn()
    except Exception as e:                     # recorded for the test
        return f"{type(e).__name__}: {e}"
    return None


def _save(out_dir, name, **arrays):
    np.savez(os.path.join(out_dir, name), **arrays)


# ---------------------------------------------------------------------------
# tests/test_torch_parallel.py
# ---------------------------------------------------------------------------

def tiny_scene():
    """tests/test_parallel.py's scene, built by the port."""
    from go_raytracer_tpu_torch.scene.builder import SceneBuilder
    b = SceneBuilder(background=(0.1, 0.15, 0.2))
    b.quad((-5, 0, -5), (10, 0, 0), (0, 0, 10), b.lambertian((0.6, 0.5, 0.4)))
    b.sphere((0, 1, 0), 1.0, b.metal((0.9, 0.9, 0.9), 0.1))
    q = b.quad((-1, 5, -1), (2, 0, 0), (0, 0, 2), b.diffuse_light((4, 4, 4)))
    b.add_light(q)
    return b.build()


def render_cam():
    """test_sharded_render_matches_unsharded's camera."""
    from go_raytracer_tpu_torch.render.camera import Camera
    cam = Camera(width=24, aspect_ratio=1.0, samples_per_pixel=4, max_depth=4)
    cam.position((0, 2, 8), (0, 1, 0))
    return cam


def train_cam():
    """test_train_step_runs_and_improves's camera (8x8 px, depth 2)."""
    from go_raytracer_tpu_torch.render.camera import Camera
    cam = Camera(width=8, aspect_ratio=1.0, samples_per_pixel=1, max_depth=2)
    cam.position((0, 2, 8), (0, 1, 0))
    return cam


TRAIN = dict(n_rays=64, n_sample_batches=2, max_depth=2, learning_rate=5e-2)
RENDER_SEED = 5
TRAIN_STEPS = 5


def parallel_scenarios(rank, n_ranks, out_dir):
    import torch
    import torch.distributed as dist

    from go_raytracer_tpu_torch.parallel import mesh as pmesh

    _group(out_dir, "all", n_ranks, rank)
    mesh = pmesh.make_mesh()
    info = dict(shape=list(mesh.shape), names=list(mesh.mesh_dim_names),
                coord=list(mesh.get_coordinate()),
                smaller=_raises(lambda: pmesh.make_mesh(n_ranks - 1)),
                host_key=pmesh.host_key(7))
    img, st = pmesh.render_sharded(tiny_scene(), render_cam(), mesh,
                                   seed=RENDER_SEED, device="cpu")
    # the sharded train step: the first step's loss and leaves, then the
    # losses of TRAIN_STEPS steps toward a black target
    step, params, _ = pmesh.make_train_step(
        tiny_scene(), train_cam(), device="cpu", mesh=mesh,
        generator=pmesh.KeyedUniforms(3), **TRAIN)
    ids = pmesh.pixel_ids(TRAIN["n_rays"], TRAIN["n_sample_batches"])
    target = torch.zeros((TRAIN["n_rays"], 3))
    losses = [step(params, ids, target)]
    grads = {k: p.grad.clone().numpy() for k, p in params.items()}
    losses += [step(params, ids, target) for _ in range(TRAIN_STEPS - 1)]
    _save(out_dir, f"parallel_{rank}.npz", img=img,
          losses=np.asarray(losses),
          **{"grad_" + k: v for k, v in grads.items()})
    info.update(segments=st["segments"])
    with open(os.path.join(out_dir, f"parallel_{rank}.json"), "w") as fh:
        json.dump(info, fh)
    dist.destroy_process_group()
    if rank:
        return
    # one rank: the same render
    _group(out_dir, "one", 1, 0)
    img1, st1 = pmesh.render_sharded(tiny_scene(), render_cam(),
                                     pmesh.make_mesh(1), seed=RENDER_SEED,
                                     device="cpu")
    _save(out_dir, "parallel_one.npz", img=img1,
          segments=np.asarray(st1["segments"]))
    dist.destroy_process_group()


SUM_TIMEOUT_S = 2.0


def timeout_scenarios(rank, n_ranks, out_dir):
    """Rank 0 sums a tensor that rank 1 never joins: the sum raises once
    the group's timeout has passed."""
    import torch
    import torch.distributed as dist

    from go_raytracer_tpu_torch.parallel import distributed

    distributed.initialize(
        coordinator_address="file://" + os.path.join(out_dir, "rdzv_sum"),
        num_processes=n_ranks, process_id=rank, device="cpu",
        timeout=SUM_TIMEOUT_S)
    if rank:
        time.sleep(SUM_TIMEOUT_S + 1.5)
        return
    t0 = time.perf_counter()
    err = _raises(lambda: dist.all_reduce(torch.ones(1)))
    with open(os.path.join(out_dir, "timeout.json"), "w") as fh:
        json.dump(dict(error=err, seconds=time.perf_counter() - t0), fh)


# ---------------------------------------------------------------------------
# tests/test_torch_regen_sharded.py
# ---------------------------------------------------------------------------

def empty_scene(bg=(0.25, 0.5, 0.75)):
    """tests/test_regen.py's all-miss scene, built by the port."""
    from go_raytracer_tpu_torch.scene.builder import SceneBuilder
    b = SceneBuilder(background=bg)
    m = b.lambertian((0.5, 0.5, 0.5))
    b.sphere((0, 0, 1e8), 1.0, m)
    b.add_light(b.quad((0, 0, 1e8), (1, 0, 0), (0, 1, 0),
                       b.diffuse_light((1, 1, 1))))
    return b.build()


def box_scene():
    """tests/test_regen.py's lit box, built by the port."""
    from go_raytracer_tpu_torch.scene.builder import SceneBuilder
    b = SceneBuilder(background=(0, 0, 0))
    white = b.lambertian((0.73, 0.73, 0.73))
    red = b.lambertian((0.65, 0.05, 0.05))
    light = b.diffuse_light((10, 10, 10))
    b.quad((-4, 0, -4), (8, 0, 0), (0, 0, 8), white)
    b.quad((-4, 0, -4), (0, 4, 0), (0, 0, 8), red)
    lq = b.quad((-1, 3.9, -1), (2, 0, 0), (0, 0, 2), light)
    b.sphere((1, 1, 0), 1.0, b.metal((0.9, 0.9, 0.9), 0.1))
    b.add_light(lq)
    return b.build()


def empty_cam():
    """test_sharded_regen_exact_bookkeeping's camera: 16 px, 9 spp."""
    from go_raytracer_tpu_torch.render.camera import Camera
    cam = Camera(width=16, aspect_ratio=1.0, samples_per_pixel=9, max_depth=4)
    cam.position((0, 0, 5), (0, 0, 0))
    return cam


def box_cam():
    """test_sharded_regen_queue_ik_pallas_matches_single_device's camera."""
    from go_raytracer_tpu_torch.render.camera import Camera
    cam = Camera(width=12, aspect_ratio=1.0, samples_per_pixel=25,
                 max_depth=5)
    cam.position((0, 2, 6), (0, 1, 0))
    return cam


def lockstep_cam(width=41, aspect=41 / 25):
    """41 x 25 px at 1 spp: 1,025 items, so ranks 0-2 own 257 each and
    rank 3 254; at refill_len 1 and 256 lanes (256 starts a window) ranks
    0-2 need two windows and rank 3 one, and runs the second idle. 3 x 3
    px: 9 items, rank 3 owns none."""
    from go_raytracer_tpu_torch.render.camera import Camera
    cam = Camera(width=width, aspect_ratio=aspect, samples_per_pixel=1,
                 max_depth=4)
    cam.position((0, 0, 5), (0, 0, 0))
    return cam


def model_cam(cam):
    """test_sharded_regen_mesh_ext_matches_single_device's cut."""
    cam.width, cam.samples_per_pixel, cam.max_depth = 32, 9, 4
    return cam


LANES = 256
# name -> render_regen / render_regen_sharded options
SCHEDULES = {
    "queue_ik": dict(schedule="queue_ik"),
    "direct_rec": dict(schedule="queue_ik", direct_rec=True),
    "queue": dict(schedule="queue"),
    "positional": dict(schedule="positional"),
    "xla": dict(backend="xla"),
    "xla_positional": dict(backend="xla", schedule="positional"),
    "reorder": dict(reorder=True),
}
BOX_SEED = 41
MODEL_LANES = 512


def _stats(st):
    keep = ("segments", "paths", "devices", "segments_per_shard",
            "work_balance", "schedule", "backend", "occupancy", "windows",
            "nonfinite", "direct_rec", "bounce", "reorder")
    return {k: st[k] for k in keep if k in st}


def regen_scenarios(rank, n_ranks, out_dir):
    import torch.distributed as dist

    from go_raytracer_tpu_torch.integrator import regen
    from go_raytracer_tpu_torch.parallel import distributed
    from go_raytracer_tpu_torch.scenes import registry

    _group(out_dir, "all", n_ranks, rank)
    mesh = distributed.global_render_mesh()
    out, stats = {}, {}
    for name, kw in SCHEDULES.items():
        img, st = regen.render_regen_sharded(
            empty_scene(), empty_cam(), mesh, seed=0, n_lanes=LANES,
            device="cpu", **kw)
        out["miss_" + name], stats["miss_" + name] = img, _stats(st)
    for name in ("queue_ik", "queue", "positional", "xla"):
        img, st = regen.render_regen_sharded(
            empty_scene(), lockstep_cam(), mesh, seed=0, n_lanes=LANES,
            refill_len=1, device="cpu", **SCHEDULES[name])
        out["step_" + name], stats["step_" + name] = img, _stats(st)
    for name in ("queue_ik", "xla"):
        img, st = regen.render_regen_sharded(
            empty_scene(), lockstep_cam(3, 1.0), mesh, seed=0,
            n_lanes=LANES, device="cpu", **SCHEDULES[name])
        out["empty_" + name], stats["empty_" + name] = img, _stats(st)
    for name in ("queue_ik", "queue"):
        img, st = regen.render_regen_sharded(
            box_scene(), box_cam(), mesh, seed=BOX_SEED, n_lanes=LANES,
            device="cpu", **SCHEDULES[name])
        out["box_" + name], stats["box_" + name] = img, _stats(st)
    scene, cam = registry.model_example()
    img, st = regen.render_regen_sharded(scene, model_cam(cam), mesh, seed=3,
                                         n_lanes=MODEL_LANES, device="cpu")
    out["model"], stats["model"] = img, _stats(st)
    _save(out_dir, f"regen_{rank}.npz", **out)
    with open(os.path.join(out_dir, f"regen_{rank}.json"), "w") as fh:
        json.dump(stats, fh)
    dist.destroy_process_group()
    if rank:
        return
    # one rank against render_regen, bit for bit, in every schedule
    _group(out_dir, "one", 1, 0)
    mesh = distributed.global_render_mesh()
    one = {}
    cases = [(n, box_scene, box_cam, SCHEDULES[n]) for n in SCHEDULES]
    cases.append(("model", lambda: registry.model_example()[0],
                  lambda: model_cam(registry.model_example()[1]), {}))
    for name, scene_fn, cam_fn, kw in cases:
        lanes = MODEL_LANES if name == "model" else LANES
        a, sa = regen.render_regen_sharded(scene_fn(), cam_fn(), mesh,
                                           seed=BOX_SEED, n_lanes=lanes,
                                           device="cpu", **kw)
        b, sb = regen.render_regen(scene_fn(), cam_fn(), seed=BOX_SEED,
                                   n_lanes=lanes, device="cpu", **kw)
        one[name] = dict(equal=bool(np.array_equal(a, b)),
                         max_diff=float(np.abs(a - b).max()),
                         segments=[sa["segments"], sb["segments"]],
                         devices=sa["devices"],
                         per_shard=sa["segments_per_shard"])
    one["reorder_schedule"] = _stats(regen.render_regen_sharded(
        box_scene(), box_cam(), mesh, seed=BOX_SEED, n_lanes=LANES,
        device="cpu", reorder=True)[1])
    one["reorder_refusals"] = {
        tag: _raises(lambda: regen.render_regen_sharded(
            box_scene(), box_cam(), mesh, reorder=True, device="cpu", **kw))
        for tag, kw in (("queue_ik", dict(schedule="queue_ik")),
                        ("positional", dict(schedule="positional")),
                        ("direct_rec", dict(direct_rec=True)),
                        ("xla", dict(backend="xla")))}
    with open(os.path.join(out_dir, "regen_one.json"), "w") as fh:
        json.dump(one, fh)
    dist.destroy_process_group()
