"""The reference engine's renderer: the stratified sample loop over pixel
chunks, with the accumulator on the device (the JAX package's
`render/renderer.py`).

Replaces the reference's goroutine row pool (camera/camera.go:90-153):
pixels are flattened and cut into chunks of at most `ray_batch` rays,
and each (stratum, chunk) pass renders one stratified sample for the
chunk's pixels through `integrator/wavefront.radiance`. The image crosses
to the host once, at the end (main.go:442-479's write at the end).
"""

from __future__ import annotations

import math
import time as _time
from typing import Optional

import numpy as np
import torch

from go_raytracer_tpu_torch.integrator import regen as regen_mod
from go_raytracer_tpu_torch.integrator import wavefront
from go_raytracer_tpu_torch.ops import trace as trace_mod
from go_raytracer_tpu_torch.render import camera as camera_mod
from go_raytracer_tpu_torch.render import checkpoint as checkpoint_mod
from go_raytracer_tpu_torch.render import film
from go_raytracer_tpu_torch.scene import types as T
from go_raytracer_tpu_torch.utils import progress


def launch_generator(seed: int, launch: int, device) -> torch.Generator:
    """The random stream of launch group-and-chunk `launch`, keyed by
    (seed, launch): a resumed render draws the same numbers there."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 0x9E3779B97F4A7C15 + launch + 1) & ((1 << 63) - 1))
    return g


def render(scene: T.Scene, cam: camera_mod.Camera, seed: int = 0,
           mode: str = "while", ray_batch: int = 1 << 17, device=None,
           verbose: bool = False, checkpoint_path: Optional[str] = None,
           checkpoint_every: int = 8, scene_name: str = "",
           strata_per_launch: int = 0, backend: str = "auto",
           route: Optional[dict] = None, graph: Optional[bool] = None):
    """Render the scene on `device` (default CUDA; "cpu" runs the plain
    versions of the kernels). Returns (linear image (H, W, 3) float32
    numpy, stats).

    Pixels go in chunks of at most `ray_batch` rays, rounded up to a
    multiple of 128 (so the kernel backend's "auto" rule can hold), and
    `strata_per_launch` strata (0 = all) form one group between
    checkpoints. `mode`, `backend` and `graph` are `wavefront.radiance`'s
    (on the card each level one CUDA graph replay where it can be
    captured; stats["graph"] says whether it was); `route` picks a BVH
    mesh's closest-hit route (`ops/trace.mesh_closest`'s arguments).
    Each group-and-chunk draws from its own torch.Generator on the device
    (`launch_generator`). The camera's vectors go to the device once, and
    segments and levels add up on the device: nothing is read back inside
    a group but at a checkpoint, where the accumulator is saved every
    `checkpoint_every` groups (a matching checkpoint resumes the render);
    the counts are read once, at the end. stats["levels"] counts the
    levels recorded, stats["levels_run"] the levels run (past a drain on
    the card)."""
    device = regen_mod.resolve_device(device)
    ds = trace_mod.to_device(scene, device)
    route = dict(route or {})
    if scene.has_tri_bvh:
        trace_mod.check_route(ds.tri_bvh, **route)
    elif route.get("mesh", "auto") != "auto" or route.get("b1_fused") \
            or not route.get("traverse8", True):
        raise ValueError("mesh, b1_fused and traverse8 pick the closest-hit "
                         "route of a mesh scene; this scene has no mesh")
    arrays = cam.derived().to(device)
    h, w = cam.image_height, cam.width
    npix = h * w
    sqrt_spp = cam.spp_sqrt
    total_strata = sqrt_spp * sqrt_spp
    chunk = min(ray_batch, -(-npix // 128) * 128)
    nchunks = math.ceil(npix / chunk)
    npad = nchunks * chunk
    k_strata = min(strata_per_launch or total_strata, total_strata)
    n_groups = math.ceil(total_strata / k_strata)
    kernel = wavefront.use_kernel(ds, chunk, backend)
    counters = {}

    start_group = 0
    acc = None
    meta = checkpoint_mod.meta_for(scene_name, cam)
    if checkpoint_path:
        loaded = checkpoint_mod.load(checkpoint_path)
        if loaded is not None and checkpoint_mod.compatible(loaded[2], meta) \
                and loaded[0].shape == (npad, 3):
            acc = torch.from_numpy(loaded[0].astype(np.float32)).to(device)
            start_group = loaded[1]
    if acc is None:
        acc = torch.zeros((npad, 3), dtype=torch.float32, device=device)

    bar = progress.Bar((n_groups - start_group) * nchunks, enabled=verbose)
    segments = torch.zeros((), dtype=torch.int64, device=device)
    levels = torch.zeros((), dtype=torch.int64, device=device)
    levels_run = 0
    graphed = graph is not False
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = _time.perf_counter()
    for group in range(start_group, n_groups):
        stratum0 = group * k_strata
        n_local = min(k_strata, total_strata - stratum0)
        for c in range(nchunks):
            gen = launch_generator(seed, group * nchunks + c, device)
            ids = torch.arange(c * chunk, (c + 1) * chunk, device=device)
            for i in range(n_local):
                stratum = stratum0 + i
                s_i = torch.full((chunk,), float(stratum // sqrt_spp),
                                 device=device)
                s_j = torch.full((chunk,), float(stratum % sqrt_spp),
                                 device=device)
                u_cam = torch.rand((chunk, camera_mod.N_U_RAYGEN),
                                   generator=gen, device=device)
                o, d, t = camera_mod.generate_rays(arrays, w, ids, s_i, s_j,
                                                   u_cam)
                L, st = wavefront.radiance(
                    ds, o, d, t, gen, cam.max_depth, cam.max_contribution,
                    mode=mode, backend=backend, route=route,
                    counters=counters, graph=graph)
                acc[c * chunk:(c + 1) * chunk] += L
                segments += st["segments"]
                levels += st["levels"]
                levels_run += st["levels_run"]
                graphed = graphed and st["graph"]
            bar.tick()
        if checkpoint_path and ((group + 1) % checkpoint_every == 0
                                or group + 1 == n_groups):
            checkpoint_mod.save(checkpoint_path, acc.cpu().numpy(), group + 1,
                                meta)
    segments, levels = int(segments), int(levels)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = _time.perf_counter() - t0
    bar.close()

    linear = (acc[:npix].reshape(h, w, 3) / total_strata).cpu().numpy()
    paths = npix * total_strata
    stats = {
        "elapsed_s": elapsed,
        "segments": segments,
        "paths": paths,
        "rays_per_s": segments / elapsed if elapsed > 0 else float("nan"),
        "paths_per_s": paths / elapsed if elapsed > 0 else float("nan"),
        "levels": levels,
        "levels_run": levels_run,
        "graph": graphed and levels_run > 0,
        "integrator": "wavefront",
        "mode": mode,
        "backend": "pallas" if kernel else "xla",
        "chunk": chunk,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "nonfinite": int((~np.isfinite(linear)).sum()),
    }
    if scene.has_tri_bvh:
        stats["mesh"] = dict(counters, route=trace_mod.route_name(**route))
    return linear, stats


def render_to_file(scene: T.Scene, cam: camera_mod.Camera, path: str, **kw):
    """`render`, then the tonemapped image written to `path` (.ppm or
    .png). Returns the stats."""
    linear, stats = render(scene, cam, **kw)
    film.write_image(path, film.tonemap(torch.from_numpy(linear)).numpy())
    return stats
