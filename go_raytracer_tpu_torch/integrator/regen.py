"""Ray regeneration with the in-kernel item queue: the production path.

A fixed pool of N lanes works through a queue of (pixel, stratum) items.
Inside `bounce_fused_q`, every bounce level refills the dead lanes with the
next items in flat lane order, so a lane restarts the level its path dies.
The forward pass records, per level and lane, the merged V plane (the
vertex's emission or its scatter weight) and flag bits (clamp, emit,
started); the reverse harvest then evaluates L = clamp?(emit ? V : V*L)
backwards per lane (camera.go:330-341) and writes each path's radiance to
its item slot of the accumulator. The framebuffer is the per-pixel mean
over strata.

Window structure: `window = refill + (max_depth+1)` levels, rounded up to
a multiple of the cadence (the levels per kernel call). Refills stop after
`refill` levels, so every path started in a window ends inside it and no
path state crosses windows; the host loops windows until the queue
drains. The forward loop stops early once every lane is dead and nothing
can refill (the unwritten levels would be all-zero records).

This is the JAX package's `queue_ik` schedule with the fused harvest
(integrator/regen.py there); the other schedules are not ported.
"""

from __future__ import annotations

import collections
import dataclasses
import time as _time

import numpy as np
import torch

from go_raytracer_tpu_torch.ops import bounce as bounce_mod
from go_raytracer_tpu_torch.ops import harvest as harvest_mod
from go_raytracer_tpu_torch.render import camera as camera_mod
from go_raytracer_tpu_torch.scene import types as T

INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def resolve_device(device=None) -> torch.device:
    """The device to render on: CUDA unless the caller asks for another.
    Never falls back: without a card, only an explicit CPU request runs."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the renderer runs on the GPU unless "
                "the CPU is asked for (device='cpu', CLI --cpu), which runs "
                "the plain PyTorch versions of the kernels")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def _init_state(n: int, device):
    """Fresh lane-pool state: (N,) planes ox oy oz dx dy dz, time (float32),
    alive, bounces done (int32). Directions start at +z."""
    z = lambda: torch.zeros(n, dtype=torch.float32, device=device)
    zi = lambda: torch.zeros(n, dtype=torch.int32, device=device)
    return [z(), z(), z(), z(), z(),
            torch.ones(n, dtype=torch.float32, device=device), z(), zi(), zi()]


def _auto_refill(total_items: int, n: int, d1: int, cadence: int,
                 cam) -> int:
    """Workload-sized refill: enough start levels that one window consumes
    the whole queue — (items / lanes) x the scene's mean path length
    `regen_len`, padded 3%, floored at d1, and split into equal windows
    above a cap of (8 GiB / 56 B per lane-level), rounded up to the
    cadence. The same sizing as the JAX package, so both walk the same
    windows."""
    est_len = getattr(cam, "regen_len", 0.0) or 3.0
    need = int(total_items / n * est_len * 1.03) + 1
    cap = max(d1, int((8 << 30) / (56 * n)))
    k = -(-need // cap)
    refill = max(d1, -(-need // k))
    return -(-refill // cadence) * cadence


def _resolve_cadence(cadence: int, cam) -> int:
    """0 = auto: the camera's per-scene hint, else 1."""
    if cadence > 0:
        return cadence
    return cam.regen_cadence if getattr(cam, "regen_cadence", 0) > 0 else 1


def window_seeds(seed: int, w: int, outer: int) -> torch.Tensor:
    """The (outer,) int32 per-kernel-call seeds of window `w`, from an
    explicit torch.Generator keyed by (seed, w): a resumed render draws
    the same seeds for the same window."""
    g = torch.Generator().manual_seed(
        (seed * 0x9E3779B97F4A7C15 + w) & ((1 << 63) - 1))
    return torch.randint(INT32_MIN, INT32_MAX, (outer,), generator=g,
                         dtype=torch.int64).to(torch.int32)


@dataclasses.dataclass
class WindowBuffers:
    """One window's device buffers, reused across windows: level-major
    record planes (S, N), per-level counts and bases (outer, cadence), and
    the per-call seed table (outer + 1, 4) whose column 2 chains the queue
    cursor from one call to the next on the device."""

    rec: list
    seg: torch.Tensor
    take: torch.Tensor
    base: torch.Tensor
    seed_tab: torch.Tensor

    @staticmethod
    def empty(n: int, outer: int, cadence: int, device) -> "WindowBuffers":
        S = outer * cadence
        f = lambda shape, dt: torch.empty(shape, dtype=dt, device=device)
        return WindowBuffers(
            rec=[f((S, n), torch.float32) for _ in range(3)]
            + [f((S, n), torch.int32)],
            seg=f((outer, cadence), torch.int32),
            take=f((outer, cadence), torch.int32),
            base=f((outer, cadence), torch.int32),
            seed_tab=f((outer + 1, 4), torch.int32))


class _DrainWatch:
    """Early drain exit of the forward loop. A call whose last level had
    no alive lane after its refill proves the window drained: every lane
    is dead and no item can start again. On the CPU that count is read
    directly; on the GPU it is copied to pinned memory behind the kernel
    and read once its event has completed, so the host never waits."""

    def __init__(self, seg):
        self.seg = seg
        self.cuda = seg.is_cuda
        if self.cuda:
            self.host = torch.empty(seg.shape[0], dtype=torch.int32,
                                    pin_memory=True)
            self.pending = collections.deque()
        self.last = -1

    def record(self, i: int):
        self.last = i
        if self.cuda:
            self.host[i:i + 1].copy_(self.seg[i, -1:], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            self.pending.append((i, ev))

    def drained(self) -> bool:
        if not self.cuda:
            return int(self.seg[self.last, -1]) == 0
        while self.pending and self.pending[0][1].query():
            i, _ = self.pending.popleft()
            if int(self.host[i]) == 0:
                return True
        return False


def _window_impl(tables, statics, cam_row, bg, acc, state, next_item, seeds,
                 item_base: int, item_end: int, *, width, npix, sqrt_spp,
                 window, refill, cadence, max_depth, max_contribution,
                 bufs: WindowBuffers = None):
    """One window over items [item_base, item_end): forward kernel calls
    until the window drains, then the harvest into `acc` (rows relative to
    item_base, updated in place). `state` (nine planes) is updated in
    place; `next_item` is a (1,) int32 tensor on the device; `seeds` the
    (outer,) int32 per-call seeds. Returns (acc, state, cur) with cur an
    int64 device tensor [next item, segments traced, levels recorded]."""
    n = state[0].shape[0]
    dev = state[0].device
    outer = window // cadence
    if bufs is None:
        bufs = WindowBuffers.empty(n, outer, cadence, dev)
    tab = bufs.seed_tab
    steps = torch.arange(outer + 1, dtype=torch.int64) * cadence
    tab_host = torch.stack([
        torch.cat([seeds.to(torch.int64).cpu(), torch.zeros(1, dtype=torch.int64)]),
        torch.clamp(refill - steps, 0, cadence),
        torch.zeros(outer + 1, dtype=torch.int64),
        torch.full((outer + 1,), item_end, dtype=torch.int64)], dim=1)
    # pinned + non_blocking: a pageable copy would wait for the stream,
    # stalling the host behind the previous window
    src = tab_host.to(torch.int32)
    tab.copy_(src.pin_memory() if tab.is_cuda else src, non_blocking=True)
    tab[0, 2:3].copy_(next_item)
    watch = _DrainWatch(bufs.seg)
    n_run = 0
    for i in range(outer):
        sl = slice(i * cadence, (i + 1) * cadence)
        out = bounce_mod.FusedQOut(
            rec=[r[sl] for r in bufs.rec], seg=bufs.seg[i],
            take=bufs.take[i], base=bufs.base[i], cursor=tab[i + 1, 2:3],
            state=state)
        bounce_mod.bounce_fused_q(
            tables, statics, cam_row, bg, tab[i], *state,
            has_defocus=False, max_depth=max_depth, n_inner=cadence,
            width=width, sqrt_spp=sqrt_spp, npix=npix, out=out)
        n_run = i + 1
        watch.record(i)
        if watch.drained():
            break
    s_run = n_run * cadence
    harvest_mod.harvest_levels_into(
        acc, *(r[:s_run] for r in bufs.rec), bufs.base.reshape(-1),
        item_base=item_base, s_run=s_run, refill_levels=refill,
        max_contribution=max_contribution)
    segments = bufs.seg[:n_run].sum(dtype=torch.int64)
    cur = torch.stack([tab[n_run, 2].to(torch.int64), segments,
                       segments.new_full((), s_run)])
    return acc, state, cur


def _window_pipeline(dispatch, total_items, n_windows, bar,
                     checkpoint_cb=None, checkpoint_every=4, start_i=0):
    """Depth-1 window pipeline: `dispatch(w)` launches window w (chaining
    all state on the device) and returns its [cursor, segments] device
    pair, which is read one window late so the next window is already
    queued during the read. The first window is always read at once, to
    learn the starts per window; when the in-flight window likely drains
    the queue, the loop reads it instead of queuing a no-op window.
    Returns (final cursor, segments, windows, per-dispatch wall times)."""
    segments = 0
    next_i = start_i
    window_times = []
    pending = None
    s_est = None

    def sync(cur):
        nonlocal next_i, segments, s_est
        prev = next_i
        vals = [int(x) for x in cur.tolist()]            # one readback
        next_i = vals[0]
        segments += vals[1]
        if next_i > prev:
            s_est = next_i - prev
        bar.tick(next_i - bar.done)

    while next_i < total_items:
        if pending is not None and s_est is not None \
                and total_items - next_i <= 1.25 * s_est:
            sync(pending)
            pending = None
            continue
        wt0 = _time.perf_counter()
        cur = dispatch(n_windows)
        n_windows += 1
        if pending is not None:
            sync(pending)
            pending = cur
        elif s_est is None:
            sync(cur)
        else:
            pending = cur
        window_times.append(_time.perf_counter() - wt0)
        if checkpoint_cb and n_windows % checkpoint_every == 0:
            if pending is not None:
                sync(pending)
                pending = None
            checkpoint_cb(next_i, n_windows)
    if pending is not None:
        sync(pending)
    if checkpoint_cb and window_times:
        checkpoint_cb(next_i, n_windows)
    return next_i, segments, n_windows, window_times


def _assemble_image(acc, *, total_items, n_strata, npix, h, w):
    """Mean over strata (item = stratum * npix + pixel) -> (h, w, 3)."""
    return acc[:total_items].reshape(n_strata, npix, 3).mean(dim=0) \
        .reshape(h, w, 3)


def render_regen(scene: T.Scene, cam: camera_mod.Camera, seed: int = 0,
                 n_lanes: int = 1 << 17, refill_len: int = 0,
                 cadence: int = 0, schedule: str = "auto", device=None,
                 checkpoint_path=None, checkpoint_every: int = 4,
                 scene_name: str = "", verbose: bool = False):
    """Render the full image with ray regeneration on `device` (default
    CUDA; "cpu" runs the kernels' plain versions). Returns (linear image
    (H, W, 3) float32 numpy, stats).

    `refill_len` 0 sizes the window to the workload (`_auto_refill`);
    `cadence` 0 takes the scene's hint. Checkpoint/resume: between windows
    no path is in flight, so (accumulator, cursor, window count) is a
    consistent checkpoint, and a matching one resumes where it stopped."""
    from go_raytracer_tpu_torch.render import checkpoint as checkpoint_mod
    from go_raytracer_tpu_torch.utils import progress

    if schedule not in ("auto", "queue_ik"):
        raise NotImplementedError(
            f"schedule {schedule!r}: only the in-kernel queue (queue_ik) is "
            "ported; 'queue' and 'positional' are queued in ROADMAP.md")
    if not bounce_mod.supported(scene):
        raise NotImplementedError(
            "scene outside the ported kernel's subset (quads, fused boxes, "
            "lambertian and diffuse-light materials, solid textures, quad "
            "lights); the other features are queued in ROADMAP.md")
    if cam.defocus_angle > 0:
        raise NotImplementedError("defocus blur is a later slice (ROADMAP.md)")
    if n_lanes % bounce_mod.BLOCK:
        raise ValueError(f"n_lanes must be a multiple of {bounce_mod.BLOCK}")
    device = resolve_device(device)
    cadence = _resolve_cadence(cadence, cam)
    arrays = cam.derived()
    h, w = cam.image_height, cam.width
    npix = h * w
    sqrt_spp = cam.spp_sqrt
    n_strata = sqrt_spp * sqrt_spp
    total_items = npix * n_strata
    d1 = cam.max_depth + 1
    n = n_lanes
    refill = refill_len or _auto_refill(total_items, n, d1, cadence, cam)
    window = -(-(refill + d1) // cadence) * cadence
    outer = window // cadence

    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    tables = tuple(to_dev(t) for t in bounce_mod.pack_scene(scene))
    statics = bounce_mod.scene_statics(scene)
    cam_row = to_dev(bounce_mod.pack_camera(arrays))
    bg = to_dev(np.asarray(scene.background, np.float32))

    state = _init_state(n, device)
    bufs = WindowBuffers.empty(n, outer, cadence, device)
    n_windows = 0
    meta = checkpoint_mod.meta_for(scene_name, cam)
    meta["lanes"] = n
    bar = progress.Bar(total_items, enabled=verbose)

    # `n_lanes` tail rows absorb the plain harvest's row-tail writes
    acc = torch.zeros((total_items + n, 3), dtype=torch.float32, device=device)
    start_i = 0
    if checkpoint_path:
        loaded = checkpoint_mod.load(checkpoint_path)
        if loaded is not None \
                and checkpoint_mod.compatible(loaded[2], meta) \
                and loaded[0].shape == tuple(acc.shape):
            acc.copy_(torch.from_numpy(loaded[0]).to(torch.float32))
            start_i = int(loaded[1])
            n_windows = int(loaded[2].get("windows", 0))
    bar.tick(start_i)
    next_dev = torch.tensor([start_i], dtype=torch.int32, device=device)

    def dispatch(wi):
        nonlocal next_dev
        seeds = window_seeds(seed, wi, outer)
        _, _, cur = _window_impl(
            tables, statics, cam_row, bg, acc, state, next_dev, seeds,
            0, total_items, width=w, npix=npix, sqrt_spp=sqrt_spp,
            window=window, refill=refill, cadence=cadence,
            max_depth=cam.max_depth, max_contribution=cam.max_contribution,
            bufs=bufs)
        next_dev = cur[0:1].to(torch.int32)
        return cur

    def checkpoint_cb(ni, nw):
        meta["windows"] = nw
        checkpoint_mod.save(checkpoint_path, acc.cpu().numpy(), ni, meta)

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = _time.perf_counter()
    next_i, segments, n_windows, window_times = _window_pipeline(
        dispatch, total_items, n_windows, bar,
        checkpoint_cb=checkpoint_cb if checkpoint_path else None,
        checkpoint_every=checkpoint_every, start_i=start_i)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    bar.close()
    elapsed = _time.perf_counter() - t0

    linear = _assemble_image(acc, total_items=total_items,
                             n_strata=n_strata, npix=npix, h=h, w=w) \
        .cpu().numpy()
    stats = {
        "elapsed_s": elapsed,
        "segments": segments,
        "paths": total_items,
        "rays_per_s": segments / elapsed if elapsed > 0 else float("nan"),
        "paths_per_s": total_items / elapsed if elapsed > 0 else float("nan"),
        "windows": n_windows,
        "window_s": window_times,
        "schedule": "queue_ik",
        "occupancy": segments / max(n_windows * window * n, 1),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "nonfinite": int((~np.isfinite(linear)).sum()),
    }
    return linear, stats
