"""Ray regeneration: the production paths.

A fixed pool of N lanes works through a queue of (pixel, stratum) items.
Dense scenes the fused kernels carry run, by default, the in-kernel queue:
inside `bounce_fused_q`, every bounce level refills the dead lanes with the
next items in flat lane order, so a lane restarts the level its path dies.
Two more schedules serve the same scenes on request. `queue`
(`_queue_window`): the refill is a cumulative sum over the dead lanes in
plain tensor code before each `bounce_fused` call of `cadence` levels, and
`reverse_harvest_into` harvests the refill rows. `positional`
(`_pos_window`): every lane owns a contiguous block of the pixel-major
item index and `bounce_fused_pos` restarts it at any level from its own
pointer planes; the reverse scan retreats the pointers and sums each
path into one of the lane's few pixel slots.
Scenes off the fused kernels (a triangle mesh, triangle lights, or the
"xla" backend) run an unfused window: `_mesh_window` for the `queue`
schedule, `_pos_window_unfused` for `positional`. In `_mesh_window` a
level draws its uniforms, runs the refill and camera rays and, after the
bounce, the records as the glue kernel of `ops/mesh_level`, and reads
nothing back to the host: its counts stay in a device plane. On a BVH mesh the
`bounce` kernel carries (`ops/bounce.supported_ext`), the closest mesh
hit comes from one of the five routes of ops/trace.mesh_closest (the
binned intersector, its fused rounds, the persistent-block intersector,
the BVH8 walk or the binary BVH walk) and the kernel folds it into the
dense winner and shades; elsewhere the level is the reference engine's
bounce (`integrator/wavefront._bounce`). On the card the level replays as
one CUDA graph on the walk and binned2 routes (GRAPH_ROUTES) and on a
scene with no triangle BVH, with either bounce.
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

These are the JAX package's `queue_ik`, `queue` (fused harvest) and
`positional` schedules on its fused-kernel branch, its `queue` schedule on
the external-mesh-hit path, and its `queue` and `positional` schedules on
the whole-XLA `wavefront._bounce` (integrator/regen.py there). Its lane
coherence sort (`reorder=True`) runs on the fused `queue` schedule: before
every `bounce_fused` call `coherence_sort` puts the lanes in (direction
octant, origin Morton cell) order, dead lanes last, and the harvest
unwinds the sorts.

`render_regen_sharded` runs any of them over the ranks of a
`torch.distributed` group: each rank renders its own item range (or, under
`positional`, its slice of a global lane pool) with its own random
streams, the ranks sum three counts after each window, and the
accumulators are gathered once at the end.
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from go_raytracer_tpu_torch.integrator import wavefront
from go_raytracer_tpu_torch.ops import _cuda
from go_raytracer_tpu_torch.ops import bounce as bounce_mod
from go_raytracer_tpu_torch.ops import harvest as harvest_mod
from go_raytracer_tpu_torch.ops import mesh_level as mesh_level_mod
from go_raytracer_tpu_torch.ops import trace as trace_mod
from go_raytracer_tpu_torch.ops.mesh_level import refill_assign
from go_raytracer_tpu_torch.render import camera as camera_mod
from go_raytracer_tpu_torch.scene import types as T
from go_raytracer_tpu_torch.utils import spans

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


def queue_state_from_numpy(planes, device):
    """The JAX package's queue lane state (`_init_state` there: ox oy oz dx
    dy dz, time, alive (bool), item id, bounces done, as numpy arrays) as
    this package's nine planes: the item id is dropped (the harvest finds
    items by rank) and alive becomes int32."""
    ox, oy, oz, dx, dy, dz, t, alive, _, depth = planes
    f = lambda a, dt: torch.from_numpy(
        np.ascontiguousarray(np.asarray(a).astype(dt))).to(device)
    return [f(a, np.float32) for a in (ox, oy, oz, dx, dy, dz, t)] \
        + [f(alive, np.int32), f(depth, np.int32)]


def pos_state_from_numpy(planes, device):
    """The JAX package's positional lane state (its `_init_state_pos`
    fused-kernel layout: the queue planes without the item id, then pi, pj,
    si, sj, rem, as numpy arrays) as this package's fourteen planes."""
    f = lambda a, dt: torch.from_numpy(
        np.ascontiguousarray(np.asarray(a).astype(dt))).to(device)
    return [f(a, np.float32) for a in planes[:7]] \
        + [f(planes[7], np.int32), f(planes[8], np.int32)] \
        + [f(a, np.float32) for a in planes[9:14]]


def pos_tables(npix: int, n_strata: int, n: int):
    """Static positional schedule: lane L owns the contiguous block
    [lane_base[L], lane_base[L] + quota[L]) of the PIXEL-MAJOR item index
    (item = pixel * n_strata + stratum), blocks as even as possible. A
    lane's items are consecutive, so they span at most G pixels (2-5 for
    the reference configurations), and the harvest sums into per-lane
    pixel slots. Returns (quota, lane_base, first_pix) int64 arrays and G."""
    total = npix * n_strata
    q, r = divmod(total, n)
    lanes = np.arange(n, dtype=np.int64)
    quota = np.full(n, q, np.int64)
    quota[:r] += 1
    lane_base = lanes * q + np.minimum(lanes, r)
    first_pix = lane_base // n_strata
    last_pix = (lane_base + np.maximum(quota, 1) - 1) // n_strata
    return quota, lane_base, first_pix, int((last_pix - first_pix).max()) + 1


def _init_state_pos(n: int, device, quota, lane_base, n_strata: int,
                    width: int, k=None):
    """Fresh positional lane state, or one resumed at the per-lane start
    counts `k` (a checkpoint's): the nine planes of `_init_state`, then
    the next item's pixel column and row, stratum row and column, and the
    items left, as float32 planes holding exact small integers."""
    k0 = np.zeros(n, np.int64) if k is None else np.asarray(k, np.int64)
    item = lane_base + k0
    pix, strat = item // n_strata, item % n_strata
    sqrt_spp = int(round(np.sqrt(n_strata)))
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    return _init_state(n, device) + [
        f(pix % width), f(pix // width), f(strat // sqrt_spp),
        f(strat % sqrt_spp), f(np.maximum(quota - k0, 0))]


def _pos_state_k(state, quota) -> np.ndarray:
    """The per-lane start counts of a positional state (what a checkpoint
    stores)."""
    rem = np.round(state[13].cpu().numpy()).astype(np.int64)
    return (quota - rem).astype(np.int32)


def pos_film(B, first_pix, npix: int, n_strata: int, h: int, w: int):
    """Film assembly from the positional accumulator B (3, G, N): slot g
    of lane L is pixel first_pix[L] + g, summed per pixel in float64 and
    divided by the strata. Slots a lane never owns hold exact zeros, so
    clipping their pixel ids is harmless."""
    B = np.asarray(B, np.float64)
    G = B.shape[1]
    pix = first_pix[None, :] + np.arange(G, dtype=np.int64)[:, None]
    flat = pix.clip(0, npix - 1).ravel()
    chans = [np.bincount(flat, weights=B[c].ravel(), minlength=npix)
             for c in range(3)]
    return (np.stack(chans, axis=-1) / n_strata).reshape(h, w, 3) \
        .astype(np.float32)


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


def _stream_key(seed: int, w: int, rank: int) -> int:
    """The 63-bit key of window `w` of rank `rank`'s stream. Rank 0's key
    is (seed, w)'s alone, so a one-rank sharded render draws
    `render_regen`'s numbers."""
    return (seed * 0x9E3779B97F4A7C15 + w + (rank << 40)) & ((1 << 63) - 1)


def window_seeds(seed: int, w: int, outer: int, rank: int = 0) -> torch.Tensor:
    """The (outer,) int32 per-kernel-call seeds of window `w`, from an
    explicit torch.Generator keyed by (seed, w, rank): a resumed render
    draws the same seeds for the same window, and each rank of a sharded
    render its own."""
    g = torch.Generator().manual_seed(_stream_key(seed, w, rank))
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


# the drain watch of every window loop (ops/_cuda.DrainWatch)
_DrainWatch = _cuda.DrainWatch


def _window_impl(tables, statics, cam_row, bg, acc, state, next_item, seeds,
                 item_base: int, item_end: int, *, width, npix, sqrt_spp,
                 window, refill, cadence, max_depth, max_contribution,
                 has_defocus=False, bufs: WindowBuffers = None,
                 direct_rec: bool = False):
    """One window over items [item_base, item_end): forward kernel calls
    until the window drains, then the harvest into `acc` (rows relative to
    item_base, updated in place). `state` (nine planes) is updated in
    place; `next_item` is a (1,) int32 tensor on the device; `seeds` the
    (outer,) int32 per-call seeds; `has_defocus`: the camera rays leave
    from the defocus disk. `direct_rec`: every call gets the whole
    record buffers and its first level's row as a device tensor
    (`bounce_fused_q_direct`) instead of its slice of the buffers; the
    records are the same. Returns (acc, state, cur) with cur an int64
    device tensor [next item, segments traced, levels recorded]."""
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
    # a call whose last level had no alive lane after its refill drained
    watch = _DrainWatch(bufs.seg[:, -1:])
    if direct_rec:
        level_base = torch.arange(0, outer * cadence, cadence,
                                  dtype=torch.int32, device=dev)
    n_run = 0
    kw = dict(has_defocus=has_defocus, max_depth=max_depth, n_inner=cadence,
              width=width, sqrt_spp=sqrt_spp, npix=npix)
    for i in range(outer):
        sl = slice(i * cadence, (i + 1) * cadence)
        out = bounce_mod.FusedQOut(
            rec=bufs.rec if direct_rec else [r[sl] for r in bufs.rec],
            seg=bufs.seg[i], take=bufs.take[i], base=bufs.base[i],
            cursor=tab[i + 1, 2:3], state=state)
        if direct_rec:
            bounce_mod.bounce_fused_q_direct(
                tables, statics, cam_row, bg, tab[i], level_base[i:i + 1],
                bufs.rec, *state, out=out, **kw)
        else:
            bounce_mod.bounce_fused_q(tables, statics, cam_row, bg, tab[i],
                                      *state, out=out, **kw)
        n_run = i + 1
        watch.record(i)
        if watch.drained():
            break
    spans.add("calls", n_run)
    # the harvest may run over every call made: a call after the drained
    # one records only dead lanes (zero V, no flags), which add nothing
    s_run = n_run * cadence
    harvest_mod.harvest_levels_into(
        acc, *(r[:s_run] for r in bufs.rec), bufs.base.reshape(-1),
        item_base=item_base, s_run=s_run, refill_levels=refill,
        max_contribution=max_contribution)
    segments = bufs.seg[:n_run].sum(dtype=torch.int64)
    # levels recorded: up to the first drained call, read on the device, so
    # that the count does not follow how late the host saw the drain
    drained = (bufs.seg[:n_run, -1] == 0).to(torch.int64)
    calls = torch.where(drained.any(), drained.argmax() + 1, n_run)
    cur = torch.stack([tab[n_run, 2].to(torch.int64), segments,
                       calls * cadence])
    return acc, state, cur


# ---------------------------------------------------------------------------
# the fused `queue` and `positional` schedules (dense scenes, on request)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SchedBuffers:
    """One window's device buffers of the `queue` or `positional` schedule,
    reused across windows. `rec`: level-major record planes (S, N) — Vr,
    Vg, Vb, FL for `queue`; Er, Eg, Eb, Wr, Wg, Wb, CF, ST for
    `positional`, whose E and W planes are rows of one (3, S, N) tensor
    each (`E`, `W`) so that the reverse scan reads a level's three
    channels as one view. `seg`: (outer, cadence) alive counts. `queue`
    only: `sts` (refill_outer, N) started flags, `nis` (refill_outer,)
    first item of each refill row, and `idle`, five all-zero refill planes
    for the calls past the refill; with the lane coherence sort (`reorder`)
    also `perm` (outer, N) int32, each call's permutation, and `spare`, a
    second set of the nine state planes that the sort gathers into."""

    rec: list
    seg: torch.Tensor
    sts: torch.Tensor = None
    nis: torch.Tensor = None
    idle: tuple = None
    E: torch.Tensor = None
    W: torch.Tensor = None
    perm: torch.Tensor = None
    spare: list = None

    @staticmethod
    def empty(n: int, outer: int, cadence: int, device,
              refill_outer: int = None,
              reorder: bool = False) -> "SchedBuffers":
        S = outer * cadence
        f = lambda shape, dt: torch.empty(shape, dtype=dt, device=device)
        seg = f((outer, cadence), torch.int32)
        if refill_outer is None:
            E, W = f((3, S, n), torch.float32), f((3, S, n), torch.float32)
            return SchedBuffers(
                rec=[*E, *W, f((S, n), torch.int32), f((S, n), torch.int32)],
                seg=seg, E=E, W=W)
        zf = torch.zeros(n, dtype=torch.float32, device=device)
        return SchedBuffers(
            rec=[f((S, n), torch.float32) for _ in range(3)]
            + [f((S, n), torch.int32)], seg=seg,
            sts=f((refill_outer, n), torch.int32),
            nis=f((refill_outer,), torch.int32),
            idle=(torch.zeros(n, dtype=torch.int32, device=device),
                  zf, zf, zf, zf),
            perm=f((outer, n), torch.int32) if reorder else None,
            spare=_init_state(n, device) if reorder else None)


def coherence_keys(state, blo, bext):
    """The lane coherence sort's key of every lane of `state` (nine planes),
    int32 (N,): (octant << 27) | (morton30(origin) >> 3), the octant
    (dx > 0) << 2 | (dy > 0) << 1 | (dz > 0), the Morton code in the box
    (blo, bext) (device float32 (3,) tensors, `ops/bounce.coherence_bounds`),
    as the JAX package's `_morton30` takes it: each coordinate to
    clip((o - blo) / bext * 1024, 0, 1023), truncated (a NaN to 0). A dead
    lane's key is 0x7FFFFFFF. Divided by tensors: a division by a scalar
    may run as a product with its reciprocal on the card."""
    o = torch.stack(state[0:3])
    q = ((o - blo[:, None]) / bext[:, None] * 1024.0).clamp_(0.0, 1023.0) \
        .nan_to_num_(0.0).to(torch.int32)
    m = trace_mod._part1by2(q)
    morton = (m[0] << 2) | (m[1] << 1) | m[2]
    d = (torch.stack(state[3:6]) > 0).to(torch.int32)
    key = (((d[0] << 2) | (d[1] << 1) | d[2]) << 27) | (morton >> 3)
    return torch.where(state[7] != 0, key, INT32_MAX)


def coherence_sort(state, blo, bext, out, perm_out):
    """The JAX package's `coherence_sort` (integrator/regen.py there): the
    lanes of `state` (nine planes) in the order of `coherence_keys`, ties
    by lane (a stable sort: its sort by (key, lane)), gathered into the
    nine planes `out` (never `state` itself), which are returned.
    `perm_out` ((N,) int32) receives the permutation: perm[i] is the lane
    of `state` now at position i. Dead lanes form the tail, where the
    refill's consecutive camera rays then land."""
    _, idx = torch.sort(coherence_keys(state, blo, bext), stable=True)
    for src, dst in zip(state, out):
        torch.index_select(src, 0, idx, out=dst)
    perm_out.copy_(idx)
    return out


def _queue_window(tables, statics, cam_row, bg, acc, state, next_item, seeds,
                  item_base: int, item_end: int, *, width, npix, sqrt_spp,
                  window, refill, cadence, max_depth, max_contribution,
                  has_defocus=False, bufs: SchedBuffers = None,
                  reorder=None):
    """One window of the `queue` schedule over items [item_base, item_end):
    `window // cadence` calls of `bounce_fused`, each of the first
    ceil(refill / cadence) preceded by the refill (`queue_refill_planes`:
    dead lanes take the next items by their rank in lane order), then the
    harvest of the refill rows into `acc` (rows relative to item_base, in
    place). `state` (nine planes) is updated in place; `next_item` is a 0-d
    int64 tensor on the device; `seeds` the (outer,) int32 per-call seeds
    on the device. Nothing is read back: returns (acc, state, cur) with
    cur an int64 device tensor [next item, segments traced, levels].

    `reorder` (None: off), the scene's Morton box (blo, bext) as device
    tensors (`ops/bounce.coherence_bounds`): every call sorts the lanes
    first (`coherence_sort`), drain calls too, and the refill then ranks
    the dead lanes in the sorted order; the permutations go to `bufs.perm`
    and the harvest unwinds them. The sort gathers into `bufs.spare` and
    the two sets of planes swap, so the planes of `state` may change (the
    list is updated in place)."""
    n = state[0].shape[0]
    outer = window // cadence
    refill_outer = -(-refill // cadence)
    if bufs is None:
        bufs = SchedBuffers.empty(n, outer, cadence, state[0].device,
                                  refill_outer, reorder=reorder is not None)
    cur = list(state)
    for i in range(outer):
        sl = slice(i * cadence, (i + 1) * cadence)
        if reorder is not None:
            cur, bufs.spare = coherence_sort(cur, *reorder, bufs.spare,
                                             bufs.perm[i]), cur
        if i < refill_outer:
            refill_planes = queue_refill_planes(
                next_item, cur[7], item_end, width=width, npix=npix,
                sqrt_spp=sqrt_spp)
            bufs.sts[i] = refill_planes[0]
            bufs.nis[i] = next_item
            next_item = next_item + refill_planes[0].sum()
        else:
            refill_planes = bufs.idle
        bounce_mod.bounce_fused(
            tables, statics, cam_row, bg, seeds[i:i + 1], *cur,
            *refill_planes, has_defocus=has_defocus, max_depth=max_depth,
            n_inner=cadence,
            out=bounce_mod.FusedOut(rec=[r[sl] for r in bufs.rec],
                                    seg=bufs.seg[i], state=cur))
    state[:] = cur
    spans.add("calls", outer)
    harvest_mod.reverse_harvest_into(
        acc, *(r.view(outer, cadence, n) for r in bufs.rec), bufs.sts,
        bufs.nis, item_base=item_base, cadence=cadence,
        refill_outer=refill_outer, max_contribution=max_contribution,
        perms=None if reorder is None else bufs.perm)
    segments = bufs.seg.sum(dtype=torch.int64)
    cur = torch.stack([next_item, segments,
                       segments.new_full((), outer * cadence)])
    return acc, state, cur


def _pos_window(tables, statics, cam_row, bg, B, state, quota, first_pix,
                seeds, *, width, sqrt_spp, G, window, refill, cadence,
                max_depth, max_contribution, has_defocus=False,
                bufs: SchedBuffers = None):
    """One window of the `positional` schedule: `window // cadence` calls
    of `bounce_fused_pos`, then the reverse scan in plain tensor code. It
    runs the clamp recursion L = clamp?(E + W * L) backwards per lane and,
    at every started flag, retreats the lane's item pointer by the exact
    inverse of the kernel's advance, which gives the path's pixel slot
    g = pj * width + pi - first_pix in [0, G), and adds L into B[:, g]
    (B: (3, G, N) float32, in place). Only the first `refill` levels can
    hold starts, so the retreat is skipped after them. `state` (fourteen
    planes) is updated in place; `quota` and `first_pix` are (N,) device
    tensors (int64, float32); `seeds` the (outer,) int32 per-call seeds on
    the device. Returns (B, state, cur) with cur an int64 device tensor
    [paths started so far over all lanes, segments traced, levels]."""
    n = state[0].shape[0]
    outer = window // cadence
    if bufs is None:
        bufs = SchedBuffers.empty(n, outer, cadence, state[0].device)
    steps = torch.arange(outer, dtype=torch.int32, device=seeds.device)
    seed2 = torch.stack([seeds, torch.clamp(refill - steps * cadence, 0,
                                            cadence)], dim=1)
    for i in range(outer):
        sl = slice(i * cadence, (i + 1) * cadence)
        bounce_mod.bounce_fused_pos(
            tables, statics, cam_row, bg, seed2[i], *state,
            has_defocus=has_defocus, max_depth=max_depth, n_inner=cadence,
            width=width, sqrt_spp=sqrt_spp,
            out=bounce_mod.FusedOut(rec=[r[sl] for r in bufs.rec],
                                    seg=bufs.seg[i], state=state))
    spans.add("calls", outer)

    CF, ST = bufs.rec[6], bufs.rec[7]
    L = torch.zeros((3, n), dtype=torch.float32, device=state[0].device)
    pi, pj, si, sj = state[9:13]
    last_s, last_p = float(sqrt_spp - 1), float(width - 1)
    for s in reversed(range(outer * cadence)):
        raw = bufs.E[:, s] + bufs.W[:, s] * L
        tot = raw[0] + raw[1] + raw[2]
        over = (CF[s] != 0) & (tot > max_contribution)
        # a true division; a NaN sum compares false and passes unclamped
        scale = torch.where(over, torch.full_like(tot, max_contribution)
                            / torch.where(over, tot, 1.0), 1.0)
        L = raw * scale
        if s >= refill:
            continue
        started = ST[s] != 0
        sj_r = sj - 1.0
        bor_s = sj_r < -0.5
        sj_r = torch.where(bor_s, last_s, sj_r)
        si_r = si - bor_s.to(torch.float32)
        bor_i = si_r < -0.5
        si_r = torch.where(bor_i, last_s, si_r)
        pi_r = pi - (bor_s & bor_i).to(torch.float32)
        bor_p = pi_r < -0.5
        pi_r = torch.where(bor_p, last_p, pi_r)
        pj_r = pj - bor_p.to(torch.float32)
        pi = torch.where(started, pi_r, pi)
        pj = torch.where(started, pj_r, pj)
        si = torch.where(started, si_r, si)
        sj = torch.where(started, sj_r, sj)
        g = pj * float(width) + pi - first_pix
        for gi in range(G):
            B[:, gi] += torch.where(started & (g == float(gi)), L, 0.0)
        L = torch.where(started, 0.0, L)
    k_total = (quota - torch.round(state[13]).to(torch.int64)).sum()
    segments = bufs.seg.sum(dtype=torch.int64)
    cur = torch.stack([k_total, segments,
                       segments.new_full((), outer * cadence)])
    return B, state, cur


# ---------------------------------------------------------------------------
# the mesh path: the `queue` schedule's unfused window
# ---------------------------------------------------------------------------

# Lane cap of the mesh path, re-derived on the H100: with the level a CUDA
# graph the uncut modelExample walk renders 31-40% faster on 131,072 lanes
# than on the JAX package's 65,536 (PERF.md §6, PR 19), so the two
# packages' windows part there. Its cadence of 1 is the JAX package's.
MESH_MAX_LANES = 1 << 17


def window_generator(seed: int, w: int, device,
                     rank: int = 0) -> torch.Generator:
    """The random stream of window `w` on `device`, keyed by (seed, w,
    rank): a resumed render draws the same numbers for the same window,
    and each rank of a sharded render its own."""
    g = torch.Generator(device=device)
    g.manual_seed(_stream_key(seed, w, rank))
    return g


# Closest-hit routes whose level reads nothing back to the host: on the
# card the whole level (the refill glue, the bounce, the record glue)
# replays as one CUDA graph, whether the bounce is the external-hit kernel
# (K3's cap entry, the route, K3) or the reference engine's bounce
# (`wavefront._bounce`, its mesh hit on the route). A scene with no
# triangle BVH reads nothing either. The binned routes read the host once
# a round; their levels run the same glue kernels eagerly.
GRAPH_ROUTES = trace_mod.GRAPH_ROUTES


@dataclasses.dataclass
class MeshContext:
    """What the unfused window reads, on the render device: the scene
    tables of `ops/trace.to_device` (`ms`), the background, the camera
    (`arrays`, its vectors as tensors on the device, and `cam_row`, the
    glue kernel's packed row) and for the external-hit bounce (`ext`) the
    packed kernel tables and statics and the triangle tables (`tri`).
    `mesh` (with "auto" resolved by `ops/trace.resolve_route`), `b1_fused`
    and `traverse8` pick a BVH mesh's closest-hit route
    (`ops/trace.mesh_closest`); `counters` gathers calls, rounds and host
    reads of the intersector.

    `bounce_level` is the window's bounce: `mesh_bounce` (the dense cap,
    the mesh walk, then K3 on its winner, through `k3`, the launch
    prepared once for the scene, and `tri`, the triangle tables it
    gathers from) where `ext`, else the reference engine's
    `integrator/wavefront._bounce`, as the JAX package picks its
    `bounce_fn`.

    `graph`: the window's levels replay as a CUDA graph (on the card, on a
    route of GRAPH_ROUTES or a scene with no triangle BVH, with the glue
    kernel: a plain glue swapped in for it reads the host). `levels`
    keeps the window's buffers
    (`_MeshLevels`) from one window to the next."""

    ms: object
    tables: Optional[tuple]
    statics: Optional[dict]
    bg: torch.Tensor
    arrays: camera_mod.CameraArrays
    cam_row: torch.Tensor
    mesh: str = "walk"
    b1_fused: bool = False
    traverse8: bool = True
    counters: dict = dataclasses.field(default_factory=dict)
    ext: bool = True
    tri: Optional[bounce_mod.TriTable] = None
    k3: Optional[bounce_mod.K3Launch] = None
    cap_buf: Optional[torch.Tensor] = None
    graph: bool = False
    levels: Optional["_MeshLevels"] = None

    @property
    def route(self) -> dict:
        return dict(mesh=self.mesh, b1_fused=self.b1_fused,
                    traverse8=self.traverse8)

    @staticmethod
    def build(scene: T.Scene, cam: camera_mod.Camera, device,
              mesh: str = "auto", b1_fused: bool = False,
              traverse8: bool = True, ext: bool = True) -> "MeshContext":
        """Raises ValueError when the scene's tables cannot run the
        route (`ops/trace.check_route`) and, with `ext`, when the scene
        has no triangle BVH."""
        device = torch.device(device)
        to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        ms = trace_mod.to_device(scene, device)
        if scene.has_tri_bvh:
            trace_mod.check_route(ms.tri_bvh, mesh, b1_fused=b1_fused,
                                  traverse8=traverse8)
        elif ext:
            raise ValueError("the external-hit bounce needs a triangle BVH")
        tables = statics = tri = k3 = None
        bg = to_dev(np.asarray(scene.background, np.float32))
        if ext:
            statics = bounce_mod.scene_statics(scene, ext=True)
            tables = tuple(to_dev(t) for t in bounce_mod.pack_scene(scene))
            tri_mat = to_dev(bounce_mod.tri_mat_table(scene, statics))
            tri = bounce_mod.TriTable.build(ms.triangles, tri_mat)
            k3 = bounce_mod.K3Launch(tables, statics, bg, tri)
        arrays = cam.derived().to(device)
        route = trace_mod.resolve_route(mesh, b1_fused)
        return MeshContext(
            ms=ms, tables=tables, statics=statics, bg=bg, arrays=arrays,
            cam_row=mesh_level_mod.pack_camera(arrays, device), mesh=route,
            b1_fused=b1_fused, traverse8=traverse8, ext=ext, tri=tri, k3=k3,
            graph=device.type == "cuda" and mesh_level_mod.kernel_glue()
            and (route in GRAPH_ROUTES or not scene.has_tri_bvh))

    def bounce_level(self, o, d, t, alive, u, out=None):
        """One bounce of the window's lanes: (E, W, cf, new_o, new_d,
        alive'); `out` (`ops/bounce.bounce_out`) is used by the ext
        bounce only."""
        if self.ext:
            return mesh_bounce(self, o, d, t, alive, u, out)
        return wavefront._bounce(
            self.ms, o, d, t, alive, u, counters=self.counters,
            route=self.route if self.ms.has_tri_bvh else None)

    @property
    def n_u(self) -> int:
        return bounce_mod.N_U + self.ms.media.kind.shape[0] \
            * int(self.ms.has_media)


def mesh_bounce(ctx: MeshContext, o, d, t, alive, u, out=None):
    """One bounce level of a mesh scene: the dense classes' nearest hits
    cap the mesh traversal (the cross-class shrinking rayT.Max; one launch
    of K3's cap entry on the card), the mesh closest hit on the context's
    route gives each lane's winning triangle, and K3 gathers that winner
    and does the rest. Returns (E, W, cf, new_o, new_d, alive'), in `out`
    where given (`bounce_out`)."""
    n = o.shape[0]
    if ctx.cap_buf is None or ctx.cap_buf.shape[0] != n \
            or ctx.cap_buf.device != o.device:
        ctx.cap_buf = torch.empty(n, dtype=torch.float32, device=o.device)
    t_cap = ctx.k3.cap(ctx.ms, o, d, t,
                       out=ctx.cap_buf if o.is_cuda else None)
    t_h, i_h = trace_mod.mesh_closest(ctx.ms, o, d, t_cap=t_cap, alive=alive,
                                      counters=ctx.counters, **ctx.route)
    hit = bounce_mod.MeshHit(t_h, i_h if i_h.dtype == torch.int32
                             else i_h.to(torch.int32))
    return ctx.k3(o, d, t, alive, u, ext=hit, out=out)[:6]


def _init_state_mesh(n: int, device):
    """Fresh lane-pool state of the mesh path: o, d (N, 3), time (N,)
    float32, alive (N,) bool, bounces done (N,) int32."""
    d = torch.zeros((n, 3), dtype=torch.float32, device=device)
    d[:, 2] = 1.0
    return [torch.zeros((n, 3), dtype=torch.float32, device=device), d,
            torch.zeros(n, dtype=torch.float32, device=device),
            torch.zeros(n, dtype=torch.bool, device=device),
            torch.zeros(n, dtype=torch.int32, device=device)]


def queue_refill_planes(next_item, alive_i32, item_end: int, *, width: int,
                        npix: int, sqrt_spp: int):
    """The refill of the `queue` schedule as the planes `bounce_fused`
    takes: which lanes start a path (int32), and their pixel column, pixel
    row, stratum row and stratum column (float32), from `refill_assign`."""
    take, _, pid, s_i, s_j = refill_assign(
        next_item, alive_i32 > 0, True, item_end, npix=npix,
        sqrt_spp=sqrt_spp)
    pj = torch.div(pid, width, rounding_mode="floor")
    return (take.to(torch.int32), (pid - pj * width).to(torch.float32),
            pj.to(torch.float32), s_i, s_j)


class _MeshLevels:
    """The levels of mesh windows on fixed buffers: the lane state and
    uniforms of `ops/mesh_level.MeshLevel`, the bounce's outputs and the
    record planes and bases of `bufs`. `step` draws a level's uniforms
    from the window's generator (u_cam, then u, as `torch.rand` draws
    them) and runs the level: the refill glue, `ctx.bounce_level`, the
    record glue. With `ctx.graph` the first level runs eagerly (it loads
    every kernel), the second is captured as a CUDA graph
    (`ops/_cuda.Graph`, whose replays count the kernels' launches) and
    every later one replays it on the current stream, counted in
    ctx.counters["replays"]. A capture or launch that fails raises. `key`:
    the window arguments the buffers and the graph were made for."""

    def __init__(self, ctx: MeshContext, bufs: WindowBuffers, n: int,
                 device, *, window: int, max_depth: int, glue: dict, key):
        self.bufs, self.key = bufs, key
        self.lv = mesh_level_mod.MeshLevel.empty(n, window, ctx.n_u, device)
        self.out = bounce_mod.bounce_out(n, device) if ctx.ext else None
        self.base = bufs.base.view(-1)
        self.glue, self.max_depth = glue, max_depth
        self.graph, self.ran = None, False

    def body(self, ctx: MeshContext):
        lv = self.lv
        mesh_level_mod.refill(lv, ctx.arrays, ctx.cam_row, self.base,
                              **self.glue)
        res = ctx.bounce_level(lv.o, lv.d, lv.t, lv.alive, lv.u, self.out)
        mesh_level_mod.record(lv, self.bufs.rec, *res[:6],
                              max_depth=self.max_depth)

    def step(self, ctx: MeshContext, gen):
        self.lv.u_cam.uniform_(generator=gen)
        self.lv.u.uniform_(generator=gen)
        if self.graph is None and ctx.graph and self.ran:
            graph = _cuda.Graph()
            with spans.span("render.capture"):
                graph.capture(lambda: self.body(ctx))
            self.graph = graph
        if self.graph is not None:
            self.graph.replay()
            ctx.counters["replays"] = ctx.counters.get("replays", 0) + 1
        else:
            self.body(ctx)
            self.ran = True


def _mesh_window(ctx: MeshContext, acc, state, next_item, gen,
                 item_end: int, *, width, npix, sqrt_spp, window, refill,
                 max_depth, max_contribution, bufs: WindowBuffers,
                 cadence: int = 1, item_base: int = 0):
    """One window of the `queue` schedule's unfused path over items
    [next_item, item_end), written to `acc` at rows relative to
    `item_base`: `window` levels of refill (at the levels of the first
    `refill` that are multiples of `cadence`), camera rays, one draw of
    uniforms and `ctx.bounce_level` (the ext-mode kernel on a mesh scene
    it carries, else the reference engine's bounce), recorded as V/FL
    planes (`ops/mesh_level`), then the harvest into `acc` (in place). The
    started lane's rank rides in FL bits 3.. and FL bit 2 marks the start,
    as `bounce_fused_q` writes them, so the harvest is the one of the
    in-kernel-queue path. `next_item` is an int or a device tensor.

    Nothing is read back inside a level: each level writes its counts
    (segments, lanes alive after it, the cursor) into a device plane, and
    the loop ends early once one shows every lane dead and nothing left to
    start, seen through `_DrainWatch` (at most `wavefront.RUN_AHEAD`
    levels ahead of the last one seen); levels run past that one trace
    nothing. The levels run on buffers kept in `ctx.levels` from one window
    to the next (as one CUDA graph where `ctx.graph`). Returns (state, the
    window's buffers: o, d, t, alive, depth; cur, an int64 device tensor
    [next item, segments traced, levels recorded], computed on the device;
    the number of levels run, at least the levels recorded)."""
    n = state[0].shape[0]
    dev = state[0].device
    glue = dict(item_end=item_end, refill=refill, cadence=cadence,
                width=width, npix=npix, sqrt_spp=sqrt_spp)
    key = (n, dev, window, max_depth, tuple(glue.values()),
           bufs.rec[0].data_ptr(), bufs.base.data_ptr(), ctx.graph)
    if ctx.levels is None or ctx.levels.key != key:
        ctx.levels = _MeshLevels(ctx, bufs, n, dev, window=window,
                                 max_depth=max_depth, glue=glue, key=key)
    levels = ctx.levels
    lv = levels.lv
    lv.begin(state, next_item)
    counts = lv.cnt[1:]
    M = mesh_level_mod
    watch = _DrainWatch(counts, lambda row, s: row[M.ALIVE_AFTER] == 0 and (
        s + 1 >= refill or row[M.CURSOR] >= item_end),
        ahead=wavefront.RUN_AHEAD)
    n_run = 0
    for s in range(window):
        levels.step(ctx, gen)
        n_run = s + 1
        watch.record(s)
        if watch.drained():
            break
    spans.add("calls", n_run)
    spans.add("wait_ns", watch.wait_ns)
    # the harvest runs over every level run: a level past the drained one
    # records only dead lanes (zero V, no flags), which add nothing
    harvest_mod.harvest_levels_into(
        acc, *(r[:n_run] for r in bufs.rec), bufs.base.reshape(-1),
        item_base=item_base, s_run=n_run, refill_levels=refill,
        max_contribution=max_contribution)
    run = counts[:n_run]
    drained = (run[:, M.ALIVE_AFTER] == 0) & (
        (torch.arange(1, n_run + 1, device=dev) >= refill)
        | (run[:, M.CURSOR] >= item_end))
    recorded = torch.where(drained.any(),
                           drained.to(torch.int64).argmax() + 1, n_run)
    cur = torch.stack([run[-1, M.CURSOR].to(torch.int64),
                       run[:, M.SEGMENTS].sum(dtype=torch.int64), recorded])
    return lv.state, cur, n_run


def _pos_window_unfused(ctx: MeshContext, B, state, quota, lane_base,
                        first_pix, gen, *, width, n_strata, sqrt_spp, G,
                        window, refill, cadence, max_depth,
                        max_contribution):
    """One window of the `positional` schedule's unfused path (the JAX
    package's `_window_impl_pos` off its fused kernel): at every level
    that is a multiple of `cadence` among the first `refill`, a dead lane
    with items left starts its next one, item lane_base + k (pixel-major:
    pixel item // n_strata, stratum item % n_strata), on a camera ray from
    `gen`; then one draw of uniforms and `ctx.bounce_level`, recorded as
    E, W, clamp flag and started flag. The reverse scan runs the clamp
    recursion per lane and, at each cadence block's start, counts the
    lane's starts back down to find the path's pixel slot g = pixel -
    first_pix in [0, G), and adds L into B[:, g] (B: (3, G, N), in
    place). `state` = [o, d, t, alive, depth, k] (k int64, the starts so
    far); `quota`, `lane_base`, `first_pix` are (N,) int64 tensors on the
    device. Returns (B, state, cur), cur an int64 device tensor [starts
    so far over all lanes, segments traced, levels]."""
    o, d, t, alive, depth, k = state
    n = o.shape[0]
    arrays = ctx.arrays
    Es, Ws, CFs, STs = [], [], [], []
    segments = torch.zeros((), dtype=torch.int64, device=o.device)
    for s in range(window):
        if s < refill and s % cadence == 0:
            take = ~alive & (k < quota)
        else:
            take = torch.zeros_like(alive)
        item = lane_base + k
        pid = torch.div(item, n_strata, rounding_mode="floor")
        stratum = item - pid * n_strata
        s_i = torch.div(stratum, sqrt_spp, rounding_mode="floor")
        u_cam = torch.rand((n, camera_mod.N_U_RAYGEN), generator=gen,
                           dtype=torch.float32, device=o.device)
        o_n, d_n, t_n = camera_mod.generate_rays(
            arrays, width, pid, s_i.to(torch.float32),
            (stratum - s_i * sqrt_spp).to(torch.float32), u_cam)
        o = torch.where(take[:, None], o_n, o)
        d = torch.where(take[:, None], d_n, d)
        t = torch.where(take, t_n, t)
        k = k + take.to(torch.int64)
        depth = torch.where(take, torch.zeros_like(depth), depth)
        alive = alive | take
        u = torch.rand((n, ctx.n_u), generator=gen, dtype=torch.float32,
                       device=o.device)
        E, W, cf, o_n, d_n, alive_n = ctx.bounce_level(o, d, t, alive, u)
        dead = ~alive
        Es.append(torch.where(dead[:, None], 0.0, E))
        Ws.append(torch.where(dead[:, None], 0.0, W))
        CFs.append(cf & alive)
        STs.append(take)
        segments = segments + alive.sum()
        # depth cap (camera.go:293-296): a path gets max_depth + 1 levels
        alive_n = alive_n & (depth < max_depth)
        depth = torch.where(alive, depth + 1, depth)
        o, d, alive = o_n, d_n, alive_n
    spans.add("calls", window)

    L = torch.zeros((n, 3), dtype=torch.float32, device=o.device)
    cnt = k
    slots = torch.arange(G, device=o.device)[:, None]
    for s in reversed(range(window)):
        raw = Es[s] + Ws[s] * L
        L = torch.where(CFs[s][:, None],
                        wavefront.clamp_contribution(raw, max_contribution),
                        raw)
        if s % cadence:
            continue
        started = STs[s]
        cnt = cnt - started.to(torch.int64)
        g = torch.div(lane_base + cnt, n_strata, rounding_mode="floor") \
            - first_pix
        hit = started[None, :] & (g[None, :] == slots)      # (G, N)
        B += torch.where(hit[None], L.t()[:, None, :], 0.0)
        L = torch.where(started[:, None], 0.0, L)
    cur = torch.stack([k.sum(), segments,
                       segments.new_full((), window)])
    return B, [o, d, t, alive, depth, k], cur


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
        with spans.span("render.sync"):
            vals = [int(x) for x in cur.tolist()]        # one readback
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


@dataclasses.dataclass
class Shard:
    """A rank's place in a sharded render: rank `index` of the `count`
    ranks of the process group `group` (None: the default group)."""

    index: int
    count: int
    group: object = None

    def lockstep(self, dispatch, cursor_base: int, device):
        """`dispatch` for `_window_pipeline` in lockstep over the group:
        after this rank's window, one int64 tensor on the device [items
        started over all ranks, segments over all ranks, levels] is summed
        over the group (on NCCL the host does not wait for it) and is read
        one window late, as the pipeline reads a one-device window. Every
        rank makes the same decisions from the same sums, so every rank
        runs, and joins the reduction of, every window: a rank whose
        items have all started runs windows that start nothing until the
        last rank's items have. `cursor_base` is where this rank's cursor
        (cur[0]) starts. Returns (the wrapped dispatch, a 0-d int64 device
        tensor counting this rank's segments)."""
        seg = torch.zeros((), dtype=torch.int64, device=device)

        def run(wi):
            cur = dispatch(wi).to(device)
            seg.add_(cur[1])
            red = torch.stack([cur[0] - cursor_base, cur[1], cur[2]])
            dist.all_reduce(red, group=self.group)
            return red
        return run, seg

    def gather(self, t):
        """Every rank's `t`, stacked in rank order: (count, *t.shape), on
        every rank."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.count)]
        dist.all_gather(parts, t, group=self.group)
        return torch.stack(parts)


def _assemble_image(acc, *, total_items, n_strata, npix, h, w):
    """Mean over strata (item = stratum * npix + pixel) -> (h, w, 3)."""
    return acc[:total_items].reshape(n_strata, npix, 3).mean(dim=0) \
        .reshape(h, w, 3)


@spans.traced("render")
def render_regen(scene: T.Scene, cam: camera_mod.Camera, seed: int = 0,
                 n_lanes: int = 1 << 17, refill_len: int = 0,
                 cadence: int = 0, schedule: str = "auto", device=None,
                 mesh: str = "auto", b1_fused: bool = False,
                 traverse8: bool = True, direct_rec: bool = False,
                 backend: str = "auto", reorder="auto",
                 checkpoint_path=None, checkpoint_every: int = 4,
                 scene_name: str = "", verbose: bool = False,
                 shard: Optional["Shard"] = None,
                 graph: Optional[bool] = None):
    """Render the full image with ray regeneration on `device` (default
    CUDA; "cpu" runs the kernels' plain versions). Returns (linear image
    (H, W, 3) float32 numpy, stats).

    `backend` picks the bounce, as the JAX package's does: "auto" and
    "pallas" the fused kernels where they carry the scene
    (`ops/bounce.supported`), else on a BVH mesh the external-hit kernel
    where it carries the scene (`supported_ext`), else the reference
    engine's bounce (`integrator/wavefront._bounce`); "xla" that bounce on
    every scene. "pallas" on a scene no kernel carries raises.

    On the fused kernels, `schedule` "auto" or "queue_ik" runs the
    in-kernel queue (stats["schedule"] == "queue_ik"): `refill_len` 0
    sizes the window to the workload (`_auto_refill`), `cadence` 0 takes
    the scene's hint. On request it runs "queue" (the refill in plain
    tensor code before each `bounce_fused` call) or "positional" (static
    per-lane item blocks, `bounce_fused_pos`); for both, `refill_len` 0
    means 4 * (max_depth + 1). There is no `harvest` argument: "queue"
    always harvests through the `reverse_harvest` kernel, which the JAX
    package's tests show bit-identical to its scan-and-sort epilogue.
    Off the fused kernels (a mesh, triangle lights, backend "xla") the
    window is unfused and its bounce is `MeshContext.bounce_level`;
    "auto" and "queue" run `_mesh_window` (the refill, camera rays and
    records as the glue kernel of `ops/mesh_level`, the external-hit
    kernel where it carries the scene, on the walk and binned2 routes one
    CUDA graph a level; stats["mesh"]["graph"] says which and
    stats["mesh"]["replays"] counts the replays; stats["levels"] counts
    the levels recorded, up to each window's drain, and
    stats["levels_run"] the levels run, which may go past it on the
    card), "positional" runs `_pos_window_unfused`
    (the reference engine's bounce, as in the JAX package); "queue_ik"
    raises. A scene
    with a triangle BVH there runs at most `MESH_MAX_LANES` lanes at
    cadence 1, and `mesh` ("auto", "binned", "binned2" or "walk"; "auto"
    is the walk, or binned with `b1_fused`), `b1_fused` (binned only) and
    `traverse8` (walk only) pick its closest-hit route
    (`ops/trace.mesh_closest`; stats["mesh"]["route"] names it); on a
    scene without a mesh they stay at their defaults. `direct_rec` runs
    `queue_ik` through `bounce_fused_q_direct`. A route or option the
    scene cannot run raises ValueError; nothing falls back to another.

    `reorder` True runs the lane coherence sort (`coherence_sort` before
    every `bounce_fused` call, the harvest unwinding it): on the fused
    kernels only, where "auto" then resolves to `queue`, the JAX package's
    resolution; with "queue_ik", "positional" or `direct_rec`, and off the
    fused kernels, it raises ValueError where the JAX package quietly
    drops it. "auto" (the JAX package's "auto" is off) and False leave it
    off. The image agrees with the unsorted one statistically, not bit
    for bit: the kernels key their random numbers on the lane's position.
    Checkpoint/resume: between windows no path is in flight, so
    (accumulator, cursor, window count) is a consistent checkpoint, and a
    matching one resumes where it stopped; "positional" stores its (3, G,
    N) accumulator and the per-lane start counts `k`.

    `shard` (`render_regen_sharded` passes it) renders one rank's share of
    a sharded render and returns the whole image on every rank.

    `graph` (the unfused `_mesh_window` only): None replays each level as
    a CUDA graph wherever `MeshContext.build` allows it (stats["graph"]
    says whether it did), False runs the levels eagerly, True raises
    ValueError where no level can be captured.

    The call records the spans of `utils/spans.py`: the root "render",
    and in it "render.setup" (with "render.setup.scene": the scene's
    tables packed and uploaded, or `MeshContext.build`), "render.windows"
    (the window loop to its last synchronize; its counts `windows` and
    `calls`, the kernel calls of the fused path or the levels run off it,
    which stats["windows"] and stats["calls"] repeat, and `wait_ns`, the
    host's ns waiting for a level `wavefront.RUN_AHEAD` levels back on the
    mesh path; stats["elapsed_s"] is its duration), "render.assemble"
    (the image to the host) and "render.check" (the stats). In the loop,
    "render.sync" is each read of a window's counts and the synchronize
    after the last, and "render.capture" each level graph's capture."""
    from go_raytracer_tpu_torch.render import checkpoint as checkpoint_mod
    from go_raytracer_tpu_torch.utils import progress

    setup = spans.span("render.setup").start()
    if direct_rec and scene.has_image:
        raise ValueError(
            "direct_rec: the direct-record path excludes scenes with image "
            "textures, as in the JAX package")
    if shard and checkpoint_path:
        raise ValueError("a sharded render keeps no checkpoint")
    if backend not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown backend {backend!r}")
    if reorder != "auto" and not isinstance(reorder, bool):
        raise ValueError(f"reorder must be 'auto', True or False, not "
                         f"{reorder!r}")
    reorder = reorder is True
    # the JAX package's choice: the fused kernels where they carry the
    # scene, else the external-hit kernel on a BVH mesh it carries, else
    # (and always with backend "xla") the reference engine's bounce
    use_fused = backend != "xla" and bounce_mod.supported(scene)
    use_ext = (backend != "xla" and not use_fused and scene.has_tri_bvh
               and bounce_mod.supported_ext(scene))
    if backend == "pallas" and not (use_fused or use_ext):
        raise NotImplementedError(
            "backend 'pallas': no kernel carries this scene ("
            + ", ".join(bounce_mod.refused_features(scene)) + ")")
    if not scene.has_tri_bvh and (mesh != "auto" or b1_fused
                                  or not traverse8):
        raise ValueError("mesh, b1_fused and traverse8 pick the closest-hit "
                         "route of a mesh scene; this scene has no mesh")
    if reorder and not use_fused:
        raise ValueError(
            "reorder=True: the lane coherence sort runs on the fused "
            "kernels' 'queue' schedule, and no fused kernel carries this "
            "scene with this backend (a mesh, triangle lights or backend "
            "'xla'), where the JAX package drops the sort")
    if reorder and (schedule in ("queue_ik", "positional") or direct_rec):
        raise ValueError(
            f"reorder=True runs the 'queue' schedule, not "
            f"{'direct_rec' if direct_rec else repr(schedule)}: the JAX "
            "package's sort turns the in-kernel queue off, and positional "
            "lanes own fixed item blocks")
    if schedule not in (("auto", "queue_ik", "queue", "positional")
                        if use_fused else ("auto", "queue", "positional")):
        raise NotImplementedError(
            f"schedule {schedule!r}: scenes on the fused kernels run "
            "'queue_ik' (auto), 'queue' or 'positional'; the others (mesh "
            "scenes, backend 'xla') the unfused 'queue' (auto) or "
            "'positional', where the JAX package quietly runs 'queue' for "
            "'queue_ik' (ROADMAP.md)")
    if schedule == "auto":
        schedule = "queue" if reorder \
            else "queue_ik" if use_fused else "queue"
    # off the fused kernels the positional level is the reference
    # engine's bounce on every scene, as in the JAX package
    use_ext = use_ext and schedule != "positional"
    if direct_rec and schedule != "queue_ik":
        raise ValueError(f"direct_rec is an option of the queue_ik "
                         f"schedule, not of {schedule!r}")
    if n_lanes % bounce_mod.BLOCK:
        raise ValueError(f"n_lanes must be a multiple of {bounce_mod.BLOCK}")
    device = resolve_device(device)
    cadence = _resolve_cadence(cadence, cam)
    arrays = cam.derived()
    defocus = arrays.defocus_angle > 0
    h, w = cam.image_height, cam.width
    npix = h * w
    sqrt_spp = cam.spp_sqrt
    n_strata = sqrt_spp * sqrt_spp
    total_items = npix * n_strata
    d1 = cam.max_depth + 1
    n = n_lanes
    unfused = not use_fused
    n_rank, rank = (shard.count, shard.index) if shard else (1, 0)
    # this rank's items [item_base, item_end), as the JAX package splits them
    chunk = -(-total_items // n_rank)
    item_base = min(rank * chunk, total_items)
    item_end = min(item_base + chunk, total_items)
    refill = refill_len or (
        _auto_refill(chunk, n, d1, cadence, cam)
        if schedule == "queue_ik" else 4 * d1)
    if unfused and scene.has_tri_bvh:
        # the JAX package's mesh-scene settings off the fused kernels
        n = min(n, MESH_MAX_LANES)
        cadence = 1
    window = -(-(refill + d1) // cadence) * cadence
    outer = window // cadence
    positional = schedule == "positional"

    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    if unfused:
        with spans.span("render.setup.scene"):
            ctx = MeshContext.build(scene, cam, device, mesh=mesh,
                                    b1_fused=b1_fused, traverse8=traverse8,
                                    ext=use_ext)
        ctx.graph = ctx.graph and not positional and graph is not False
        state = _init_state_mesh(n, device)
    else:
        with spans.span("render.setup.scene"):
            tables = tuple(to_dev(t) for t in bounce_mod.pack_scene(scene))
            statics = bounce_mod.scene_statics(scene)
            cam_row = to_dev(bounce_mod.pack_camera(arrays))
            bg = to_dev(np.asarray(scene.background, np.float32))
        state = _init_state(n, device)
        bounds = tuple(to_dev(b) for b in bounce_mod.coherence_bounds(scene)) \
            if reorder else None
    if graph and not (unfused and ctx.graph):
        raise ValueError(
            "graph=True: this render has no level a CUDA graph can capture "
            "(the fused kernels, `positional`, a binned route, the CPU or "
            "the plain glue)")
    if unfused:
        bufs = None if positional else WindowBuffers.empty(n, window, 1,
                                                           device)
    elif schedule in ("queue", "positional"):
        bufs = SchedBuffers.empty(
            n, outer, cadence, device,
            None if positional else -(-refill // cadence), reorder=reorder)
    else:
        bufs = WindowBuffers.empty(n, outer, cadence, device)
    n_windows = 0
    meta = checkpoint_mod.meta_for(scene_name, cam)
    meta["lanes"] = n
    bar = progress.Bar(total_items, enabled=verbose)

    start_i = 0
    k_resume = None
    if positional:
        # a sharded render's global pool of n_rank * n lanes: this rank
        # runs its slice of the lanes' blocks
        quota, lane_base, first_pix, G = pos_tables(npix, n_strata,
                                                    n_rank * n)
        lanes = slice(rank * n, (rank + 1) * n)
        quota, lane_base = quota[lanes], lane_base[lanes]
        acc = torch.zeros((3, G, n), dtype=torch.float32, device=device)
        meta["schedule"] = np.bytes_(b"positional")
    else:
        # `n_lanes` tail rows absorb the plain harvest's row-tail writes
        acc = torch.zeros((chunk + n, 3), dtype=torch.float32,
                          device=device)
    if checkpoint_path:
        loaded = checkpoint_mod.load(checkpoint_path)
        if loaded is not None \
                and checkpoint_mod.compatible(loaded[2], meta) \
                and loaded[0].shape == tuple(acc.shape) \
                and loaded[2].get("schedule") == meta.get("schedule"):
            k = checkpoint_mod.load_extra(checkpoint_path).get("k") \
                if positional else None
            if not positional or (k is not None and k.shape == (n,)):
                acc.copy_(torch.from_numpy(loaded[0]).to(torch.float32))
                start_i = int(loaded[1])
                n_windows = int(loaded[2].get("windows", 0))
                k_resume = k
    if positional and unfused:
        quota_dev = torch.from_numpy(quota).to(device)
        lane_base_dev = torch.from_numpy(lane_base).to(device)
        first_pix_dev = torch.from_numpy(first_pix[lanes]).to(device)
        state = state + [torch.zeros(n, dtype=torch.int64, device=device)
                         if k_resume is None else
                         torch.from_numpy(np.asarray(k_resume, np.int64))
                         .to(device)]
    elif positional:
        state = _init_state_pos(n, device, quota, lane_base, n_strata, w,
                                k=k_resume)
        quota_dev = torch.from_numpy(quota).to(device)
        first_pix_dev = torch.from_numpy(
            first_pix[lanes].astype(np.float32)).to(device)
    bar.tick(start_i)
    next_dev = torch.tensor([item_base + start_i], dtype=torch.int32,
                            device=device)

    # the mesh window's cursor and its levels recorded, on the device
    next_mesh = torch.tensor(item_base + start_i, dtype=torch.int64,
                             device=device)
    levels_recorded = torch.zeros((), dtype=torch.int64, device=device)

    def dispatch_mesh(wi):
        nonlocal state, next_mesh
        state, cur, n_run = _mesh_window(
            ctx, acc, state, next_mesh,
            window_generator(seed, wi, device, rank), item_end, width=w,
            npix=npix, sqrt_spp=sqrt_spp, window=window, refill=refill,
            max_depth=cam.max_depth, max_contribution=cam.max_contribution,
            bufs=bufs, cadence=cadence, item_base=item_base)
        # levels run: each launched every kernel of the level once
        ctx.counters["levels"] = ctx.counters.get("levels", 0) + n_run
        levels_recorded.add_(cur[2])
        next_mesh = cur[0]
        return cur

    def dispatch_pos_unfused(wi):
        nonlocal state
        _, state, cur = _pos_window_unfused(
            ctx, acc, state, quota_dev, lane_base_dev, first_pix_dev,
            window_generator(seed, wi, device, rank), width=w,
            n_strata=n_strata,
            sqrt_spp=sqrt_spp, G=G, window=window, refill=refill,
            cadence=cadence, max_depth=cam.max_depth,
            max_contribution=cam.max_contribution)
        ctx.counters["levels"] = ctx.counters.get("levels", 0) + window
        return cur

    def dispatch(wi):
        nonlocal next_dev
        seeds = window_seeds(seed, wi, outer, rank)
        _, _, cur = _window_impl(
            tables, statics, cam_row, bg, acc, state, next_dev, seeds,
            item_base, item_end, width=w, npix=npix, sqrt_spp=sqrt_spp,
            window=window, refill=refill, cadence=cadence,
            max_depth=cam.max_depth, max_contribution=cam.max_contribution,
            has_defocus=defocus, bufs=bufs, direct_rec=direct_rec)
        next_dev = cur[0:1].to(torch.int32)
        return cur

    def device_seeds(wi):
        seeds = window_seeds(seed, wi, outer, rank)
        # pinned + non_blocking: a pageable copy would wait for the stream
        return (seeds.pin_memory() if device.type == "cuda" else seeds) \
            .to(device, non_blocking=True)

    next_q = torch.tensor(item_base + start_i, dtype=torch.int64,
                          device=device)

    def dispatch_queue(wi):
        nonlocal next_q
        _, _, cur = _queue_window(
            tables, statics, cam_row, bg, acc, state, next_q,
            device_seeds(wi), item_base, item_end, width=w, npix=npix,
            sqrt_spp=sqrt_spp, window=window, refill=refill, cadence=cadence,
            max_depth=cam.max_depth, max_contribution=cam.max_contribution,
            has_defocus=defocus, bufs=bufs, reorder=bounds)
        next_q = cur[0]
        return cur

    def dispatch_pos(wi):
        return _pos_window(
            tables, statics, cam_row, bg, acc, state, quota_dev,
            first_pix_dev, device_seeds(wi), width=w, sqrt_spp=sqrt_spp, G=G,
            window=window, refill=refill, cadence=cadence,
            max_depth=cam.max_depth, max_contribution=cam.max_contribution,
            has_defocus=defocus, bufs=bufs)[2]

    def checkpoint_cb(ni, nw):
        meta["windows"] = nw
        if positional:
            k = state[5].cpu().numpy().astype(np.int32) if unfused \
                else _pos_state_k(state, quota)
            checkpoint_mod.save(checkpoint_path, acc.cpu().numpy(), ni, meta,
                                extra={"k": k})
        else:
            checkpoint_mod.save(checkpoint_path, acc.cpu().numpy(), ni, meta)

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup.end()
    with spans.span("render.windows", calls=0, wait_ns=0) as loop:
        if unfused:
            dispatch_fn = dispatch_pos_unfused if positional \
                else dispatch_mesh
        else:
            dispatch_fn = {"queue_ik": dispatch, "queue": dispatch_queue,
                           "positional": dispatch_pos}[schedule]
        if shard:
            dispatch_fn, seg_rank = shard.lockstep(
                dispatch_fn, 0 if positional else item_base, device)
        next_i, segments, n_windows, window_times = _window_pipeline(
            dispatch_fn,
            total_items, n_windows, bar,
            checkpoint_cb=checkpoint_cb if checkpoint_path else None,
            checkpoint_every=checkpoint_every, start_i=start_i)
        loop.counts["windows"] = n_windows
        if device.type == "cuda":
            with spans.span("render.sync"):
                torch.cuda.synchronize(device)
        bar.close()
    elapsed = loop.ns / 1e9

    with spans.span("render.assemble"):
        if positional:
            if shard:
                # (n_rank, 3, G, n) -> (3, G, n_rank * n), lane r * n + i
                acc = shard.gather(acc).permute(1, 2, 0, 3).reshape(
                    3, G, n_rank * n)
            linear = pos_film(acc.cpu().numpy(), first_pix, npix, n_strata,
                              h, w)
        else:
            if shard:
                acc = shard.gather(acc[:chunk]).reshape(n_rank * chunk, 3)
            linear = _assemble_image(acc, total_items=total_items,
                                     n_strata=n_strata, npix=npix, h=h,
                                     w=w).cpu().numpy()
    with spans.span("render.check"):
        stats = {
            "elapsed_s": elapsed,
            "segments": segments,
            "paths": total_items,
            "rays_per_s": segments / elapsed if elapsed > 0
            else float("nan"),
            "paths_per_s": total_items / elapsed if elapsed > 0
            else float("nan"),
            "windows": n_windows,
            "calls": loop.counts["calls"],
            "window_s": window_times,
            "schedule": schedule,
            "occupancy": segments / max(n_windows * window * n * n_rank, 1),
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "nonfinite": int((~np.isfinite(linear)).sum()),
        }
        stats["backend"] = "pallas" if use_fused or use_ext else "xla"
        if unfused:
            stats["lanes"] = n
            stats["levels_run"] = ctx.counters.pop("levels", 0)
            stats["levels"] = (stats["levels_run"] if positional
                               else int(levels_recorded))
            stats["bounce"] = "ext" if use_ext else "wavefront"
            stats["graph"] = ctx.graph
            if scene.has_tri_bvh:
                stats["mesh"] = dict(
                    ctx.counters, route=trace_mod.route_name(**ctx.route),
                    graph=ctx.graph)
        if schedule == "queue_ik":
            stats["direct_rec"] = direct_rec
        if schedule == "queue" and use_fused:
            stats["reorder"] = reorder
        if shard:
            per = shard.gather(seg_rank.reshape(1)).reshape(-1).tolist()
            stats.update(devices=n_rank, segments_per_shard=per,
                         work_balance=min(per) / max(max(per), 1))
    return linear, stats


def render_regen_sharded(scene: T.Scene, cam: camera_mod.Camera, mesh,
                         seed: int = 0, n_lanes: int = 1 << 17,
                         refill_len: int = 0, cadence: int = 0,
                         backend: str = "auto", reorder="auto",
                         schedule: str = "auto", device=None,
                         mesh_route: str = "auto", direct_rec: bool = False):
    """`render_regen` over the ranks of a 1-D device mesh
    (`parallel/mesh.make_mesh(axes=("data",))`, or the JAX package's
    (n, 1) meshes): every rank of the mesh calls it with the same
    arguments and gets the whole image (H, W, 3) and the stats.

    Rank r owns the items [r * chunk, min((r + 1) * chunk, total)), chunk
    = ceil(total / ranks), and runs its own pool of `n_lanes` lanes over
    them on `device` (CUDA unless the caller asks for the CPU; the mesh's
    device type). Its window seeds and random streams are keyed by (seed,
    r, window), rank 0's as `render_regen`'s, so a one-rank mesh renders
    `render_regen`'s image and segments bit for bit. Under `positional`
    the global pool of ranks * n_lanes lanes owns the static item blocks
    (`pos_tables`) and rank r runs lanes [r * n_lanes, (r + 1) * n_lanes).
    No collective runs inside a window; after each, one small sum over
    the ranks (`Shard.lockstep`), read one window late; at the end one
    gather of the accumulators. Stats add `devices`,
    `segments_per_shard` and `work_balance` (the least over the most);
    `occupancy` counts every rank's lanes.

    Options as `render_regen`'s, with its "auto" resolution and its
    refusals; `mesh_route` is its `mesh` (the closest-hit route of a mesh
    scene). `reorder` True: each rank sorts its own lane pool
    (`render_regen`'s lane coherence sort, with its refusals)."""
    if any(k != 1 for k in mesh.shape[1:]):
        raise ValueError(f"render_regen_sharded expects a 1-D mesh, not "
                         f"one of shape {tuple(mesh.shape)}")
    device = resolve_device(device)
    if device.type != mesh.device_type:
        raise ValueError(f"the mesh's ranks run on {mesh.device_type}, "
                         f"the render on {device}")
    shard = Shard(index=mesh.get_local_rank(0), count=mesh.size(0),
                  group=mesh.get_group(0))
    return render_regen(scene, cam, seed=seed, n_lanes=n_lanes,
                        refill_len=refill_len, cadence=cadence,
                        schedule=schedule, device=device, mesh=mesh_route,
                        direct_rec=direct_rec, backend=backend,
                        reorder=reorder, shard=shard)
