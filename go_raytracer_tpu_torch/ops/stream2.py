"""The persistent binned intersector: a level's whole closest-hit
traversal in one launch.

Counterpart of the JAX package's `ops/pallas/stream2.stream2_rows`, the
kernel of `ops/trace.binned2_closest` (`mesh="binned2"`). The glue sorts the
rays once by (direction octant, origin Morton cell); each unit of `UNIT`
consecutive rays then loops rounds on its own until none of its rays has a
candidate cluster left:

1. each ray picks the lex-least (near, k) over the clusters of the finer
   `cl2_*` partition whose box its interval (T_MIN, t_best) hits and that
   the unit has not processed (`ops/stream.candidates`);
2. the unit takes a = the least pick and b = min(greatest pick,
   a + RANGE_W - 1);
3. every ray of the unit is streamed against the groups of clusters
   [a, b] (`ops/stream.stream_rows`' arithmetic);
4. clusters [a, b] are marked processed for the whole unit.

The processed set is the unit's, not the ray's, so it never rides a sort.
The JAX kernel's blocks are 1024 rays and its window 32 clusters; this
kernel's unit is a warp's width (`UNIT` = 32 rays, run by a team of `TEAM`
warps) and its window `RANGE_W`, all re-derived on the H100
(PERF.md §6). The unit and the window change the rounds a unit makes, not
the winners: each ray ends at the least t over the triangles, the first
group reaching it in streaming order on a tie across groups.

On CUDA tensors `stream2_rows` launches the hand-written kernel in
`csrc/stream2.cu` (persistent teams of warps pulling units from a device
counter); on CPU tensors it runs the plain version `stream2_rows_ref`,
which steps all units' rounds together.
"""

from __future__ import annotations

import ctypes

import torch

from go_raytracer_tpu_torch.ops import _cuda
from go_raytracer_tpu_torch.ops.stream import (candidates, stream_rows_ref,
                                               unpack_lines)

MAX_K2 = 1024       # cluster boxes the kernel holds in shared memory
UNIT = 32           # rays per unit: one ray per lane of a warp
RANGE_W = 2         # clusters a unit streams per round at most
MAX_ROUNDS = 4096   # backstop on a unit's rounds
# Warps that share one unit in the CUDA kernel (1, 2, 4 or 8): each scans a
# share of the clusters and streams a slice of each round's groups. Chosen
# on the H100 (PERF.md §6); results do not depend on it.
TEAM = 8

# Launches of the CUDA kernel through `stream2_rows` (one per call).
launches = 0


def boxes_lo_hi(box_lines: torch.Tensor, k2: int):
    """The packed cluster-box table (scene/clusters.pack_cluster_boxes) as
    (k2, 3) lo and hi, padding octet slots dropped."""
    e = unpack_lines(box_lines).reshape(-1, 16)[:k2]
    return e[:, 0:3].contiguous(), e[:, 3:6].contiguous()


def stream2_rows_ref(tri_lines, lo, hi, gs, ox, oy, oz, dx, dy, dz, t, idx,
                     *, unit=UNIT, range_w=None, work=None):
    """Plain PyTorch version of `stream2_rows` (same arguments, same
    results). `work` (a dict) receives what the traversal did: rounds per
    unit (a tensor), box tests (clear clusters scanned, summed over the
    rays and scans) and group tests (ray x group pairs streamed). Another
    `unit` or `range_w` (default `RANGE_W`) runs the same traversal in
    units of that many rays or with that window (the earlier kernel's
    schedule was 128 and 32): the same winners, other rounds and work."""
    range_w = RANGE_W if range_w is None else range_w
    n = ox.numel()
    units = n // unit
    k2 = lo.shape[0]
    dev = ox.device
    rays = (ox, oy, oz, dx, dy, dz)
    gs64 = gs.to(torch.int64)
    kid = torch.arange(k2, device=dev)
    proc = torch.zeros((units, k2), dtype=torch.bool, device=dev)
    rounds = torch.zeros(units, dtype=torch.int64, device=dev)
    running = torch.ones(units, dtype=torch.bool, device=dev)
    t_best, best = t.clone(), idx.clone()
    box_tests = group_tests = 0
    while bool(running.any()):
        if work is not None:
            box_tests += int(((~proc).sum(dim=1) * running).sum()) * unit
        # the scan, on the running units' rays only
        blk = torch.nonzero(running)[:, 0]
        lanes = (blk[:, None] * unit + torch.arange(unit, device=dev)) \
            .reshape(-1)
        pick, _ = candidates(lo, hi, *(r[lanes] for r in rays),
                             t_best[lanes],
                             proc[blk].repeat_interleave(unit, dim=0))
        pb = pick.view(-1, unit).to(torch.int64)
        kmin = torch.full((units,), k2, dtype=torch.int64, device=dev)
        kmax = torch.full((units,), -1, dtype=torch.int64, device=dev)
        kmin[blk] = pb.amin(dim=1)
        kmax[blk] = torch.where(pb < k2, pb, -1).amax(dim=1)
        running = running & (kmax >= 0) & (rounds < MAX_ROUNDS)
        if not bool(running.any()):
            break
        a = torch.where(running, kmin, 0)
        b = torch.minimum(torch.where(running, kmax, 0), a + range_w - 1)
        glo = torch.where(running, gs64[a], 0).to(torch.int32)
        ghi = torch.where(running, gs64[b + 1], 0).to(torch.int32)
        t_best, best = stream_rows_ref(tri_lines, glo, ghi, *rays, t_best,
                                       best, block=unit)
        proc |= running[:, None] & (kid[None, :] >= a[:, None]) \
            & (kid[None, :] <= b[:, None])
        rounds += running.to(torch.int64)
        if work is not None:
            group_tests += int((ghi - glo).sum()) * unit
    if work is not None:
        work.update(rounds=rounds, box_tests=box_tests,
                    group_tests=group_tests)
    return t_best, best


class _Stream2Args(ctypes.Structure):
    """Mirror of `Stream2Args` in csrc/stream2.cu (field for field)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "lines", "lo", "hi", "gs", "ox", "oy", "oz", "dx", "dy", "dz",
        "t_in", "idx_in", "t_out", "idx_out", "rounds", "counter")] + [
            (name, ctypes.c_int) for name in (
                "n_units", "k2", "range_w", "max_rounds", "team")]


def stream2_rows(tri_lines, lo, hi, gs, ox, oy, oz, dx, dy, dz, t, idx, *,
                 rounds=None):
    """The complete binned traversal of every unit of `UNIT` rays.

    tri_lines: the cl2 group table (8*L, 128) float32; lo, hi: (K2, 3)
    float32 cluster boxes, K2 <= `MAX_K2`; gs: (K2 + 1,) int32 group
    offsets. Ray planes, t (float32) and idx (int32): (N,), N a multiple of
    `UNIT`, in coherence-sorted order. Returns the new (t, idx); `rounds`
    (optional, (N / UNIT,) int32 on the device) receives each unit's
    rounds. CUDA tensors launch csrc/stream2.cu; CPU tensors run
    `stream2_rows_ref`."""
    n = ox.numel()
    k2 = lo.shape[0]
    if n % UNIT:
        raise ValueError(f"ray count {n} is not a multiple of {UNIT}")
    if not 0 < k2 <= MAX_K2 or lo.shape != (k2, 3) or hi.shape != (k2, 3):
        raise ValueError(f"lo/hi must be (K2, 3) with 0 < K2 <= {MAX_K2}")
    if gs.shape != (k2 + 1,):
        raise ValueError(f"gs must have shape ({k2 + 1},)")
    units = n // UNIT
    if not ox.is_cuda:
        work = {}
        out = stream2_rows_ref(tri_lines, lo, hi, gs, ox, oy, oz, dx, dy, dz,
                               t, idx,
                               work=work if rounds is not None else None)
        if rounds is not None:
            rounds.copy_(work["rounds"])
        return out

    f32, i32 = torch.float32, torch.int32
    if rounds is None:
        rounds = torch.empty(units, dtype=i32, device=ox.device)
    planes = [("ox", ox, f32), ("oy", oy, f32), ("oz", oz, f32),
              ("dx", dx, f32), ("dy", dy, f32), ("dz", dz, f32),
              ("t", t, f32), ("idx", idx, i32)]
    for name, x, dt in planes + [
            ("tri_lines", tri_lines, f32), ("lo", lo, f32), ("hi", hi, f32),
            ("gs", gs, i32), ("rounds", rounds, i32)]:
        if not x.is_cuda or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"{name}: needs a contiguous CUDA {dt} tensor")
    for name, x, _ in planes:
        if x.numel() != n:
            raise ValueError(f"{name}: {x.numel()} elements, expected {n}")
    if rounds.shape != (units,):
        raise ValueError(f"rounds must have shape ({units},)")
    if tri_lines.dim() != 2 or tri_lines.shape[1] != 128 \
            or tri_lines.shape[0] % 8:
        raise ValueError("tri_lines must be (8*L, 128)")
    t_out, idx_out = torch.empty_like(t), torch.empty_like(idx)
    if units == 0:
        return t_out, idx_out
    counter = torch.empty(1, dtype=i32, device=ox.device)
    p = lambda x: x.data_ptr()
    a = _Stream2Args(lines=p(tri_lines), lo=p(lo), hi=p(hi), gs=p(gs),
                     ox=p(ox), oy=p(oy), oz=p(oz), dx=p(dx), dy=p(dy),
                     dz=p(dz), t_in=p(t), idx_in=p(idx), t_out=p(t_out),
                     idx_out=p(idx_out), rounds=p(rounds), counter=p(counter),
                     n_units=units, k2=k2, range_w=RANGE_W,
                     max_rounds=MAX_ROUNDS, team=TEAM)
    err = _cuda.library("stream2").grt_stream2_rows(
        ctypes.addressof(a), torch.cuda.current_stream(ox.device).cuda_stream)
    if err:
        raise RuntimeError(f"stream2_rows launch failed: {_cuda.error_string(err)}")
    _cuda.count(globals(), "launches")
    return t_out, idx_out
