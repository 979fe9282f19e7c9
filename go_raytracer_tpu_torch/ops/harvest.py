"""The reverse harvest of a regen window: the per-level firefly-clamp
recursion run backwards over the recorded levels, each started path's
radiance landing in its accumulator slot.

Counterpart of the JAX package's `ops/pallas/harvest.reverse_harvest_levels`
plus the accumulator row scan of its regen window (`write_row_ik`).

* `harvest_levels_into(acc, ...)` is the main-path entry point. On a CUDA
  tensor it launches the hand-written kernel in `csrc/harvest.cu`, which
  writes each started path straight to its item slot (the slot's rank
  rides in the flag word from `bounce_fused_q`). On a CPU tensor it runs
  the plain version: `reverse_harvest_levels_ref` + `write_rows_ref`.
* `reverse_harvest_levels_ref` keeps the JAX kernel's output, one
  compacted row of started-lane radiances per refill level, so the tests
  compare it row by row.

Record planes are level-major (S, N): level s of a window is row s, the
(outer, cadence, N) layout of the JAX package flattened.
"""

from __future__ import annotations

import ctypes

import torch

# Launches of the CUDA kernel through `harvest_levels_into` (one per call).
launches = 0


def reverse_harvest_levels_ref(Vr, Vg, Vb, FL, *, refill_levels,
                               max_contribution, s_run=None):
    """Plain PyTorch version of the JAX kernel: returns (hr, hg, hb), each
    (refill_levels, N) float32, row s holding level s's started lanes'
    finished radiances packed to the row front in lane order (zeros
    after). Only the first `s_run` levels (default: all) are read; later
    levels are all-zero records in the JAX window, which leave L at 0."""
    S, n = Vr.shape
    s_run = S if s_run is None else s_run
    dev = Vr.device
    rows = [torch.zeros((refill_levels, n), dtype=torch.float32, device=dev)
            for _ in range(3)]
    L = [torch.zeros(n, dtype=torch.float32, device=dev) for _ in range(3)]
    zero = torch.zeros(n, dtype=torch.float32, device=dev)
    for s in reversed(range(s_run)):
        fl = FL[s]
        emit = (fl & 2) != 0
        raw = [torch.where(emit, V[s], V[s] * Lc)
               for V, Lc in zip((Vr, Vg, Vb), L)]
        tot = raw[0] + raw[1] + raw[2]
        over = ((fl & 1) != 0) & (tot > max_contribution)
        # a true division (`scalar / tensor` would multiply by the
        # reciprocal and round twice)
        scale = torch.where(over, torch.full_like(tot, max_contribution)
                            / torch.where(over, tot, 1.0), 1.0)
        L = [r * scale for r in raw]
        if s < refill_levels:
            started = (fl & 4) != 0
            k = int(started.sum())
            for row, Lc in zip(rows, L):
                row[s, :k] = Lc[started]
            L = [torch.where(started, zero, Lc) for Lc in L]
    return tuple(rows)


def write_rows_ref(acc, rows, bases, *, item_base, n_rows):
    """The JAX window's accumulator scan: row s (all N entries, its
    zero tail included) lands at acc[bases[s] - item_base :], in level
    order, so each later row overwrites the previous row's tail."""
    n = rows[0].shape[1]
    stacked = torch.stack(rows, dim=-1)          # (refill_levels, N, 3)
    for s, b in enumerate(bases[:n_rows].tolist()):
        off = int(b) - item_base
        acc[off:off + n] = stacked[s]
    return acc


class _HarvestArgs(ctypes.Structure):
    """Mirror of `HarvestArgs` in csrc/harvest.cu (field for field)."""

    _fields_ = [("vr", ctypes.c_void_p), ("vg", ctypes.c_void_p),
                ("vb", ctypes.c_void_p), ("fl", ctypes.c_void_p),
                ("base", ctypes.c_void_p), ("acc", ctypes.c_void_p),
                ("item_base", ctypes.c_longlong), ("n", ctypes.c_int),
                ("s_run", ctypes.c_int), ("refill_levels", ctypes.c_int),
                ("max_contribution", ctypes.c_float)]


def harvest_levels_into(acc, Vr, Vg, Vb, FL, bases, *, item_base, s_run,
                        refill_levels, max_contribution):
    """Harvest the first `s_run` recorded levels of a window into `acc`
    ((rows, 3) float32, in place): every path started at a level
    s < refill_levels writes its radiance to acc[bases[s] - item_base +
    rank], its rank among the level's starts. Records: Vr/Vg/Vb float32
    and FL int32, (S >= s_run, N), as `bounce_fused_q` writes them;
    bases: int32 (S,), each level's first item.

    Rows of acc past the window's last started item are left as they
    were by the kernel; the plain version writes zeros there (the JAX
    window's row tails). Everything before it is identical."""
    global launches
    if s_run <= 0:
        return acc
    if not acc.is_cuda:
        rows = reverse_harvest_levels_ref(
            Vr, Vg, Vb, FL, refill_levels=refill_levels,
            max_contribution=max_contribution, s_run=s_run)
        return write_rows_ref(acc, rows, bases, item_base=item_base,
                              n_rows=min(s_run, refill_levels))
    from go_raytracer_tpu_torch.ops import _cuda

    n = Vr.shape[1]
    for name, t, dt in (("Vr", Vr, torch.float32), ("Vg", Vg, torch.float32),
                        ("Vb", Vb, torch.float32), ("FL", FL, torch.int32),
                        ("bases", bases, torch.int32),
                        ("acc", acc, torch.float32)):
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: needs a contiguous CUDA {dt} tensor")
    if Vr.shape[0] < s_run or FL.shape != Vr.shape \
            or bases.shape[0] < s_run or acc.dim() != 2 or acc.shape[1] != 3:
        raise ValueError("harvest_levels_into: inconsistent shapes")
    a = _HarvestArgs(vr=Vr.data_ptr(), vg=Vg.data_ptr(), vb=Vb.data_ptr(),
                     fl=FL.data_ptr(), base=bases.data_ptr(),
                     acc=acc.data_ptr(), item_base=item_base, n=n,
                     s_run=s_run, refill_levels=refill_levels,
                     max_contribution=max_contribution)
    err = _cuda.library("harvest").grt_harvest_levels(
        ctypes.addressof(a), torch.cuda.current_stream(acc.device).cuda_stream)
    if err:
        raise RuntimeError(f"harvest launch failed: {_cuda.error_string(err)}")
    launches += 1
    return acc
