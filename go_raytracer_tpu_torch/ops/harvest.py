"""The reverse harvest of a regen window: the per-level firefly-clamp
recursion run backwards over the recorded levels, each started path's
radiance landing in its accumulator slot.

Counterpart of the JAX package's `ops/pallas/harvest.py` (both entry
points) plus the accumulator row scans of its regen windows.

* `harvest_levels_into(acc, ...)` is the main-path entry point. On a CUDA
  tensor it launches the hand-written kernel in `csrc/harvest.cu`, which
  writes each started path straight to its item slot (the slot's rank
  rides in the flag word from `bounce_fused_q`). On a CPU tensor it runs
  the plain version: `reverse_harvest_levels_ref` + `write_rows_ref`.
* `reverse_harvest_levels_ref` keeps the JAX kernel's output, one
  compacted row of started-lane radiances per refill level, so the tests
  compare it row by row.

* `reverse_harvest_into(acc, ...)` is the same for the `queue` schedule,
  whose paths start only at inner level 0 of a refill row and whose started
  flags arrive as planes of their own (`STs`), as the JAX kernel
  `reverse_harvest` takes them. `csrc/harvest_rows.cu` ranks each row's
  starts itself; the plain version is `reverse_harvest_ref` +
  `write_rows_ref`. With `perms` (a window whose lanes were sorted before
  every call, `integrator/regen.coherence_sort`) it unwinds each row's
  sort, as the JAX package's XLA reverse scan does with `reorder`: in the
  kernel's `grt_harvest_rows_perm` entry the lanes stay in place and each
  row's L moves to the previous row's order through a state buffer, one
  grid-wide barrier a row.

Record planes are level-major (S, N): level s of a window is row s, the
(outer, cadence, N) layout of the JAX package flattened.
"""

from __future__ import annotations

import ctypes

import torch

from go_raytracer_tpu_torch.ops import _cuda

# Launches of the CUDA kernel through `harvest_levels_into` (one per call).
launches = 0
# Launches of the CUDA kernel through `reverse_harvest_into` (one per call),
# without and with `perms`.
launches_rows = 0
launches_rows_perm = 0
# block size of csrc/harvest_rows.cu; the lane count must be a multiple
ROWS_BLOCK = 256


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
    for s in reversed(range(s_run)):
        fl = FL[s]
        L = _clamp_step((Vr[s], Vg[s], Vb[s]), fl, L, max_contribution)
        if s < refill_levels:
            L = _pull_started((fl & 4) != 0, rows, s, L)
    return tuple(rows)


def _clamp_step(V, fl, L, max_contribution):
    """One level of the recursion, per channel: L' = clamp?(emit ? V : V*L)
    (camera.go:330-341); a NaN sum compares false and passes unclamped."""
    emit = (fl & 2) != 0
    raw = [torch.where(emit, Vc, Vc * Lc) for Vc, Lc in zip(V, L)]
    tot = raw[0] + raw[1] + raw[2]
    over = ((fl & 1) != 0) & (tot > max_contribution)
    # a true division (`scalar / tensor` would multiply by the
    # reciprocal and round twice)
    scale = torch.where(over, torch.full_like(tot, max_contribution)
                        / torch.where(over, tot, 1.0), 1.0)
    return [r * scale for r in raw]


def _pull_started(started, rows, r, L):
    """Pack the started lanes' finished radiances to the front of row `r`
    in lane order, and reset those lanes' recursion."""
    k = int(started.sum())
    for row, Lc in zip(rows, L):
        row[r, :k] = Lc[started]
    return [torch.where(started, torch.zeros_like(Lc), Lc) for Lc in L]


def reverse_harvest_ref(Vr, Vg, Vb, FL, STs, *, cadence, refill_outer,
                        max_contribution, perms=None):
    """Plain PyTorch version of the JAX kernel `reverse_harvest`: records
    Vr/Vg/Vb (float32) and FL (int32, bit0 clamp, bit1 emit) of shape
    (outer, cadence, N), started flags STs (outer, N) int32 of which only
    the first `refill_outer` rows can hold starts. Returns (hr, hg, hb),
    each (refill_outer, N) float32: row r holds the radiances of the paths
    that started at inner level 0 of outer row r, packed to the row front
    in lane order (zeros after).

    `perms` ((outer, N) int32; None: the lanes kept their places): perm[r][i]
    is the lane that the lane at position i of row r held in row r - 1.
    After row r's starts, L goes back to that order, L_prev[perm[r]] = L,
    which is the JAX package's unstable sort by the unique key perm[r]."""
    outer, cad, n = Vr.shape
    if cad != cadence:
        raise ValueError(f"records have cadence {cad}, not {cadence}")
    dev = Vr.device
    rows = [torch.zeros((refill_outer, n), dtype=torch.float32, device=dev)
            for _ in range(3)]
    L = [torch.zeros(n, dtype=torch.float32, device=dev) for _ in range(3)]
    for r in reversed(range(outer)):
        for j in reversed(range(cadence)):
            L = _clamp_step((Vr[r, j], Vg[r, j], Vb[r, j]), FL[r, j], L,
                            max_contribution)
        if r < refill_outer:
            L = _pull_started(STs[r] != 0, rows, r, L)
        if perms is not None:
            p = perms[r].long()
            L = [torch.empty_like(Lc).index_put_((p,), Lc) for Lc in L]
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
    if s_run <= 0:
        return acc
    if not acc.is_cuda:
        rows = reverse_harvest_levels_ref(
            Vr, Vg, Vb, FL, refill_levels=refill_levels,
            max_contribution=max_contribution, s_run=s_run)
        return write_rows_ref(acc, rows, bases, item_base=item_base,
                              n_rows=min(s_run, refill_levels))

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
    _cuda.count(globals(), "launches")
    return acc


class _HarvestRowsArgs(ctypes.Structure):
    """Mirror of `HarvestRowsArgs` in csrc/harvest_rows.cu (field for
    field)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "vr", "vg", "vb", "fl", "sts", "nis", "acc", "cnt", "perm",
        "state")] + [
        ("item_base", ctypes.c_longlong), ("n", ctypes.c_int),
        ("outer", ctypes.c_int), ("cadence", ctypes.c_int),
        ("refill_outer", ctypes.c_int), ("max_contribution", ctypes.c_float)]


def reverse_harvest_into(acc, Vr, Vg, Vb, FL, STs, NIs, *, item_base, cadence,
                         refill_outer, max_contribution, perms=None):
    """Harvest a `queue` window into `acc` ((rows, 3) float32, in place):
    every path started at inner level 0 of an outer row r < refill_outer
    writes its radiance to acc[NIs[r] - item_base + rank], its rank among
    the row's starts in lane order. Records Vr/Vg/Vb float32 and FL int32,
    (outer, cadence, N), as `bounce_fused` writes them; STs: int32
    (>= refill_outer, N) started flags; NIs: int32 (>= refill_outer,), each
    row's first item.

    On a CUDA tensor the kernel ranks the starts itself and writes only
    real starts, each once. The plain version (`reverse_harvest_ref` +
    `write_rows_ref`) also writes each row's zero tail, which later rows
    overwrite; rows of acc past the window's last started item so hold
    zeros there and are left as they were by the kernel. Everything before
    is identical.

    `perms` ((outer, N) int32, see `reverse_harvest_ref`): the lanes were
    sorted before every call; each row's starts are ranked in the row's
    own lane order, and the harvest unwinds the sorts (on CUDA the
    kernel's `grt_harvest_rows_perm` entry, `launches_rows_perm`)."""
    if not acc.is_cuda:
        rows = reverse_harvest_ref(
            Vr, Vg, Vb, FL, STs, cadence=cadence, refill_outer=refill_outer,
            max_contribution=max_contribution, perms=perms)
        return write_rows_ref(acc, rows, NIs, item_base=item_base,
                              n_rows=refill_outer)

    outer, cad, n = Vr.shape
    for name, t, dt in (("Vr", Vr, torch.float32), ("Vg", Vg, torch.float32),
                        ("Vb", Vb, torch.float32), ("FL", FL, torch.int32),
                        ("STs", STs, torch.int32), ("NIs", NIs, torch.int32),
                        ("acc", acc, torch.float32)):
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: needs a contiguous CUDA {dt} tensor")
    if cad != cadence or n % ROWS_BLOCK or refill_outer > outer \
            or any(t.shape != Vr.shape for t in (Vg, Vb, FL)) \
            or STs.dim() != 2 or STs.shape[0] < refill_outer \
            or STs.shape[1] != n or NIs.shape[0] < refill_outer \
            or acc.dim() != 2 or acc.shape[1] != 3:
        raise ValueError("reverse_harvest_into: inconsistent shapes")
    if perms is not None and (
            not perms.is_cuda or perms.dtype != torch.int32
            or not perms.is_contiguous() or perms.shape != (outer, n)):
        raise ValueError("perms: needs a contiguous CUDA int32 tensor of "
                         f"shape {(outer, n)}")
    cnt = torch.empty(max(refill_outer, 1) * (n // ROWS_BLOCK),
                      dtype=torch.int32, device=acc.device)
    # L of every lane, (r, g, b, pad), in two buffers that the rows swap
    state = None if perms is None else torch.empty(
        (2, n, 4), dtype=torch.float32, device=acc.device)
    a = _HarvestRowsArgs(
        vr=Vr.data_ptr(), vg=Vg.data_ptr(), vb=Vb.data_ptr(),
        fl=FL.data_ptr(), sts=STs.data_ptr(), nis=NIs.data_ptr(),
        acc=acc.data_ptr(), cnt=cnt.data_ptr(),
        perm=None if perms is None else perms.data_ptr(),
        state=None if state is None else state.data_ptr(),
        item_base=item_base,
        n=n, outer=outer, cadence=cadence, refill_outer=refill_outer,
        max_contribution=max_contribution)
    lib = _cuda.library("harvest_rows")
    entry = lib.grt_harvest_rows if perms is None \
        else lib.grt_harvest_rows_perm
    err = entry(ctypes.addressof(a),
                torch.cuda.current_stream(acc.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"harvest_rows launch failed: {_cuda.error_string(err)}")
    if perms is None:
        _cuda.count(globals(), "launches_rows")
    else:
        _cuda.count(globals(), "launches_rows_perm")
    return acc
