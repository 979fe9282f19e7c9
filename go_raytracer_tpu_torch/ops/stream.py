"""The row-stream kernel of the binned mesh intersector, its fused round,
and the Moller-Trumbore test and candidate scan they share with the other
intersectors.

Counterpart of the JAX package's `ops/pallas/stream.stream_rows` and
`stream_round_rows`. The
glue (`ops/trace.binned_closest`) sorts the ray pool by candidate cluster,
so each block of `BLOCK` consecutive rays wants one contiguous range
[glo, ghi) of packed 8-triangle groups. `stream_rows` tests every ray of a
block against every triangle of the block's range, shrinking the ray's
(T_MIN, t_best) interval; rays testing a neighbour cluster's triangles
are waste, not error (closest-hit updates are idempotent).

On CUDA tensors it launches the hand-written kernel in `csrc/stream.cu`,
which splits the blocks' ranges into work items of at most `CH` groups
spread over the whole card and merges each ray's items with one 64-bit
atomic minimum (the source's header says why that equals the sequential
stream); on CPU tensors it runs the plain PyTorch version
`stream_rows_ref`.

`stream_round_rows` (K10, `csrc/stream_round.cu`) is one whole round of
`ops/trace.binned_closest` in one call: the stream of `stream_rows` (the
same work items and merge, from `csrc/stream_items.cuh`), then one pass
that finishes each ray's (t, idx), marks the block's cluster interval in
its processed bits and finds its next candidate cluster (`candidates`);
its plain version is `stream_round_rows_ref`.

Tie rules (they keep the winners equal to the BVH8 walk's): inside a
group the least t wins and, on equal t, the largest triangle id; across
groups only a strictly smaller t replaces the best. A hit needs
t > T_MIN, t < t_best and |det| >= 1e-12.
"""

from __future__ import annotations

import ctypes

import torch

from go_raytracer_tpu_torch.ops import _cuda

T_MIN = 1.0e-3
# Rays per block: the CUDA kernel's thread-block size, and the unit in
# which the glue computes group ranges and marks clusters processed.
BLOCK = 128
# Groups per work item of the CUDA kernel `stream_rows`: a multiple of 8, so
# an item stages whole octets of the table. Chosen on the H100 from 16, 32
# and 64 (PERF.md §6); results do not depend on it.
CH = 16

# Launches of the CUDA kernels through `stream_rows` and `stream_round_rows`
# (one per call).
launches = 0
launches_round = 0
_TINY = 1e-30


def unpack_lines(lines: torch.Tensor) -> torch.Tensor:
    """Line-packed table (scene/bvh8._pack_lines), (L*8, 128) -> entries
    (L*8, 8, 16): entry m, slot s, field f."""
    return lines.view(-1, 8, 8, 16).permute(0, 2, 1, 3).reshape(-1, 8, 16)


def mt_tri_ref(e, ox, oy, oz, dx, dy, dz, t_best):
    """Moller-Trumbore of triangles whose fields 0-2 are v0, 3-5 e0 and 6-8
    e1 in the last dimension of `e`, against rays and bests that broadcast
    to e[..., 0]: returns (t, hit inside (T_MIN, t_best)). The operation
    order is the CUDA kernels' (`mt_hit` of csrc/mt.cuh)."""
    col = lambda k: e[..., k]
    v0x, v0y, v0z = col(0), col(1), col(2)
    e0x, e0y, e0z = col(3), col(4), col(5)
    e1x, e1y, e1z = col(6), col(7), col(8)
    pvx = dy * e1z - dz * e1y
    pvy = dz * e1x - dx * e1z
    pvz = dx * e1y - dy * e1x
    det = e0x * pvx + e0y * pvy + e0z * pvz
    inv = 1.0 / torch.where(torch.abs(det) < 1e-30, 1e-30, det)
    tvx = ox - v0x
    tvy = oy - v0y
    tvz = oz - v0z
    uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e0z - tvz * e0y
    qvy = tvz * e0x - tvx * e0z
    qvz = tvx * e0y - tvy * e0x
    vv = (dx * qvx + dy * qvy + dz * qvz) * inv
    tt = (e1x * qvx + e1y * qvy + e1z * qvz) * inv
    ok = ((torch.abs(det) >= 1e-12)
          & (uu >= 0.0) & (uu <= 1.0) & (vv >= 0.0)
          & (uu + vv <= 1.0) & (tt > T_MIN) & (tt < t_best))
    return tt, ok


def safe_inv(v):
    """1 / v with |v| lifted to 1e-30, sign kept (the slab tests'
    inverse direction)."""
    return 1.0 / torch.where(torch.abs(v) < _TINY,
                             torch.where(v < 0, -_TINY, _TINY), v)


def candidates(lo, hi, ox, oy, oz, dx, dy, dz, t_best, proc):
    """Each ray's next candidate cluster: the lex-least (near, k) over the
    clusters k whose box (lo[k], hi[k]) the ray's interval (T_MIN, t_best)
    hits and whose processed flag proc[ray, k] (bool, (N, K)) is clear.
    Returns (k (int32, K where there is none), has). The arithmetic of the
    CUDA kernels' scans (csrc/stream_round.cu, csrc/stream2.cu)."""
    k_cl = lo.shape[0]
    ix_, iy_, iz_ = safe_inv(dx), safe_inv(dy), safe_inv(dz)
    tx0 = (lo[None, :, 0] - ox[:, None]) * ix_[:, None]
    tx1 = (hi[None, :, 0] - ox[:, None]) * ix_[:, None]
    ty0 = (lo[None, :, 1] - oy[:, None]) * iy_[:, None]
    ty1 = (hi[None, :, 1] - oy[:, None]) * iy_[:, None]
    tz0 = (lo[None, :, 2] - oz[:, None]) * iz_[:, None]
    tz1 = (hi[None, :, 2] - oz[:, None]) * iz_[:, None]
    near = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                       torch.minimum(ty0, ty1)),
                         torch.minimum(tz0, tz1))
    far = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                      torch.maximum(ty0, ty1)),
                        torch.maximum(tz0, tz1))
    near = torch.clamp(near, min=T_MIN)
    hit = near < torch.minimum(far, t_best[:, None])
    nearm = torch.where(hit & ~proc, near, float("inf"))
    best_near, _ = nearm.min(dim=1)
    # the least cluster id among equal nears
    kid = torch.arange(k_cl, dtype=torch.int32, device=ox.device)
    best_k = torch.where(nearm <= best_near[:, None], kid[None, :],
                         0x7FFFFFFF).amin(dim=1)
    has = torch.isfinite(best_near)
    return torch.where(has, best_k, k_cl).to(torch.int32), has


def range_bits(lo_b, hi_b):
    """int32 words with bits [lo_b, hi_b) set, for 0 <= lo_b, hi_b <= 32
    (a shift by 32 is avoided through the all-ones form)."""
    one = torch.ones_like(lo_b)
    hi_bits = torch.where(hi_b >= 32, -one,
                          (one << torch.clamp(hi_b, max=31)) - 1)
    lo_bits = torch.where(lo_b >= 32, -one,
                          (one << torch.clamp(lo_b, max=31)) - 1)
    return hi_bits & ~lo_bits


def mark_range(masks, ca, cb):
    """masks (n_mask, N) int32 processed-bit words with each ray's cluster
    interval [ca, cb] (per ray, (N,) int32) set; cb < ca marks nothing."""
    m = torch.arange(masks.shape[0], dtype=ca.dtype, device=ca.device)[:, None]
    return masks | range_bits(torch.clamp(ca[None, :] - 32 * m, 0, 32),
                              torch.clamp(cb[None, :] + 1 - 32 * m, 0, 32))


def processed(masks, k_cl: int):
    """(N, k_cl) bool: bit k of word k // 32 of each ray's mask words."""
    shifts = torch.arange(32, dtype=torch.int32, device=masks.device)
    return (((masks.t()[:, :, None] >> shifts) & 1) != 0) \
        .reshape(masks.shape[1], -1)[:, :k_cl]


def mt_groups_ref(e, ox, oy, oz, dx, dy, dz, t_best, idx, mask=None):
    """Moller-Trumbore of C group entries per ray, taken in order
    (objects.go:408-461). Ray planes, t_best and idx share a shape S; `e`
    is (*S, C, 8, 16) or broadcasts to it (the same groups for many
    rays); `mask` (bool, broadcasting to (*S, C)) drops groups. Returns
    the updated (t_best, idx).

    Taking the groups one after the other, each against the best so far,
    ends at the first group that reaches the least t of them all, and in
    it at the largest triangle id of that t; that is what this computes,
    in one pass. The operation order per triangle is the JAX kernel's and
    the CUDA kernels', so all agree bit for bit."""
    ox, oy, oz = (x[..., None, None] for x in (ox, oy, oz))
    dx, dy, dz = (x[..., None, None] for x in (dx, dy, dz))
    tt, ok = mt_tri_ref(e, ox, oy, oz, dx, dy, dz, t_best[..., None, None])
    tid = e[..., 9]
    if mask is not None:
        ok = ok & mask[..., None]
    tcand = torch.where(ok, tt, float("inf"))
    tmin_g = tcand.amin(dim=-1)                             # (*S, C)
    icand_g = torch.where(ok & (tcand <= tmin_g[..., None]), tid, -1.0) \
        .amax(dim=-1)
    tmin = tmin_g.amin(dim=-1)                              # (*S,)
    c = tmin_g.shape[-1]
    order = torch.arange(c, device=tmin_g.device)
    first = torch.where(tmin_g <= tmin[..., None], order, c - 1).amin(dim=-1)
    icand = torch.gather(icand_g, -1, first[..., None])[..., 0] \
        .to(torch.int32)
    upd = tmin < t_best
    return torch.where(upd, tmin, t_best), torch.where(upd, icand, idx)


# groups the plain version takes per step (its results do not depend on it)
_REF_CHUNK = 16


def stream_rows_ref(tri_lines, glo, ghi, ox, oy, oz, dx, dy, dz, t, idx, *,
                    block=BLOCK):
    """Plain PyTorch version of `stream_rows` (same arguments, same
    results): each step takes the next `_REF_CHUNK` groups of every block
    whose range is that long, so each ray meets its range in ascending
    order. `block` is the rays per range (`stream2_rows_ref` streams units
    of its own size)."""
    blocks = ox.numel() // block
    entries = unpack_lines(tri_lines)
    n_groups = entries.shape[0]
    rows = lambda x: x.reshape(blocks, block)
    rays = [rows(x) for x in (ox, oy, oz, dx, dy, dz)]
    t_best, best = rows(t).clone(), rows(idx).clone()
    glo_l = torch.clamp(glo.to(torch.int64), min=0)
    span = torch.clamp(ghi.to(torch.int64), max=n_groups) - glo_l
    step = torch.arange(_REF_CHUNK, device=ox.device)
    for j in range(0, int(span.max()) if blocks else 0, _REF_CHUNK):
        live = torch.nonzero(span > j)[:, 0]
        g = glo_l[live, None] + j + step[None, :]           # (live, C)
        in_range = (j + step)[None, :] < span[live, None]
        e = entries[torch.clamp(g, max=n_groups - 1)][:, None]
        t_best[live], best[live] = mt_groups_ref(
            e, *(r[live] for r in rays), t_best[live], best[live],
            mask=in_range[:, None, :])
    return t_best.reshape(t.shape), best.reshape(idx.shape)


class _StreamArgs(ctypes.Structure):
    """Mirror of `StreamArgs` in csrc/stream_items.cuh (field for field)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "lines", "glo", "ghi", "ox", "oy", "oz", "dx", "dy", "dz",
        "t_in", "idx_in", "t_out", "idx_out", "keys", "scan")] + [
            (name, ctypes.c_int) for name in ("n_blocks", "n_groups", "ch")]


def _stream_args(tri_lines, glo, ghi, ox, oy, oz, dx, dy, dz, t, idx):
    """The `StreamArgs` of one launch of the item stream, its outputs
    (t_out, idx_out) and its scratch (each ray's merged key, the item scan
    with its counter), which the caller keeps alive until the launch is
    enqueued. Raises unless the tensors are what csrc/stream_items.cuh
    reads: contiguous CUDA tensors of the right type and size."""
    f32, i32 = torch.float32, torch.int32
    n = ox.numel()
    planes = [("ox", ox, f32), ("oy", oy, f32), ("oz", oz, f32),
              ("dx", dx, f32), ("dy", dy, f32), ("dz", dz, f32),
              ("t", t, f32), ("idx", idx, i32)]
    for name, x, dt in planes + [("tri_lines", tri_lines, f32),
                                 ("glo", glo, i32), ("ghi", ghi, i32)]:
        if not x.is_cuda or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"{name}: needs a contiguous CUDA {dt} tensor")
    for name, x, _ in planes:
        if x.numel() != n:
            raise ValueError(f"{name}: {x.numel()} elements, expected {n}")
    if tri_lines.dim() != 2 or tri_lines.shape[1] != 128 \
            or tri_lines.shape[0] % 8:
        raise ValueError("tri_lines must be (8*L, 128)")
    if CH % 8 or CH <= 0:
        raise ValueError(f"CH={CH} must be a positive multiple of 8")
    blocks = n // BLOCK
    t_out, idx_out = torch.empty_like(t), torch.empty_like(idx)
    keys = torch.empty(n, dtype=torch.int64, device=ox.device)
    scan = torch.empty(blocks + 2, dtype=torch.int32, device=ox.device)
    p = lambda x: x.data_ptr()
    a = _StreamArgs(lines=p(tri_lines), glo=p(glo), ghi=p(ghi), ox=p(ox),
                    oy=p(oy), oz=p(oz), dx=p(dx), dy=p(dy), dz=p(dz),
                    t_in=p(t), idx_in=p(idx), t_out=p(t_out),
                    idx_out=p(idx_out), keys=p(keys), scan=p(scan),
                    n_blocks=blocks, n_groups=tri_lines.shape[0], ch=CH)
    return a, t_out, idx_out, (keys, scan)


def stream_rows(tri_lines, glo, ghi, ox, oy, oz, dx, dy, dz, t, idx):
    """Stream each block's group range against its `BLOCK` rays.

    tri_lines: the packed group table (scene/clusters.py), (R, 128)
    float32. Ray planes ox..dz and t (float32), idx (int32): any shape
    with a multiple of `BLOCK` elements, block b owning elements
    [b*BLOCK, (b+1)*BLOCK) in flat order. glo/ghi: (blocks,) int32 group
    ranges (glo == ghi leaves the block untouched). Returns the updated
    (t, idx) as new tensors."""
    n = ox.numel()
    if n % BLOCK:
        raise ValueError(f"ray count {n} is not a multiple of {BLOCK}")
    blocks = n // BLOCK
    if glo.shape != (blocks,) or ghi.shape != (blocks,):
        raise ValueError(f"glo/ghi must have shape ({blocks},)")
    if not ox.is_cuda:
        return stream_rows_ref(tri_lines, glo, ghi, ox, oy, oz, dx, dy, dz,
                               t, idx)

    a, t_out, idx_out, _scratch = _stream_args(tri_lines, glo, ghi, ox, oy,
                                               oz, dx, dy, dz, t, idx)
    if blocks == 0:
        return t_out, idx_out
    err = _cuda.library("stream").grt_stream_rows(
        ctypes.addressof(a), torch.cuda.current_stream(ox.device).cuda_stream)
    if err:
        raise RuntimeError(f"stream_rows launch failed: {_cuda.error_string(err)}")
    _cuda.count(globals(), "launches")
    return t_out, idx_out


# ---------------------------------------------------------------------------
# K10: one fused round of the binned intersector
# ---------------------------------------------------------------------------

MAX_ROUND_K = 256    # cluster boxes the fused round stages in shared memory


def stream_round_rows_ref(tri_lines, lo, hi, glo, ghi, ca, cb, ox, oy, oz,
                          dx, dy, dz, t, idx, masks):
    """Plain PyTorch version of `stream_round_rows` (same arguments, same
    results): `stream_rows_ref`, the mark of [ca, cb] per block, and
    `candidates` on the updated bests and bits."""
    t2, i2 = stream_rows_ref(tri_lines, glo, ghi, ox, oy, oz, dx, dy, dz, t,
                             idx)
    m2 = mark_range(masks, ca.repeat_interleave(BLOCK),
                    cb.repeat_interleave(BLOCK))
    key, _ = candidates(lo, hi, ox, oy, oz, dx, dy, dz, t2,
                        processed(m2, lo.shape[0]))
    return t2, i2, key, m2


class _RoundArgs(ctypes.Structure):
    """Mirror of `RoundArgs` in csrc/stream_round.cu (field for field): the
    stream's `StreamArgs`, then the mark's and the scan's arguments."""

    _fields_ = [("s", _StreamArgs)] + [(name, ctypes.c_void_p) for name in (
        "lo", "hi", "ca", "cb", "masks_in", "key_out", "masks_out")] + [
            (name, ctypes.c_int) for name in ("k_cl", "n_mask")]


def stream_round_rows(tri_lines, lo, hi, glo, ghi, ca, cb, ox, oy, oz, dx,
                      dy, dz, t, idx, masks):
    """One fused round of the binned intersector per block of `BLOCK`
    sorted rays: stream the block's group range [glo, ghi) (as
    `stream_rows`), OR the block's cluster interval [ca, cb] (cb < ca: none)
    into each ray's processed bits, and scan the K <= 256 cluster boxes
    (lo, hi: (K, 3) float32) for each ray's next candidate (`candidates`).

    Ray planes, t (float32) and idx (int32): (N,) with N a multiple of
    `BLOCK`; glo/ghi/ca/cb: (blocks,) int32; masks: (ceil(K/32), N) int32.
    Returns new (t, idx, key, masks) with key = K where a ray has no
    candidate. CUDA tensors launch csrc/stream_round.cu (three kernels: the
    item scan, the item stream and the finish pass); CPU tensors run
    `stream_round_rows_ref`."""
    n = ox.numel()
    k_cl = lo.shape[0]
    n_mask = (k_cl + 31) // 32
    if n % BLOCK:
        raise ValueError(f"ray count {n} is not a multiple of {BLOCK}")
    blocks = n // BLOCK
    if k_cl > MAX_ROUND_K:
        raise ValueError(f"the fused round takes at most {MAX_ROUND_K} "
                         f"clusters, got {k_cl}")
    for name, x in (("glo", glo), ("ghi", ghi), ("ca", ca), ("cb", cb)):
        if x.shape != (blocks,):
            raise ValueError(f"{name} must have shape ({blocks},)")
    if lo.shape != (k_cl, 3) or hi.shape != (k_cl, 3):
        raise ValueError("lo/hi must be (K, 3)")
    if masks.shape != (n_mask, n):
        raise ValueError(f"masks must be ({n_mask}, {n}), got "
                         f"{tuple(masks.shape)}")
    if not ox.is_cuda:
        return stream_round_rows_ref(tri_lines, lo, hi, glo, ghi, ca, cb, ox,
                                     oy, oz, dx, dy, dz, t, idx, masks)

    for name, x, dt in (("lo", lo, torch.float32), ("hi", hi, torch.float32),
                        ("ca", ca, torch.int32), ("cb", cb, torch.int32),
                        ("masks", masks, torch.int32)):
        if not x.is_cuda or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"{name}: needs a contiguous CUDA {dt} tensor")
    s, t_out, idx_out, _scratch = _stream_args(tri_lines, glo, ghi, ox, oy,
                                               oz, dx, dy, dz, t, idx)
    key = torch.empty_like(idx)
    m_out = torch.empty_like(masks)
    if blocks == 0:
        return t_out, idx_out, key, m_out
    p = lambda x: x.data_ptr()
    a = _RoundArgs(s=s, lo=p(lo), hi=p(hi), ca=p(ca), cb=p(cb),
                   masks_in=p(masks), key_out=p(key), masks_out=p(m_out),
                   k_cl=k_cl, n_mask=n_mask)
    err = _cuda.library("stream_round").grt_stream_round_rows(
        ctypes.addressof(a), torch.cuda.current_stream(ox.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"stream_round_rows launch failed: {_cuda.error_string(err)}")
    _cuda.count(globals(), "launches_round")
    return t_out, idx_out, key, m_out
