"""Skip-link walk of the binary BVH: closest triangle hit per ray over
16-byte-aligned node and triangle rows.

Counterpart of the JAX package's `ops/pallas/traverse.py` (`pack_bvh`,
`bvh_closest`), the walk route's kernel when the BVH8 walk is turned off
(`mesh_closest(..., mesh="walk", traverse8=False)`).

Each ray walks the tree depth-first from the root: a node whose box the
ray's interval (T_MIN, t_best) hits sends it to node + 1 (an inner node) or
through its leaf's triangles; every other step follows the node's skip
link. A leaf tests its triangles in order, a hit needing T_MIN < t < t_best
strictly, so on a tie the triangle found first in walk order wins.

The JAX kernel shares one walk per tile of 1024 rays (the pointer descends
when any ray of the tile hits); here every ray has its own pointer, so a ray
visits a subset of its tile's nodes in the same order. It skips only leaves
whose box it misses, so the winners agree unless a hit's t sits on the edge
of its box's interval in float.

On CUDA tensors `bvh_closest` launches the hand-written kernel in
`csrc/traverse.cu`, where a warp's `WARP_RAYS` rays walk until
`LEAF_BATCH` of them hold a leaf to test (or none is walking) and the
warp's 32 lanes then test the held leaves together, one triangle per lane,
every ray still walking its own nodes in its own order;
on CPU tensors it runs the plain version `bvh_closest_ref`, which steps
all rays' walks together.

Tables (`pack_tables`): a node is 8 floats, (min, first) and (max, w) with
w the skip link of an inner node and -count of a leaf (a leaf's skip is
the next node), a triangle 12, (v0, 0), (e0, 0), (e1, 0): each a whole
number of 16-byte vectors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from go_raytracer_tpu_torch.ops import _cuda
from go_raytracer_tpu_torch.ops.stream import T_MIN, mt_tri_ref, safe_inv
from go_raytracer_tpu_torch.scene import types as T

NODE_COLS = 8   # (min x y z, first), (max x y z, w): w = skip or -count
TRI_COLS = 12   # (v0, 0), (e0, 0), (e1, 0)
ROW_COLS = 9    # the plain rows: [min(3), max(3), first, count, skip]
# The CUDA kernel's schedule (results do not depend on it): the lanes of a
# warp holding a leaf that end its walk phase early (32: only when no lane
# is walking), and the rays a warp walks (32, 16 or 8; the other lanes
# only help test the held leaves). Chosen on the H100 (PERF.md §6).
LEAF_BATCH = 2
WARP_RAYS = 8

# Launches of the CUDA kernel through `bvh_closest` (one per call).
launches = 0


def pack_tables(node_rows: np.ndarray, tri_rows: np.ndarray):
    """The kernel's 16-byte-aligned tables from the plain rows: nodes (M, 9)
    [min(3), max(3), first, count, skip] -> (M, 8) [min(3), first, max(3),
    w] with w = skip on an inner node (count 0) and -count on a leaf, whose
    skip must be the next node; triangles (R, 9) [v0, e0, e1] -> (R, 12)
    with a zero after each vector. Integers stay exact in float32 below
    2**24. Raises on a leaf whose skip is not node + 1."""
    node_rows = np.asarray(node_rows, np.float32)
    tri_rows = np.asarray(tri_rows, np.float32)
    count, skip = node_rows[:, 7], node_rows[:, 8]
    leaf = count > 0
    if (skip[leaf] != np.nonzero(leaf)[0] + 1).any():
        raise ValueError("a leaf's skip link is not the next node")
    nodes = np.concatenate([
        node_rows[:, 0:3], node_rows[:, 6:7], node_rows[:, 3:6],
        np.where(leaf, -count, skip)[:, None]], axis=1)
    tris = np.zeros((tri_rows.shape[0], TRI_COLS), np.float32)
    for k in range(3):
        tris[:, 4 * k:4 * k + 3] = tri_rows[:, 3 * k:3 * k + 3]
    return np.ascontiguousarray(nodes), tris


def unpack_nodes(nodes):
    """`pack_tables`' node table back to the plain rows (M, 9) [min(3),
    max(3), first, count, skip] (torch)."""
    w = nodes[:, 7]
    leaf = w < 0
    nxt = torch.arange(1, nodes.shape[0] + 1, dtype=nodes.dtype,
                       device=nodes.device)
    return torch.cat([nodes[:, 0:3], nodes[:, 4:7], nodes[:, 3:4],
                      torch.where(leaf, -w, 0.0)[:, None],
                      torch.where(leaf, nxt, w)[:, None]], dim=1)


def pack_bvh(scene: T.Scene):
    """The kernel's tables, float32 numpy arrays (`pack_tables`): node rows
    and leaf-ordered triangle rows, with `leaf_size` zero rows at the end
    (degenerate, never hit). `pack_tables`' inputs are the rows the JAX
    package packs before its 8-rows-per-line layout, which this package
    does not need."""
    bvh, tr = scene.tri_bvh, scene.triangles
    rows = np.concatenate([
        bvh.node_min, bvh.node_max, bvh.first[:, None].astype(np.float32),
        bvh.count[:, None].astype(np.float32),
        bvh.skip[:, None].astype(np.float32)], axis=1).astype(np.float32)
    tris = np.concatenate([tr.v0, tr.e0, tr.e1], axis=1).astype(np.float32)
    tris = np.concatenate([tris, np.zeros((bvh.leaf_size, ROW_COLS),
                                          np.float32)])
    return pack_tables(rows, tris)


def bvh_closest_ref(nodes, tris, o, d, t_cap=None, *, n_nodes, visits=None):
    """Plain PyTorch version of `bvh_closest` (same arguments, same
    results). Every step advances every unfinished ray by one node.
    `visits` (a dict) receives the walk's work on these rays: node visits
    (one box test each) and triangle tests, summed over the rays, and per
    ray its node visits and the leaves it tested (`ray_visits`,
    `ray_leaves`, (N,) int64)."""
    n = o.shape[0]
    dev = o.device
    ox, oy, oz = (o[:, k].contiguous() for k in range(3))
    dx, dy, dz = (d[:, k].contiguous() for k in range(3))
    ix, iy, iz = safe_inv(dx), safe_inv(dy), safe_inv(dz)
    rows = unpack_nodes(nodes)
    tri9 = tris.view(-1, 3, 4)[:, :, :3]                   # (R, 3, 3) view
    t_best = (torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
              if t_cap is None else t_cap.to(torch.float32).clone())
    idx = torch.full((n,), -1, dtype=torch.int32, device=dev)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    n_visits = n_tests = 0
    ray_visits = torch.zeros(n, dtype=torch.int64, device=dev)
    ray_leaves = torch.zeros(n, dtype=torch.int64, device=dev)
    while True:
        act = torch.nonzero(node < n_nodes)[:, 0]
        if act.numel() == 0:
            break
        nc = node[act]
        r = rows[nc]
        ax, ay, az = ox[act], oy[act], oz[act]
        tx0 = (r[:, 0] - ax) * ix[act]
        tx1 = (r[:, 3] - ax) * ix[act]
        ty0 = (r[:, 1] - ay) * iy[act]
        ty1 = (r[:, 4] - ay) * iy[act]
        tz0 = (r[:, 2] - az) * iz[act]
        tz1 = (r[:, 5] - az) * iz[act]
        near = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                           torch.minimum(ty0, ty1)),
                             torch.minimum(tz0, tz1))
        far = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                          torch.maximum(ty0, ty1)),
                            torch.maximum(tz0, tz1))
        tb, ib = t_best[act], idx[act]
        hit = torch.clamp(near, min=T_MIN) < torch.minimum(far, tb)
        count = r[:, 7].to(torch.int64)
        first = r[:, 6].to(torch.int64)
        leaf = hit & (count > 0)
        n_visits += act.numel()
        ray_visits[act] += 1
        ray_leaves[act] += leaf.long()
        for k in range(int(count[leaf].max()) if bool(leaf.any()) else 0):
            sel = leaf & (k < count)
            row = torch.where(sel, first + k, 0)
            tt, ok = mt_tri_ref(tri9[row].reshape(-1, 9), ax, ay, az,
                                dx[act], dy[act], dz[act], tb)
            upd = sel & ok
            tb = torch.where(upd, tt, tb)
            ib = torch.where(upd, row.to(torch.int32), ib)
            n_tests += int(sel.sum()) if visits is not None else 0
        t_best[act], idx[act] = tb, ib
        node[act] = torch.where(hit & (count == 0), nc + 1,
                                r[:, 8].to(torch.int64))
    if visits is not None:
        visits["node_visits"] = n_visits
        visits["tri_tests"] = n_tests
        visits["ray_visits"], visits["ray_leaves"] = ray_visits, ray_leaves
    return t_best, idx


class _TraverseArgs(ctypes.Structure):
    """Mirror of `TraverseArgs` in csrc/traverse.cu (field for field)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "nodes", "tris", "o", "d", "t_cap", "t_out", "idx_out")] + [
            (name, ctypes.c_int) for name in ("n", "n_nodes", "leaf_batch",
                                              "warp_rays")]


def bvh_closest(nodes, tris, o, d, t_cap=None, *, n_nodes):
    """Closest triangle hit for a ray bundle over `pack_bvh`'s tables
    (nodes (M, 8), tris (T + leaf_size, 12), float32): returns (t (N,)
    float32, idx (N,) int32) with idx the leaf-order triangle id (the scene
    triangle table index); idx is -1 and t == t_cap where no triangle beats
    the ray's cap (a cap of 0 ends the walk at the root). o, d: (N, 3)
    float32."""
    if nodes.dim() != 2 or nodes.shape[1] != NODE_COLS \
            or not 0 < n_nodes <= nodes.shape[0]:
        raise ValueError(f"nodes must be (M, {NODE_COLS}) with M >= n_nodes")
    if tris.dim() != 2 or tris.shape[1] != TRI_COLS:
        raise ValueError(f"tris must be (R, {TRI_COLS})")
    if not 1 <= LEAF_BATCH <= 32 or WARP_RAYS not in (8, 16, 32):
        raise ValueError(f"LEAF_BATCH={LEAF_BATCH} must be in 1..32 and "
                         f"WARP_RAYS={WARP_RAYS} one of 8, 16, 32")
    if not o.is_cuda:
        return bvh_closest_ref(nodes, tris, o, d, t_cap, n_nodes=n_nodes)

    n = o.shape[0]
    if t_cap is None:
        t_cap = torch.full((n,), float("inf"), dtype=torch.float32,
                           device=o.device)
    for name, x, shape in (("nodes", nodes, None), ("tris", tris, None),
                           ("o", o, (n, 3)), ("d", d, (n, 3)),
                           ("t_cap", t_cap, (n,))):
        if not x.is_cuda or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name}: needs a contiguous CUDA float32 tensor")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if nodes.data_ptr() % 16 or tris.data_ptr() % 16:
        raise ValueError("nodes and tris must start on a 16-byte boundary")
    t_out = torch.empty(n, dtype=torch.float32, device=o.device)
    idx_out = torch.empty(n, dtype=torch.int32, device=o.device)
    if n == 0:
        return t_out, idx_out
    p = lambda x: x.data_ptr()
    a = _TraverseArgs(nodes=p(nodes), tris=p(tris), o=p(o), d=p(d),
                      t_cap=p(t_cap), t_out=p(t_out), idx_out=p(idx_out),
                      n=n, n_nodes=n_nodes, leaf_batch=LEAF_BATCH,
                      warp_rays=WARP_RAYS)
    err = _cuda.library("traverse").grt_bvh_closest(
        ctypes.addressof(a), torch.cuda.current_stream(o.device).cuda_stream)
    if err:
        raise RuntimeError(f"bvh_closest launch failed: {_cuda.error_string(err)}")
    _cuda.count(globals(), "launches")
    return t_out, idx_out
