"""Skip-link walk of the binary BVH: closest triangle hit per ray over plain
node and triangle rows.

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
`csrc/traverse.cu`; on CPU tensors it runs the plain version
`bvh_closest_ref`, which steps all rays' walks together.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from go_raytracer_tpu_torch.ops.stream import T_MIN, mt_tri_ref, safe_inv
from go_raytracer_tpu_torch.scene import types as T

NODE_COLS = 9   # min x y z, max x y z, first, count, skip
TRI_COLS = 9    # v0, e0, e1

# Launches of the CUDA kernel through `bvh_closest` (one per call).
launches = 0


def pack_bvh(scene: T.Scene):
    """The kernel's tables, float32 numpy arrays: node rows [min(3), max(3),
    first, count, skip] (integers exact in float32 below 2**24 rows) and
    leaf-ordered triangle rows [v0, e0, e1], with `leaf_size` zero rows at
    the end (degenerate, never hit), as the JAX package packs them before
    its 8-rows-per-line layout, which this package does not need."""
    bvh, tr = scene.tri_bvh, scene.triangles
    nodes = np.concatenate([
        bvh.node_min, bvh.node_max, bvh.first[:, None].astype(np.float32),
        bvh.count[:, None].astype(np.float32),
        bvh.skip[:, None].astype(np.float32)], axis=1).astype(np.float32)
    tris = np.concatenate([tr.v0, tr.e0, tr.e1], axis=1).astype(np.float32)
    tris = np.concatenate([tris, np.zeros((bvh.leaf_size, TRI_COLS),
                                          np.float32)])
    return np.ascontiguousarray(nodes), np.ascontiguousarray(tris)


def bvh_closest_ref(nodes, tris, o, d, t_cap=None, *, n_nodes, visits=None):
    """Plain PyTorch version of `bvh_closest` (same arguments, same
    results). Every step advances every unfinished ray by one node.
    `visits` (a dict) receives the walk's work on these rays: node visits
    (one box test each) and triangle tests, summed over the rays."""
    n = o.shape[0]
    dev = o.device
    ox, oy, oz = (o[:, k].contiguous() for k in range(3))
    dx, dy, dz = (d[:, k].contiguous() for k in range(3))
    ix, iy, iz = safe_inv(dx), safe_inv(dy), safe_inv(dz)
    t_best = (torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
              if t_cap is None else t_cap.to(torch.float32).clone())
    idx = torch.full((n,), -1, dtype=torch.int32, device=dev)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    n_visits = n_tests = 0
    while True:
        act = torch.nonzero(node < n_nodes)[:, 0]
        if act.numel() == 0:
            break
        nc = node[act]
        r = nodes[nc]
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
        for k in range(int(count[leaf].max()) if bool(leaf.any()) else 0):
            sel = leaf & (k < count)
            row = torch.where(sel, first + k, 0)
            tt, ok = mt_tri_ref(tris[row], ax, ay, az, dx[act], dy[act],
                                dz[act], tb)
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
    return t_best, idx


class _TraverseArgs(ctypes.Structure):
    """Mirror of `TraverseArgs` in csrc/traverse.cu (field for field)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "nodes", "tris", "o", "d", "t_cap", "t_out", "idx_out")] + [
            ("n", ctypes.c_int), ("n_nodes", ctypes.c_int)]


def bvh_closest(nodes, tris, o, d, t_cap=None, *, n_nodes):
    """Closest triangle hit for a ray bundle over `pack_bvh`'s tables
    (nodes (M, 9), tris (T + leaf_size, 9), float32): returns (t (N,)
    float32, idx (N,) int32) with idx the leaf-order triangle id (the scene
    triangle table index); idx is -1 and t == t_cap where no triangle beats
    the ray's cap (a cap of 0 ends the walk at the root). o, d: (N, 3)
    float32."""
    global launches
    if nodes.dim() != 2 or nodes.shape[1] != NODE_COLS \
            or not 0 < n_nodes <= nodes.shape[0]:
        raise ValueError(f"nodes must be (M, {NODE_COLS}) with M >= n_nodes")
    if tris.dim() != 2 or tris.shape[1] != TRI_COLS:
        raise ValueError(f"tris must be (R, {TRI_COLS})")
    if not o.is_cuda:
        return bvh_closest_ref(nodes, tris, o, d, t_cap, n_nodes=n_nodes)
    from go_raytracer_tpu_torch.ops import _cuda

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
    t_out = torch.empty(n, dtype=torch.float32, device=o.device)
    idx_out = torch.empty(n, dtype=torch.int32, device=o.device)
    if n == 0:
        return t_out, idx_out
    p = lambda x: x.data_ptr()
    a = _TraverseArgs(nodes=p(nodes), tris=p(tris), o=p(o), d=p(d),
                      t_cap=p(t_cap), t_out=p(t_out), idx_out=p(idx_out),
                      n=n, n_nodes=n_nodes)
    err = _cuda.library("traverse").grt_bvh_closest(
        ctypes.addressof(a), torch.cuda.current_stream(o.device).cuda_stream)
    if err:
        raise RuntimeError(f"bvh_closest launch failed: {_cuda.error_string(err)}")
    launches += 1
    return t_out, idx_out
