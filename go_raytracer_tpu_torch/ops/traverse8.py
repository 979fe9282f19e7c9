"""BVH8 stack walk: closest triangle hit per ray over the 8-wide tables
of scene/bvh8.py.

Counterpart of the JAX package's `ops/pallas/traverse8.bvh8_closest`.
Each ray walks the tree with its own stack: a node visit slab-tests the
eight child boxes against the ray's shrinking (T_MIN, t_best) interval
(aabb.go:90-113) and pushes the hit children in slot order; a leaf visit
runs Moller-Trumbore on its one or two 8-triangle groups
(`ops/stream.mt_groups_ref`, objects.go:408-461). Entries pop last-in
first-out, so a ray meets its leaves in the order the JAX walk does and
the winners agree, ties included. Empty child slots are NaN boxes that
never hit; a ray whose cap is 0 dies at the root.

The walk reads `pack_tables`' rows, the values of `scene/bvh8.collapse`'s
line tables rearranged (`unpack_tables` gives the lines back): a child
slot is 8 floats, (min x, y, z, max x) and (max y, z, push, valid), a
triangle 12, (v0, e0 x), (e0 y, z, e1 x, y), (e1 z, id, 0, 0), so a node
is 256 contiguous bytes and a group 384.

On CUDA tensors `bvh8_closest` launches the hand-written kernel in
`csrc/traverse8.cu`, where a team of `TEAM` lanes walks each ray (a lane
a child box or a triangle, the pushes placed by a ballot's prefix count,
a group's winner found by a reduction over the team) with its stack in
shared memory, a warp's teams visiting nodes until `LEAF_BATCH` of them
hold a leaf and then testing the held leaves together; on CPU tensors it
runs the plain version `bvh8_closest_ref`, which steps all rays' walks
together.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from go_raytracer_tpu_torch.ops import _cuda
from go_raytracer_tpu_torch.ops.stream import T_MIN, mt_groups_ref, unpack_lines

# Per-ray stack entries the CUDA kernel takes at most (its shared-memory
# row is the table's `scene/bvh8.max_stack`, made odd); the wrapper refuses
# a table whose walk could go deeper.
STACK = 96
# The CUDA kernel's schedule (results do not depend on it): lanes per ray
# (8, or 4 with two child slots and two triangles each), threads per block
# (a multiple of 32, at most 256), and the teams of a warp holding a leaf
# that end its walk phase (32 // TEAM: only when no team walks). Chosen on
# the H100 (PERF.md §6).
TEAM = 8
BLOCK = 64
LEAF_BATCH = 3

# Launches of the CUDA kernel through `bvh8_closest` (one per call).
launches = 0


NODE_COLS = 8    # (min x, y, z, max x), (max y, z, push, valid)
TRI_COLS = 12    # (v0, e0 x), (e0 y, z, e1 x, y), (e1 z, id, 0, 0)


def node_entries(nodes: torch.Tensor, dense_nodes: bool) -> torch.Tensor:
    """Node table -> (M, 8, 16) entries, from either layout."""
    if dense_nodes:
        return unpack_lines(nodes)
    return nodes.view(-1, 8, 128)[:, :, :16]


def pack_tables(nodes, tris, dense_nodes: bool):
    """The kernel's rows from `scene/bvh8.collapse`'s line tables (numpy
    or torch, in either node layout): nodes (8 * M, 8), a child slot's box,
    its push value (slot 0's field 8 + slot) and its valid flag; tris
    (8 * G, 12), a triangle's v0, e0, e1 and id with two zeros. Raises
    where a field left out is not zero, so `unpack_tables` gives the lines
    back exactly."""
    nodes, tris = (x if isinstance(x, torch.Tensor)
                   else torch.from_numpy(np.array(x, np.float32))
                   for x in (nodes, tris))
    if not dense_nodes and nodes.view(-1, 8, 128)[:, :, 16:].any():
        raise ValueError("a padded node line holds data past its entry")
    ne = node_entries(nodes, dense_nodes)
    te = unpack_lines(tris)
    rest = ne.clone()
    rest[:, :, 0:6] = 0.0
    rest[:, :, 7] = 0.0
    rest[:, 0, 8:16] = 0.0
    if rest.any() or te[:, :, 10:].any():
        raise ValueError("a BVH8 field outside the kernel's rows is not zero")
    rows = torch.cat([ne[:, :, 0:6], ne[:, 0, 8:16, None], ne[:, :, 7:8]],
                     dim=2)
    trows = torch.cat([te[:, :, 0:10], torch.zeros_like(te[:, :, :2])], dim=2)
    return (rows.reshape(-1, NODE_COLS).contiguous(),
            trows.reshape(-1, TRI_COLS).contiguous())


def entries(nodes: torch.Tensor, tris: torch.Tensor):
    """`pack_tables`' rows -> the (M, 8, 16) node and (G, 8, 16) group
    entries of scene/bvh8.py (what the walk reads)."""
    r = nodes.view(-1, 8, NODE_COLS)
    ne = torch.zeros(r.shape[:2] + (16,), dtype=r.dtype, device=r.device)
    ne[:, :, 0:6] = r[:, :, 0:6]
    ne[:, :, 7] = r[:, :, 7]
    ne[:, 0, 8:16] = r[:, :, 6]
    t = tris.view(-1, 8, TRI_COLS)
    te = torch.zeros(t.shape[:2] + (16,), dtype=t.dtype, device=t.device)
    te[:, :, 0:10] = t[:, :, 0:10]
    return ne, te


def unpack_tables(nodes: torch.Tensor, tris: torch.Tensor, dense_nodes: bool):
    """`pack_tables`' rows back to `scene/bvh8.collapse`'s line tables (numpy,
    the node table in the layout `dense_nodes` names)."""
    from go_raytracer_tpu_torch.scene import bvh8 as bvh8_mod

    ne, te = (x.cpu().numpy() for x in entries(nodes, tris))
    pack = bvh8_mod._pack_lines if dense_nodes else bvh8_mod._pad_lines
    return pack(ne), bvh8_mod._pack_lines(te)


def _safe_inv(v):
    tiny = 1e-30
    return 1.0 / torch.where(torch.abs(v) < tiny,
                             torch.where(v < 0, -tiny, tiny), v)


# `steps` entry of a ray that has finished its walk
DONE = 1 << 62


def bvh8_closest_ref(nodes, tris, o, d, t_cap=None, *, visits=None,
                     steps=None):
    """Plain PyTorch version of `bvh8_closest` (same arguments, same
    results), reading `pack_tables`' rows through `entries`. Every step
    pops one entry of every unfinished ray. `visits`
    (a dict) receives the walk's work on these rays: node visits (8 box
    tests each) and group tests (8 triangle tests each), summed over the
    rays, and per ray (`ray_visits`, `ray_groups`: (N,) int64). `steps` (a
    list) receives each step's popped entry per ray, (N,) int64 with
    `DONE` for a ray whose walk has ended: the walk's visit sequence."""
    n = o.shape[0]
    dev = o.device
    node_e, tri_e = entries(nodes, tris)
    ox, oy, oz = (o[:, k].contiguous() for k in range(3))
    dx, dy, dz = (d[:, k].contiguous() for k in range(3))
    ix, iy, iz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    t_best = (torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
              if t_cap is None else t_cap.to(torch.float32).clone())
    idx = torch.full((n,), -1, dtype=torch.int32, device=dev)
    stack = torch.zeros((n, 64), dtype=torch.int64, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)   # the root is pushed
    lanes = torch.arange(n, device=dev)
    ray_visits = torch.zeros(n, dtype=torch.int64, device=dev)
    ray_groups = torch.zeros(n, dtype=torch.int64, device=dev)
    while True:
        act = sp > 0
        if not bool(act.any()):
            break
        if int(sp.max()) + 8 > stack.shape[1]:
            stack = torch.cat([stack, torch.zeros_like(stack)], dim=1)
        sp = sp - act.to(torch.int64)
        m = stack[lanes, sp]
        is_node = act & (m >= 0)
        is_leaf = act & (m < 0)
        if steps is not None:
            steps.append(torch.where(act, m, DONE))

        # node visit: 8 child boxes per ray
        e = node_e[torch.where(is_node, m, 0)]
        tx0 = (e[:, :, 0] - ox[:, None]) * ix[:, None]
        tx1 = (e[:, :, 3] - ox[:, None]) * ix[:, None]
        ty0 = (e[:, :, 1] - oy[:, None]) * iy[:, None]
        ty1 = (e[:, :, 4] - oy[:, None]) * iy[:, None]
        tz0 = (e[:, :, 2] - oz[:, None]) * iz[:, None]
        tz1 = (e[:, :, 5] - oz[:, None]) * iz[:, None]
        near = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                           torch.minimum(ty0, ty1)),
                             torch.minimum(tz0, tz1))
        far = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                          torch.maximum(ty0, ty1)),
                            torch.maximum(tz0, tz1))
        # NaN (an empty slot) fails every comparison
        hit = (torch.clamp(near, min=T_MIN) < torch.minimum(
            far, t_best[:, None])) & is_node[:, None]
        hit = hit & ~torch.isnan(near)
        push = e[:, 0, 8:16].to(torch.int64)
        for c in range(8):
            h = hit[:, c]
            stack[lanes[h], sp[h]] = push[h, c]
            sp = sp + h.to(torch.int64)

        # leaf visit: group g, then g + 1 when the leaf has two
        enc = torch.where(is_leaf, -m - 1, 0)
        g = enc >> 1
        two = is_leaf & ((enc & 1) > 0)
        if visits is not None:
            ray_visits += is_node
            ray_groups += is_leaf.to(torch.int64) + two
        pair = torch.stack([g, torch.where(two, g + 1, 0)], dim=1)
        t_best, idx = mt_groups_ref(
            tri_e[pair], ox, oy, oz, dx, dy, dz, t_best, idx,
            mask=torch.stack([is_leaf, two], dim=1))
    if visits is not None:
        visits["node_visits"] = int(ray_visits.sum())
        visits["group_tests"] = int(ray_groups.sum())
        visits["ray_visits"], visits["ray_groups"] = ray_visits, ray_groups
    return t_best, idx


class _Traverse8Args(ctypes.Structure):
    """Mirror of `Traverse8Args` in csrc/traverse8.cu (field for field)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "nodes", "tris", "o", "d", "t_cap", "t_out", "idx_out")] + [
            (name, ctypes.c_int) for name in (
                "n", "team", "block", "stride", "leaf_batch")]


def bvh8_closest(nodes, tris, o, d, t_cap=None, *, max_stack=None):
    """Closest triangle hit for a ray bundle over the BVH8 rows of
    `pack_tables`: returns (t (N,) float32, idx (N,) int32) with idx the
    leaf-order triangle id (the scene triangle table index); idx is -1 and
    t == t_cap where no triangle beats the ray's cap. o, d: (N, 3)
    float32. `max_stack` is the table's `scene/bvh8.max_stack`; the CUDA
    path needs it (at most `STACK`: it sizes the kernel's shared stack),
    the plain version grows its stack."""
    if not o.is_cuda:
        return bvh8_closest_ref(nodes, tris, o, d, t_cap)

    n = o.shape[0]
    if max_stack is None or max_stack > STACK:
        raise ValueError(
            f"bvh8_closest on CUDA needs max_stack (scene/bvh8.max_stack) "
            f"of at most {STACK}, got {max_stack}")
    if TEAM not in (4, 8) or BLOCK % 32 or not 0 < BLOCK <= 256 \
            or not 1 <= LEAF_BATCH <= 32 // TEAM:
        raise ValueError(f"TEAM={TEAM} must be 4 or 8, BLOCK={BLOCK} a "
                         f"multiple of 32 up to 256 and LEAF_BATCH="
                         f"{LEAF_BATCH} in 1..{32 // TEAM}")
    if t_cap is None:
        t_cap = torch.full((n,), float("inf"), dtype=torch.float32,
                           device=o.device)
    f32 = torch.float32
    for name, x, shape in (("nodes", nodes, None), ("tris", tris, None),
                           ("o", o, (n, 3)), ("d", d, (n, 3)),
                           ("t_cap", t_cap, (n,))):
        if not x.is_cuda or x.dtype != f32 or not x.is_contiguous():
            raise ValueError(f"{name}: needs a contiguous CUDA float32 tensor")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    for name, x, cols in (("nodes", nodes, NODE_COLS),
                          ("tris", tris, TRI_COLS)):
        if x.dim() != 2 or x.shape[1] != cols or x.shape[0] % 8:
            raise ValueError(f"{name} must be (8 * L, {cols}) (pack_tables)")
    t_out = torch.empty(n, dtype=f32, device=o.device)
    idx_out = torch.empty(n, dtype=torch.int32, device=o.device)
    if n == 0:
        return t_out, idx_out
    p = lambda x: x.data_ptr()
    a = _Traverse8Args(nodes=p(nodes), tris=p(tris), o=p(o), d=p(d),
                       t_cap=p(t_cap), t_out=p(t_out), idx_out=p(idx_out),
                       n=n, team=TEAM,
                       block=BLOCK, stride=max_stack | 1,
                       leaf_batch=LEAF_BATCH)
    err = _cuda.library("traverse8").grt_bvh8_closest(
        ctypes.addressof(a), torch.cuda.current_stream(o.device).cuda_stream)
    if err:
        raise RuntimeError(f"bvh8_closest launch failed: {_cuda.error_string(err)}")
    _cuda.count(globals(), "launches")
    return t_out, idx_out
