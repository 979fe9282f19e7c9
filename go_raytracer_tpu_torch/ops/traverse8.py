"""BVH8 stack walk: closest triangle hit per ray over the packed 8-wide
tables of scene/bvh8.py.

Counterpart of the JAX package's `ops/pallas/traverse8.bvh8_closest`.
Each ray walks the tree with its own stack: a node visit slab-tests the
eight child boxes against the ray's shrinking (T_MIN, t_best) interval
(aabb.go:90-113) and pushes the hit children in slot order; a leaf visit
runs Moller-Trumbore on its one or two 8-triangle groups
(`ops/stream.mt_groups_ref`, objects.go:408-461). Entries pop last-in
first-out, so a ray meets its leaves in the order the JAX walk does and
the winners agree, ties included. Empty child slots are NaN boxes that
never hit; a ray whose cap is 0 dies at the root.

On CUDA tensors `bvh8_closest` launches the hand-written kernel in
`csrc/traverse8.cu`; on CPU tensors it runs the plain PyTorch version
`bvh8_closest_ref`, which steps all rays' walks together.
"""

from __future__ import annotations

import ctypes

import torch

from go_raytracer_tpu_torch.ops.stream import T_MIN, mt_groups_ref, unpack_lines

# Per-ray stack entries of the CUDA kernel (its local array); the wrapper
# refuses a table whose walk could go deeper (scene/bvh8.max_stack).
STACK = 96

# Launches of the CUDA kernel through `bvh8_closest` (one per call).
launches = 0


def node_entries(nodes: torch.Tensor, dense_nodes: bool) -> torch.Tensor:
    """Node table -> (M, 8, 16) entries, from either layout."""
    if dense_nodes:
        return unpack_lines(nodes)
    return nodes.view(-1, 8, 128)[:, :, :16]


def _safe_inv(v):
    tiny = 1e-30
    return 1.0 / torch.where(torch.abs(v) < tiny,
                             torch.where(v < 0, -tiny, tiny), v)


def bvh8_closest_ref(nodes, tris, o, d, t_cap=None, *, dense_nodes=False,
                     visits=None):
    """Plain PyTorch version of `bvh8_closest` (same arguments, same
    results). Every step pops one entry of every unfinished ray. `visits`
    (a dict) receives the walk's work on these rays: node visits (8 box
    tests each) and group tests (8 triangle tests each), summed over the
    rays."""
    n = o.shape[0]
    dev = o.device
    node_e = node_entries(nodes, dense_nodes)
    tri_e = unpack_lines(tris)
    ox, oy, oz = (o[:, k].contiguous() for k in range(3))
    dx, dy, dz = (d[:, k].contiguous() for k in range(3))
    ix, iy, iz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    t_best = (torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
              if t_cap is None else t_cap.to(torch.float32).clone())
    idx = torch.full((n,), -1, dtype=torch.int32, device=dev)
    stack = torch.zeros((n, 64), dtype=torch.int64, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)   # the root is pushed
    lanes = torch.arange(n, device=dev)
    n_nodes = n_groups = 0
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
            n_nodes += int(is_node.sum())
            n_groups += int(is_leaf.sum()) + int(two.sum())
        pair = torch.stack([g, torch.where(two, g + 1, 0)], dim=1)
        t_best, idx = mt_groups_ref(
            tri_e[pair], ox, oy, oz, dx, dy, dz, t_best, idx,
            mask=torch.stack([is_leaf, two], dim=1))
    if visits is not None:
        visits["node_visits"] = n_nodes
        visits["group_tests"] = n_groups
    return t_best, idx


class _Traverse8Args(ctypes.Structure):
    """Mirror of `Traverse8Args` in csrc/traverse8.cu (field for field)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "nodes", "tris", "o", "d", "t_cap", "t_out", "idx_out")] + [
            ("n", ctypes.c_int), ("dense_nodes", ctypes.c_int)]


def bvh8_closest(nodes, tris, o, d, t_cap=None, *, dense_nodes=False,
                 max_stack=None):
    """Closest triangle hit for a ray bundle over the packed BVH8 tables
    (scene/bvh8.collapse): returns (t (N,) float32, idx (N,) int32) with
    idx the leaf-order triangle id (the scene triangle table index); idx
    is -1 and t == t_cap where no triangle beats the ray's cap.
    o, d: (N, 3) float32; `dense_nodes` must match the node table's
    layout. `max_stack` is the table's `scene/bvh8.max_stack`; the CUDA
    path needs it (at most `STACK`), the plain version grows its stack."""
    global launches
    if not o.is_cuda:
        return bvh8_closest_ref(nodes, tris, o, d, t_cap,
                                dense_nodes=dense_nodes)
    from go_raytracer_tpu_torch.ops import _cuda

    n = o.shape[0]
    if max_stack is None or max_stack > STACK:
        raise ValueError(
            f"bvh8_closest on CUDA needs max_stack (scene/bvh8.max_stack) "
            f"of at most {STACK}, got {max_stack}")
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
    for name, x in (("nodes", nodes), ("tris", tris)):
        if x.dim() != 2 or x.shape[1] != 128 or x.shape[0] % 8:
            raise ValueError(f"{name} must be (8*L, 128)")
    t_out = torch.empty(n, dtype=f32, device=o.device)
    idx_out = torch.empty(n, dtype=torch.int32, device=o.device)
    if n == 0:
        return t_out, idx_out
    p = lambda x: x.data_ptr()
    a = _Traverse8Args(nodes=p(nodes), tris=p(tris), o=p(o), d=p(d),
                       t_cap=p(t_cap), t_out=p(t_out), idx_out=p(idx_out),
                       n=n, dense_nodes=int(bool(dense_nodes)))
    err = _cuda.library("traverse8").grt_bvh8_closest(
        ctypes.addressof(a), torch.cuda.current_stream(o.device).cuda_stream)
    if err:
        raise RuntimeError(f"bvh8_closest launch failed: {_cuda.error_string(err)}")
    launches += 1
    return t_out, idx_out
