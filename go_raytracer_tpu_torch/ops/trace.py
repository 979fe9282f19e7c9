"""Closest triangle hit over a mesh: the binned intersectors, the BVH
walks behind a coherence sort, and the plain skip-link walk.

Counterpart of the mesh half of the JAX package's `ops/trace.py`:

* `to_device` moves the scene tables the mesh path reads onto a device;
* `mesh_closest` (the JAX package's `pallas_bvh_closest`) routes a bounce
  level's rays to one of five kernels (`route_name` names them);
  mesh="auto" (the default, `resolve_route`) is the walk, or the binned
  route where `b1_fused` asks for its fused rounds:
  - mesh="binned": `binned_closest`, K4
    `ops/stream.stream_rows` inside, or with `b1_fused` K10
    `ops/stream.stream_round_rows`;
  - mesh="binned2": `binned2_closest`, one launch of K11
    `ops/stream2.stream2_rows` behind a coherence sort;
  - mesh="walk": the coherence sort (direction octant, origin Morton
    cell), then K5 `ops/traverse8.bvh8_closest` or, with
    `traverse8=False`, K12 `ops/traverse.bvh_closest`;
* `bvh_tri_closest` is the plain lockstep skip-link walk over the binary
  BVH, kept as an oracle that shares nothing with the kernels;
* `tri_hit_gathered` recomputes one triangle per ray (attributes of the
  winner);
* `trace` is the reference engine's closest hit over every class and the
  media (the JAX package's `trace`), with its `Hit` record;
* `PARAMS`, `param_tensors` and `host_scene` name a device scene's
  differentiable parameters (`parallel/mesh.extract_params`) and give
  the numpy scene that carries their current values.

Where the JAX package quietly takes another route (no `cl2_*` tables for
binned2, too many clusters for the fused round), `check_route` raises.
The binned rounds end when no ray has a candidate cluster left, which the
host learns from one device read per round; `counters` (a dict the caller
passes) counts calls, rounds and those reads.
"""

from __future__ import annotations

import dataclasses
import math
import types as _pytypes

import numpy as np
import torch

from go_raytracer_tpu_torch.core import vecmath as vm
from go_raytracer_tpu_torch.ops import _cuda
from go_raytracer_tpu_torch.ops import intersect as ix
from go_raytracer_tpu_torch.ops import stream as stream_mod
from go_raytracer_tpu_torch.ops import stream2 as stream2_mod
from go_raytracer_tpu_torch.ops import traverse as trav_mod
from go_raytracer_tpu_torch.ops import traverse8 as trav8_mod
from go_raytracer_tpu_torch.scene import bvh8 as bvh8_mod
from go_raytracer_tpu_torch.scene import types as T

T_MIN = 1.0e-3  # rayColor's interval.New(0.001, inf) (camera.go:300)
INF = float("inf")
_TINY = 1e-30


def _ns(table, fields, device):
    return _pytypes.SimpleNamespace(**{
        f: torch.from_numpy(np.array(getattr(table, f))).to(device)
        for f in fields})


_FLAGS = ("has_spheres", "has_quads", "has_boxes", "has_rot_boxes",
          "has_triangles", "has_tri_bvh", "has_media", "has_noise",
          "has_checker", "has_image", "has_metal", "has_dielectric",
          "has_isotropic", "has_quad_lights", "has_sphere_lights",
          "has_tri_lights")


def to_device(scene: T.Scene, device) -> _pytypes.SimpleNamespace:
    """The scene's tables as tensors on `device`, with its static flags
    (`has_*`, `lights.n`): every primitive, material, texture, light,
    medium and image table the reference engine (`trace`,
    `integrator/wavefront._bounce`) reads, and for a triangle BVH the BVH
    with its 8-wide collapse with `ops/traverse8.pack_tables`' rows of it
    (`bvh8_nodes`, `bvh8_tris`), `ops/traverse.pack_bvh`'s rows
    (`bvh_nodes`, `bvh_tris`) and both cluster partitions (the finer
    one's boxes also as `cl2_lo`/`cl2_hi`). `bvh.max_stack` is the
    deepest stack the BVH8 walk can reach on this tree. `host` is the
    scene itself; a kernel packs its tables from `host_scene(ds)`, which
    reads the parameter leaves (`PARAMS`) from the tensors."""
    dev = torch.device(device)
    out = _pytypes.SimpleNamespace(host=scene, device=dev,
                                   **{f: getattr(scene, f) for f in _FLAGS})
    out.spheres = _ns(scene.spheres, ("center0", "center_delta", "radius",
                                      "mat_id", "active"), dev)
    out.quads = _ns(scene.quads, ("q", "u", "v", "normal", "d_plane", "cvw",
                                  "cwu", "area", "mat_id", "active"), dev)
    out.boxes = _ns(scene.boxes, ("lo", "hi", "cos_t", "sin_t", "offset",
                                  "mat_id", "active"), dev)
    out.triangles = _ns(scene.triangles, (
        "v0", "e0", "e1", "cn", "c_e1v0", "c_v0e0", "k", "n_face", "vn",
        "has_vn", "uv", "has_uv", "area", "mat_id", "active"), dev)
    out.media = _ns(scene.media, ("kind", "center", "radius", "cos_t",
                                  "sin_t", "offset", "box_min", "box_max",
                                  "neg_inv_density", "mat_id", "active"), dev)
    out.materials = _ns(scene.materials, ("kind", "tex_id", "fuzz",
                                          "ref_idx"), dev)
    out.textures = _ns(scene.textures, ("kind", "color", "inv_scale", "even",
                                        "odd", "scale", "noise_id",
                                        "image_id"), dev)
    out.perlin_seed = torch.from_numpy(
        np.asarray(scene.perlin.seed, np.uint32).astype(np.int64)).to(dev)
    out.images = _ns(scene.images, ("data", "wh"), dev)
    out.images.wh = out.images.wh.to(torch.int32)
    out.lights = _ns(scene.lights, ("kind", "prim_id"), dev)
    out.lights.n = scene.lights.n
    out.background = torch.from_numpy(
        np.array(scene.background, np.float32)).to(dev)
    b = scene.tri_bvh
    derived = ("nodes8", "tris8", "cl_lo", "cl_hi", "cl_gs", "cl_lines",
               "cl_boxes", "cl2_boxes", "cl2_gs", "cl2_lines")
    bvh = _ns(b, ["node_min", "node_max", "first", "count", "skip", "order"]
              + [f for f in derived if getattr(b, f) is not None], dev)
    for f in derived:
        if getattr(b, f) is None:
            setattr(bvh, f, None)
    bvh.n_nodes, bvh.leaf_size = b.n_nodes, b.leaf_size
    bvh.bvh8_dense = b.bvh8_dense
    bvh.max_stack = bvh.bvh8_nodes = bvh.bvh8_tris = None
    bvh.bvh_nodes = bvh.bvh_tris = None
    if b.nodes8 is not None:
        bvh.max_stack = bvh8_mod.max_stack(b.nodes8, b.bvh8_dense)
        bvh.bvh8_nodes, bvh.bvh8_tris = (
            x.to(dev) for x in trav8_mod.pack_tables(
                np.asarray(b.nodes8), np.asarray(b.tris8), b.bvh8_dense))
    if scene.has_tri_bvh:
        bvh.bvh_nodes, bvh.bvh_tris = (
            torch.from_numpy(x).to(dev) for x in trav_mod.pack_bvh(scene))
    bvh.cl2_lo = bvh.cl2_hi = None
    if bvh.cl2_gs is not None:
        bvh.cl2_lo, bvh.cl2_hi = stream2_mod.boxes_lo_hi(
            bvh.cl2_boxes, bvh.cl2_gs.shape[0] - 1)
    out.tri_bvh = bvh
    # K3's launch, prepared by integrator/wavefront.kernel_launch, and the
    # parameter tensors it was packed from
    out.k3, out.k3_stamp = None, ()
    # the reference engine's levels on fixed buffers, with their CUDA
    # graphs (integrator/wavefront.Levels), kept from one call to the next
    # under "levels"; the scenes `parallel/mesh.apply_params` makes share
    # the dict, and a Levels serves only the tensors it was made for
    out.engine = {}
    return out


# the differentiable scene parameters (the JAX package's
# parallel/mesh.extract_params): leaf name -> (table, field) of a device
# scene, the table None for the scene itself
PARAMS = {"tex_color": ("textures", "color"), "tex_even": ("textures", "even"),
          "tex_odd": ("textures", "odd"), "fuzz": ("materials", "fuzz"),
          "ref_idx": ("materials", "ref_idx"),
          "med_neg_inv_density": ("media", "neg_inv_density"),
          "background": (None, "background")}


def param_tensors(ds) -> dict:
    """The device scene's parameter tensors by leaf name (`PARAMS`)."""
    return {k: getattr(ds if tab is None else getattr(ds, tab), f)
            for k, (tab, f) in PARAMS.items()}


def host_scene(ds) -> T.Scene:
    """ds's host scene with its parameter leaves read back from ds's own
    tensors (detached): what a kernel packs its tables from, so that a
    scene made by `parallel/mesh.apply_params`, or whose tensors were
    updated in place, never runs with the parameters it was built with."""
    p = {k: v.detach().cpu().numpy() for k, v in param_tensors(ds).items()}
    s = ds.host
    rep = lambda tab, **kw: dataclasses.replace(tab, **kw)
    return dataclasses.replace(
        s, textures=rep(s.textures, color=p["tex_color"], even=p["tex_even"],
                        odd=p["tex_odd"]),
        materials=rep(s.materials, fuzz=p["fuzz"], ref_idx=p["ref_idx"]),
        media=rep(s.media, neg_inv_density=p["med_neg_inv_density"]),
        background=p["background"])


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=-1)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def tri_hit_gathered(tr, idx, o, d, t_min, t_max):
    """Local-form Moller-Trumbore for per-ray gathered triangles idx (N,)
    (objects.go:408-461): returns (t, u, v, ok)."""
    v0, e0, e1 = tr.v0[idx], tr.e0[idx], tr.e1[idx]
    pvec = _cross(d, e1)
    det = _dot(e0, pvec)
    inv = 1.0 / torch.where(torch.abs(det) < 1e-30, 1e-30, det)
    tvec = o - v0
    u = _dot(tvec, pvec) * inv
    qvec = _cross(tvec, e0)
    v = _dot(d, qvec) * inv
    t = _dot(e1, qvec) * inv
    ok = ((torch.abs(det) >= ix.PARALLEL_EPS)
          & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t_min <= t) & (t <= t_max) & tr.active[idx])
    return t, u, v, ok


def _safe(v):
    return torch.where(torch.abs(v) < _TINY,
                       torch.where(v < 0, -_TINY, _TINY), v)


def bvh_tri_closest(ms, o, d, t_min, t_max):
    """Closest triangle hit via the stackless skip-link walk over the
    binary BVH (replacing the recursive walk of hittable/bvh.go:69-82).
    All rays step the tree in lockstep; finished rays park at node ==
    n_nodes. Returns (t (inf on a miss), idx)."""
    bvh, tr = ms.tri_bvh, ms.triangles
    n = o.shape[0]
    n_nodes = bvh.n_nodes
    n_tri = tr.v0.shape[0]
    inv_d = 1.0 / _safe(d)
    node = torch.zeros(n, dtype=torch.int64, device=o.device)
    t_best = torch.full((n,), INF, dtype=o.dtype, device=o.device)
    idx_best = torch.zeros(n, dtype=torch.int64, device=o.device)
    order = bvh.order.to(torch.int64)
    while bool((node < n_nodes).any()):
        nc = torch.clamp(node, max=n_nodes - 1)
        t0 = (bvh.node_min[nc] - o) * inv_d
        t1 = (bvh.node_max[nc] - o) * inv_d
        near = torch.minimum(t0, t1).amax(dim=-1)
        far = torch.maximum(t0, t1).amin(dim=-1)
        live = node < n_nodes
        hit_box = live & (torch.clamp(near, min=t_min)
                          < torch.clamp(torch.minimum(far, t_best), max=t_max))
        count = bvh.count[nc]
        is_leaf = count > 0
        do_leaf = hit_box & is_leaf
        first = bvh.first[nc].to(torch.int64)
        for k in range(bvh.leaf_size):
            tid = order[torch.clamp(first + k, 0, order.shape[0] - 1)]
            tid_c = torch.clamp(tid, 0, n_tri - 1)
            t_k, _, _, ok_k = tri_hit_gathered(tr, tid_c, o, d, t_min, t_max)
            upd = do_leaf & (k < count) & (tid >= 0) & ok_k & (t_k < t_best)
            t_best = torch.where(upd, t_k, t_best)
            idx_best = torch.where(upd, tid_c, idx_best)
        node = torch.where(
            live, torch.where(hit_box & ~is_leaf, nc + 1,
                              bvh.skip[nc].to(torch.int64)), node)
    return t_best, idx_best.to(torch.int32)


def _part1by2(x):
    """Spread 10 bits of x two apart (standard Morton magic numbers)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


ROUTES = ("binned", "binned2", "walk")
# Routes whose closest hit reads nothing back to the host, so a CUDA
# graph can capture a level that runs them (K5 or K12 behind the sort;
# K11). The binned routes read the host once a round.
GRAPH_ROUTES = ("walk", "binned2")


def resolve_route(mesh="auto", b1_fused=False) -> str:
    """`mesh` with "auto" resolved: the walk, which every triangle BVH
    can run and which is the fastest route on the H100 (PERF.md §5), or
    the binned route where `b1_fused` (an option of that route alone)
    asks for it. The JAX package's GRT_MESH=auto takes the binned route,
    a choice made on the TPU."""
    if mesh == "auto":
        return "binned" if b1_fused else "walk"
    return mesh


def route_name(mesh="auto", *, b1_fused=False, traverse8=True) -> str:
    """The route's name as the render stats give it: "binned",
    "binned+b1_fused", "binned2", "walk" (the BVH8 walk) or "walk+bvh2"."""
    mesh = resolve_route(mesh, b1_fused)
    if mesh == "binned" and b1_fused:
        return "binned+b1_fused"
    if mesh == "walk" and not traverse8:
        return "walk+bvh2"
    return mesh


def check_route(bvh, mesh="auto", *, b1_fused=False, traverse8=True):
    """Raise ValueError where the route cannot run on these tables, rather
    than take another one: binned2 without the finer `cl2_*` partition,
    b1_fused off the binned route or with more than 256 clusters or no
    cluster-box table, traverse8=False off the walk route."""
    if mesh != "auto" and mesh not in ROUTES:
        raise ValueError(f"mesh={mesh!r}: expected 'auto' or one of {ROUTES}")
    mesh = resolve_route(mesh, b1_fused)
    if bvh.nodes8 is None:
        raise ValueError("mesh_closest needs a scene with a triangle BVH")
    if mesh == "binned2" and bvh.cl2_lines is None:
        raise ValueError(
            "mesh='binned2' needs the finer cl2_* cluster partition, which "
            "the builder makes only for meshes whose group table fits "
            "CLUSTER2_TABLE_BYTES; this scene has none")
    if b1_fused:
        if mesh != "binned":
            raise ValueError(f"b1_fused is an option of the binned route, "
                             f"not of mesh={mesh!r}")
        k_cl = None if bvh.cl_lo is None else bvh.cl_lo.shape[0]
        if bvh.cl_boxes is None or k_cl > stream_mod.MAX_ROUND_K:
            raise ValueError(
                f"b1_fused needs the cluster-box table and at most "
                f"{stream_mod.MAX_ROUND_K} clusters (this scene: {k_cl})")
    if not traverse8 and mesh != "walk":
        raise ValueError(f"traverse8=False picks the walk route's kernel; "
                         f"it does not apply to mesh={mesh!r}")


def coherence_key(bvh, o, d):
    """(direction octant << 15) | 15-bit Morton code of the origin's cell
    in a 32^3 grid over the root box: the walk routes' and binned2's sort
    key, so neighbouring threads visit the same nodes and clusters."""
    lo = bvh.node_min[0]
    ext = torch.clamp(bvh.node_max[0] - lo, min=1e-6)
    q = torch.clamp((o - lo) / ext * 32.0, 0.0, 31.0).to(torch.int32)
    morton = (_part1by2(q[:, 0]) << 2) | (_part1by2(q[:, 1]) << 1) \
        | _part1by2(q[:, 2])
    octant = ((d[:, 0] > 0).to(torch.int32) << 2) \
        | ((d[:, 1] > 0).to(torch.int32) << 1) | (d[:, 2] > 0).to(torch.int32)
    return (octant << 15) | morton


def _count_call(counters):
    if counters is not None:
        _cuda.count(counters, "mesh_calls")


def _unsort(perm, t_s, i_s):
    t_t = torch.empty_like(t_s)
    i_t = torch.empty_like(i_s)
    t_t[perm] = t_s
    i_t[perm] = i_s
    return t_t, i_t


def _pad_pool(o, d, t_cap, alive, tile):
    """Rays padded to a multiple of `tile` (zero-capped padding rays), with
    dead rays' caps set to 0."""
    n_orig = o.shape[0]
    dev = o.device
    pad = -(-n_orig // tile) * tile - n_orig
    if t_cap is None:
        t_cap = torch.full((n_orig,), INF, dtype=o.dtype, device=dev)
    if alive is not None:
        t_cap = torch.where(alive, t_cap, 0.0)
    if pad:
        o = torch.cat([o, torch.zeros((pad, 3), dtype=o.dtype, device=dev)])
        d = torch.cat([d, torch.ones((pad, 3), dtype=d.dtype, device=dev)])
        t_cap = torch.cat([t_cap, torch.zeros(pad, dtype=t_cap.dtype,
                                              device=dev)])
    return o, d, t_cap


def mesh_closest(ms, o, d, t_cap=None, alive=None, *, mesh="auto",
                 b1_fused=False, traverse8=True, counters=None):
    """Closest triangle hit for rays o, d (N, 3) with per-ray cap `t_cap`
    (default inf) and live mask `alive`: returns (t, idx) with idx == -1
    and t == the cap (0 for a dead ray) where nothing beats the cap.

    mesh="auto" is `resolve_route`'s route. mesh="binned": the binned
    intersector (`b1_fused`: its fused rounds),
    when the scene has cluster tables; mesh="binned2": the
    persistent-block intersector; mesh="walk" (or "binned" with no cluster
    tables): rays are grouped by `coherence_key`, dead rays last, so
    neighbouring threads of the walk (the BVH8 walk, or with
    `traverse8=False` the binary skip-link walk) visit the same nodes; a
    scatter by the permutation restores lane order. All routes return the
    closest hit; where a ray meets two triangles of different groups at
    one t, they may keep different ones."""
    bvh = ms.tri_bvh
    check_route(bvh, mesh, b1_fused=b1_fused, traverse8=traverse8)
    mesh = resolve_route(mesh, b1_fused)
    if mesh == "binned" and bvh.cl_lines is not None:
        return binned_closest(ms, o, d, t_cap, alive, b1_fused=b1_fused,
                              counters=counters)
    if mesh == "binned2":
        return binned2_closest(ms, o, d, t_cap, alive, counters=counters)
    n = o.shape[0]
    key = coherence_key(bvh, o, d)
    if t_cap is None:
        t_cap = torch.full((n,), INF, dtype=o.dtype, device=o.device)
    if alive is not None:
        # a zero cap kills the walk at the root
        t_cap = torch.where(alive, t_cap, 0.0)
        key = torch.where(alive, key, 0x7FFFFFFF)
    perm = torch.sort(key).indices
    o_s, d_s, cap_s = (x[perm].contiguous() for x in (o, d, t_cap))
    if traverse8:
        t_s, i_s = trav8_mod.bvh8_closest(
            bvh.bvh8_nodes, bvh.bvh8_tris, o_s, d_s, cap_s,
            max_stack=bvh.max_stack)
    else:
        t_s, i_s = trav_mod.bvh_closest(bvh.bvh_nodes, bvh.bvh_tris, o_s,
                                        d_s, cap_s, n_nodes=bvh.n_nodes)
    _count_call(counters)
    return _unsort(perm, t_s, i_s)


def _candidates(lo_k, hi_k, ox, oy, oz, dx, dy, dz, t_best, masks):
    """`ops/stream.candidates` with the processed bits as (n_mask, N)
    int32 words."""
    return stream_mod.candidates(lo_k, hi_k, ox, oy, oz, dx, dy, dz, t_best,
                                 stream_mod.processed(masks, lo_k.shape[0]))


def binned_closest(ms, o, d, t_cap=None, alive=None, max_iters: int = 512,
                   b1_fused=False, counters=None):
    """Closest triangle hit via the binned intersector: every round each
    ray picks its nearest cluster whose processed bit is clear (front to
    back, pruned by the ray's evolving t_best), the pool is sorted by that
    cluster id, and `stream_rows` tests each block of `stream.BLOCK`
    sorted rays against the block's contiguous group range. Every cluster
    in a block's range is marked processed for every ray of the block
    (the bits ride the sort as (K/32, N) int32 words), so progress is
    strict and rounds are bounded by K.

    b1_fused: each round after the sort is one launch of
    `stream_round_rows` (the stream, the mark and the next candidates) in
    place of `stream_rows` and the tensor-code mark and scan: the same
    arithmetic, so the same rounds, winners and t.

    Once at most an eighth of the pool still has a candidate, one sort
    packs those rays into the pool's first eighth and the remaining
    rounds run on that prefix only.

    Semantics match the BVH8 walk: the (T_MIN, t_best) interval is seeded
    from t_cap (bvh.go:69-82); front-to-back cluster order with strict
    `near < t_best` candidacy reproduces the BVH early-out."""
    bvh = ms.tri_bvh
    n_orig = o.shape[0]
    dev = o.device
    tile = stream_mod.BLOCK
    o, d, t_cap = _pad_pool(o, d, t_cap, alive, tile)
    n = o.shape[0]
    k_cl = bvh.cl_lo.shape[0]
    n_mask = (k_cl + 31) // 32
    gs = bvh.cl_gs.to(torch.int64)
    rays = [o[:, 0].contiguous(), o[:, 1].contiguous(), o[:, 2].contiguous(),
            d[:, 0].contiguous(), d[:, 1].contiguous(), d[:, 2].contiguous()]
    t_best = t_cap.contiguous()
    idx = torch.full((n,), -1, dtype=torch.int32, device=dev)
    masks = torch.zeros((n_mask, n), dtype=torch.int32, device=dev)
    io = torch.arange(n, device=dev)
    rounds = reads = 0

    def count_active(key):
        nonlocal reads
        reads += 1
        return int((key < k_cl).sum())        # the round's one host read

    def permute(perm, rays, t_best, idx, io, masks):
        return ([r[perm] for r in rays], t_best[perm], idx[perm], io[perm],
                masks[:, perm])

    def one_round(key, rays, t_best, idx, io, masks):
        """Sort by candidate cluster, mark and stream each block's range,
        and find the next candidates."""
        n_p = key.shape[0]
        blocks_p = n_p // tile
        key_s, perm = torch.sort(key)
        rays, t_best, idx, io, masks = permute(perm, rays, t_best, idx, io,
                                               masks)
        kb = key_s.view(blocks_p, tile)
        blk_first = kb[:, 0]
        # last real (non-sentinel) key of the block; keys ascend, so the
        # sentinel rays are a suffix
        blk_last = torch.where(kb < k_cl, kb, -1).amax(dim=1)
        empty = blk_last < 0
        zero = torch.zeros_like(blk_first)
        glo = torch.where(
            empty, zero, gs[torch.clamp(blk_first, 0, k_cl - 1).long()]
            .to(torch.int32))
        ghi = torch.where(
            empty, zero, gs[torch.clamp(blk_last, 0, k_cl - 1).long() + 1]
            .to(torch.int32))
        if b1_fused:
            t_best, idx, key, masks = stream_mod.stream_round_rows(
                bvh.cl_lines, bvh.cl_lo, bvh.cl_hi, glo, ghi,
                torch.where(empty, zero, blk_first), blk_last, *rays,
                t_best, idx, masks)
            return key, rays, t_best, idx, io, masks
        masks = stream_mod.mark_range(masks, blk_first.repeat_interleave(tile),
                                      blk_last.repeat_interleave(tile))
        t_best, idx = stream_mod.stream_rows(bvh.cl_lines, glo, ghi, *rays,
                                             t_best, idx)
        key, _ = _candidates(bvh.cl_lo, bvh.cl_hi, *rays, t_best, masks)
        return key, rays, t_best, idx, io, masks

    key, _ = _candidates(bvh.cl_lo, bvh.cl_hi, *rays, t_best, masks)
    n_active = count_active(key)
    thresh = max(tile, -(-(n // 8) // tile) * tile)
    floor = thresh if thresh < n else 0
    while rounds < max_iters and n_active > floor:
        key, rays, t_best, idx, io, masks = one_round(
            key, rays, t_best, idx, io, masks)
        n_active = count_active(key)
        rounds += 1
    if floor and n_active > 0:
        perm = torch.sort(key).indices
        rays, t_best, idx, io, masks = permute(perm, rays, t_best, idx, io,
                                               masks)
        key = key[perm]
        head = lambda x: x[..., :thresh].contiguous()
        h_rays, h_t, h_idx, h_io = [head(r) for r in rays], head(t_best), \
            head(idx), head(io)
        h_masks, h_key = head(masks), head(key)
        while rounds < max_iters and n_active > 0:
            h_key, h_rays, h_t, h_idx, h_io, h_masks = one_round(
                h_key, h_rays, h_t, h_idx, h_io, h_masks)
            n_active = count_active(h_key)
            rounds += 1
        t_best = torch.cat([h_t, t_best[thresh:]])
        idx = torch.cat([h_idx, idx[thresh:]])
        io = torch.cat([h_io, io[thresh:]])
    # undo the pool permutation
    t_o, i_o = _unsort(io, t_best, idx)
    _count_call(counters)
    if counters is not None:
        counters["rounds"] = counters.get("rounds", 0) + rounds
        counters["host_reads"] = counters.get("host_reads", 0) + reads
    return t_o[:n_orig], i_o[:n_orig]


def binned2_closest(ms, o, d, t_cap=None, alive=None, counters=None):
    """Closest triangle hit via the persistent binned intersector: one
    `coherence_key` sort groups the rays (dead and zero-capped rays last,
    so whole units finish at their first scan), the pool is padded to a
    multiple of `stream2.UNIT`, then one launch of
    `ops/stream2.stream2_rows` runs every unit's rounds over the finer
    `cl2_*` partition, with no host read; a scatter by the permutation
    restores lane order. Winners match the BVH8 walk's."""
    bvh = ms.tri_bvh
    n_orig = o.shape[0]
    o, d, t_cap = _pad_pool(o, d, t_cap, alive, stream2_mod.UNIT)
    key = torch.where(t_cap > 0.0, coherence_key(bvh, o, d), 0x7FFFFFFF)
    perm = torch.sort(key).indices
    o_s, d_s = o[perm], d[perm]
    t_s, i_s = stream2_mod.stream2_rows(
        bvh.cl2_lines, bvh.cl2_lo, bvh.cl2_hi, bvh.cl2_gs,
        *(x[:, k].contiguous() for x in (o_s, d_s) for k in range(3)),
        t_cap[perm].contiguous(),
        torch.full((o.shape[0],), -1, dtype=torch.int32, device=o.device))
    t_o, i_o = _unsort(perm, t_s, i_s)
    _count_call(counters)
    return t_o[:n_orig], i_o[:n_orig]


# ---------------------------------------------------------------------------
# the reference engine's closest hit: every class densely, then the winner's
# attributes (the JAX package's `trace`)
# ---------------------------------------------------------------------------

# hit class codes
CLS_NONE = -1
CLS_SPHERE = 0
CLS_QUAD = 1
CLS_TRI = 2
CLS_MEDIUM = 3
CLS_BOX = 4


@dataclasses.dataclass
class Hit:
    """The closest hit of each ray: `hit` (anything, surface or medium),
    `is_medium`, t, point p, the face-forward normal (hittable.go:27-34),
    `front_face`, texture (u, v), material id, and `med_logp`, the
    log-likelihood of the observed media transit (the score-function
    channel of a density gradient; 0 without media)."""

    hit: torch.Tensor
    is_medium: torch.Tensor
    t: torch.Tensor
    p: torch.Tensor
    normal: torch.Tensor
    front_face: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    mat_id: torch.Tensor
    med_logp: torch.Tensor


def _sphere_attrs(sp, o, d, time, t, idx):
    c0 = sp.center0[idx]
    cd = sp.center_delta[idx]
    r = sp.radius[idx]
    cur_c = c0 + time[:, None] * cd
    p = o + t[:, None] * d
    outward = (p - cur_c) / r[:, None]
    front = _dot(d, outward) < 0
    normal = torch.where(front[:, None], outward, -outward)
    # spherical uv (objects.go:44-50). arccos with a finite derivative at
    # the poles, and atan2's (0, 0) fed as (1, 0), whose value is the same
    # 0: both double wheres keep the value of the plain expression.
    cy = torch.clamp(-outward[:, 1], -1.0, 1.0)
    interior = torch.abs(cy) < 1.0
    theta = torch.where(interior, torch.arccos(torch.where(interior, cy, 0.0)),
                        torch.where(cy > 0, 0.0, math.pi))
    pole = (outward[:, 0] == 0.0) & (outward[:, 2] == 0.0)
    px = torch.where(pole, 1.0, outward[:, 0])
    pz = torch.where(pole, 0.0, -outward[:, 2])
    phi = torch.atan2(pz, px) + math.pi
    return (p, normal, front, phi / (2.0 * math.pi), theta / math.pi,
            sp.mat_id[idx])


def _quad_attrs(qd, o, d, t, idx):
    n = qd.normal[idx]
    p = o + t[:, None] * d
    planar = p - qd.q[idx]
    alpha = _dot(planar, qd.cvw[idx])
    beta = _dot(planar, qd.cwu[idx])
    front = _dot(d, n) < 0
    normal = torch.where(front[:, None], n, -n)
    return p, normal, front, alpha, beta, qd.mat_id[idx]


def _box_attrs(bx, o, d, t, idx):
    """Attributes of a fused-box hit: the outward normal is the axis of
    the slab that bounds the winning t (the entry slab when t is the entry
    distance, else the exit slab), the face normal the six-quad box
    (objects.go:227-237) reports; rotated rows compute the slab in object
    space and rotate the normal back (transformation.go:94-107). uv is
    zero (box fusion is gated on uv-independent textures)."""
    lo, hi = bx.lo[idx], bx.hi[idx]
    cos, sin = bx.cos_t[idx], bx.sin_t[idx]
    osh = o - bx.offset[idx]
    oo = torch.stack([cos * osh[:, 0] - sin * osh[:, 2], osh[:, 1],
                      sin * osh[:, 0] + cos * osh[:, 2]], dim=-1)
    do = torch.stack([cos * d[:, 0] - sin * d[:, 2], d[:, 1],
                      sin * d[:, 0] + cos * d[:, 2]], dim=-1)
    d_safe = torch.where(torch.abs(do) < 1e-30,
                         torch.where(do < 0, -1e-30, 1e-30), do)
    inv = 1.0 / d_safe
    t0 = (lo - oo) * inv
    t1 = (hi - oo) * inv
    per_lo = torch.minimum(t0, t1)
    per_hi = torch.maximum(t0, t1)
    near = per_lo.amax(dim=-1)
    far = per_hi.amin(dim=-1)
    entry = torch.abs(t - near) <= torch.abs(far - t)
    per = torch.where(entry[:, None], per_lo, per_hi)
    axis = torch.argmax(torch.where(entry[:, None], per, -per), dim=-1)
    sgn = torch.sign(torch.gather(d_safe, 1, axis[:, None]))[:, 0]
    sgn = torch.where(entry, -sgn, sgn)
    out_obj = sgn[:, None] * torch.eye(3, dtype=o.dtype, device=o.device)[axis]
    outward = torch.stack([cos * out_obj[:, 0] + sin * out_obj[:, 2],
                           out_obj[:, 1],
                           -sin * out_obj[:, 0] + cos * out_obj[:, 2]], dim=-1)
    front = _dot(d, outward) < 0
    normal = torch.where(front[:, None], outward, -outward)
    zero = torch.zeros_like(t)
    return o + t[:, None] * d, normal, front, zero, zero, bx.mat_id[idx]


def _tri_attrs(tr, o, d, t, idx):
    """Attributes of a triangle hit: barycentrics recomputed for the
    winner in the local form (objects.go:408-446), the interpolated vertex
    normal where the mesh has one, else the face normal, and the
    interpolated vertex uv where present, else the barycentrics
    (objects.go:437-446)."""
    _, u, v, _ = tri_hit_gathered(tr, idx, o, d, -INF, INF)
    p = o + t[:, None] * d
    w = 1.0 - u - v
    vn = tr.vn[idx]
    n_interp = vm.normalize(w[:, None] * vn[:, 0] + u[:, None] * vn[:, 1]
                            + v[:, None] * vn[:, 2])
    n_raw = torch.where(tr.has_vn[idx][:, None], n_interp, tr.n_face[idx])
    front = _dot(d, n_raw) < 0
    normal = torch.where(front[:, None], n_raw, -n_raw)
    uvt = tr.uv[idx]
    uv_i = w[:, None] * uvt[:, 0] + u[:, None] * uvt[:, 1] \
        + v[:, None] * uvt[:, 2]
    has_uv = tr.has_uv[idx]
    return (p, normal, front, torch.where(has_uv, uv_i[:, 0], u),
            torch.where(has_uv, uv_i[:, 1], v), tr.mat_id[idx])


def media_candidates(ds, o, d, t_solid, u_med, t_min=T_MIN):
    """Each medium's scattering-candidate distance (N, M), inf where none,
    and (t0, t1, span_ok, ray_len) for the transit likelihood.

    medium.go:27-58: the boundary span (sphere roots, or the rotated box's
    slabs in object space), clamped by [rayT.Min, closest solid], and the
    exponential free flight -ln(U) / rho. The sampled distance is
    detached: a density gradient flows only through the score-function
    factor (`trace`'s med_logp, `integrator/wavefront._bounce`), so the
    pathwise and likelihood channels never count twice."""
    med = ds.media
    o_b = o[:, None, :]
    d_b = d[:, None, :]
    near_s, far_s, ok_s = ix.sphere_roots(med.center[None, :, :],
                                          med.radius[None, :], o_b, d_b)
    cos = med.cos_t[None, :]
    sin = med.sin_t[None, :]
    osh = o_b - med.offset[None, :, :]
    o_obj = torch.stack([cos * osh[..., 0] - sin * osh[..., 2], osh[..., 1],
                         sin * osh[..., 0] + cos * osh[..., 2]], dim=-1)
    dy_b = d_b[..., 1].expand(o.shape[0], med.kind.shape[0])
    d_obj = torch.stack([cos * d_b[..., 0] - sin * d_b[..., 2], dy_b,
                         sin * d_b[..., 0] + cos * d_b[..., 2]], dim=-1)
    near_b, far_b, ok_b = ix.box_slab_span(med.box_min[None, :, :],
                                           med.box_max[None, :, :],
                                           o_obj, d_obj)
    is_sphere = (med.kind == T.MEDIUM_SPHERE)[None, :]
    near = torch.where(is_sphere, near_s, near_b)
    far = torch.where(is_sphere, far_s, far_b)
    ok = torch.where(is_sphere, ok_s, ok_b)
    ok = ok & (far > near + 1e-4)            # second boundary hit (medium.go:34)
    t0 = torch.clamp(near, min=t_min)        # medium.go:37
    t1 = torch.minimum(far, t_solid[:, None])  # medium.go:38
    ok = ok & (t0 < t1)                      # medium.go:39
    t0 = torch.clamp(t0, min=0.0)            # medium.go:43
    ray_len = vm.length(d)[:, None]
    dist_inside = (t1 - t0) * ray_len
    hit_dist = (med.neg_inv_density[None, :] * torch.log(u_med)).detach()
    span_ok = ok & med.active[None, :]
    ok = span_ok & (hit_dist <= dist_inside)
    t_cand = t0 + hit_dist / ray_len
    return torch.where(ok, t_cand, INF), (t0, t1, span_ok, ray_len)


def trace(ds, o, d, time, u_med, t_min: float = T_MIN, t_max: float = INF,
          alive=None, *, mesh="auto", b1_fused=False, traverse8=True,
          counters=None) -> Hit:
    """The closest hit of a ray bundle over every primitive class and the
    media (the JAX package's `trace`). ds = `to_device(scene, device)`;
    u_med (N, M) are the media's uniforms; `alive` (N,) bool, optional:
    dead rays skip the triangle BVH walk (their hit is never read).

    Spheres, quads and boxes resolve densely first; their nearest hit caps
    the triangle search (the shrinking rayT.Max of bvh.go:69-82 across
    classes). Triangles of a BVH mesh go through `mesh_closest` on the
    route that `mesh`, `b1_fused` and `traverse8` pick (on the card the
    walk's default, the K5 kernel; the plain version on the CPU), pruned by
    that cap; a mesh below the BVH threshold is tested densely
    (`ops/intersect.tri_ts_factored`)."""
    n = o.shape[0]
    dev = o.device
    per_class = []
    if ds.has_spheres:
        ts = ix.sphere_ts(ds.spheres, o, d, time, t_min, t_max)
        per_class.append((CLS_SPHERE, *ts.min(dim=1)))
    if ds.has_quads:
        ts = ix.quad_ts(ds.quads, o, d, t_min, t_max)
        per_class.append((CLS_QUAD, *ts.min(dim=1)))
    if ds.has_boxes:
        ts = ix.box_ts(ds.boxes, o, d, t_min, t_max)
        per_class.append((CLS_BOX, *ts.min(dim=1)))
    t_solid = torch.full((n,), INF, dtype=o.dtype, device=dev)
    cls = torch.full((n,), CLS_NONE, dtype=torch.int64, device=dev)
    loc = torch.zeros((n,), dtype=torch.int64, device=dev)
    for code, t_c, i_c in per_class:
        closer = t_c < t_solid
        t_solid = torch.where(closer, t_c, t_solid)
        cls = torch.where(closer, code, cls)
        loc = torch.where(closer, i_c, loc)

    if ds.has_triangles:
        n_tri = ds.triangles.v0.shape[0]
        if ds.has_tri_bvh:
            t_t, i_t = mesh_closest(ds, o.detach(), d.detach(),
                                    t_cap=t_solid.detach(), alive=alive,
                                    mesh=mesh, b1_fused=b1_fused,
                                    traverse8=traverse8, counters=counters)
            i_t = i_t.to(torch.int64)
        else:
            ts = ix.tri_ts_factored(ds.triangles, o, d, t_min, t_max)
            t_t, i_t = ts.min(dim=1)
            i_t = torch.where(torch.isfinite(t_t), i_t, -1)
        tri_win = (i_t >= 0) & (t_t < t_solid)
        t_solid = torch.where(tri_win, t_t, t_solid)
        cls = torch.where(tri_win, CLS_TRI, cls)
        loc = torch.where(tri_win, torch.clamp(i_t, 0, n_tri - 1), loc)

    if ds.has_media:
        med_ts, (m_t0, m_t1, m_ok, ray_len) = media_candidates(
            ds, o, d, t_solid, u_med, t_min)
        t_med, med_idx = med_ts.min(dim=1)
        is_medium = t_med < t_solid
        t = torch.where(is_medium, t_med, t_solid)
        cls = torch.where(is_medium, CLS_MEDIUM, cls)
        # transit log-likelihood of the observed outcome at t:
        # transmittance exp(-rho * overlap) per crossed medium, and the
        # winner's free-flight density rho (the score-function channel of
        # d/d(density))
        rho = -1.0 / ds.media.neg_inv_density
        t_evt = t.detach()
        overlap = torch.clamp(torch.minimum(m_t1, t_evt[:, None]) - m_t0,
                              min=0.0) * ray_len
        overlap = torch.where(m_ok, overlap, 0.0).detach()
        med_logp = -torch.sum(rho[None, :] * overlap, dim=1)
        med_logp = med_logp + torch.where(
            is_medium, torch.log(torch.index_select(rho, 0, med_idx)), 0.0)
    else:
        med_idx = torch.zeros((n,), dtype=torch.int64, device=dev)
        is_medium = torch.zeros((n,), dtype=torch.bool, device=dev)
        t = t_solid
        med_logp = torch.zeros((n,), dtype=o.dtype, device=dev)

    hit = torch.isfinite(t) & (cls != CLS_NONE)
    t_safe = torch.where(hit, t, 1.0)
    p = o + t_safe[:, None] * d
    x_axis = torch.zeros_like(p)
    x_axis[:, 0] = 1.0          # filled on the device: no host constant
    cur = (p, x_axis,
           torch.ones((n,), dtype=torch.bool, device=dev),
           torch.zeros_like(t_safe), torch.zeros_like(t_safe),
           torch.zeros((n,), dtype=ds.materials.kind.dtype, device=dev))

    def merge(mask, attrs, cur):
        return tuple(torch.where(mask[:, None] if a.dim() == 2 else mask, a, c)
                     for a, c in zip(attrs, cur))

    # each class gathers its winner's row, clamped into its own table
    at = lambda table: torch.clamp(loc, 0, table.mat_id.shape[0] - 1)
    if ds.has_spheres:
        cur = merge(cls == CLS_SPHERE, _sphere_attrs(
            ds.spheres, o, d, time, t_safe, at(ds.spheres)), cur)
    if ds.has_quads:
        cur = merge(cls == CLS_QUAD, _quad_attrs(
            ds.quads, o, d, t_safe, at(ds.quads)), cur)
    if ds.has_boxes:
        cur = merge(cls == CLS_BOX, _box_attrs(
            ds.boxes, o, d, t_safe, at(ds.boxes)), cur)
    if ds.has_triangles:
        cur = merge(cls == CLS_TRI, _tri_attrs(
            ds.triangles, o, d, t_safe, at(ds.triangles)), cur)
    if ds.has_media:
        # a medium record: normal (1, 0, 0), front face true (medium.go:54-55)
        cur = merge(cls == CLS_MEDIUM,
                    (p, cur[1], torch.ones_like(cur[2]), cur[3], cur[4],
                     ds.media.mat_id[med_idx]), cur)
    p, normal, front, uu, vv, mat = cur
    return Hit(hit=hit, is_medium=is_medium & hit, t=t, p=p, normal=normal,
               front_face=front, u=uu, v=vv, mat_id=mat.to(torch.int64),
               med_logp=med_logp)
