"""The BVH8 stack walk of the port against the JAX package: the plain
version of the kernel against the Pallas kernel in interpret mode (the
cases of tests/test_traverse8.py), and the port's two routes against each
other."""

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_raytracer_tpu.ops.pallas import traverse8 as ptrav8
from go_raytracer_tpu.scene import bvh8 as jbvh8
from go_raytracer_tpu_torch.ops import stream as tstream
from go_raytracer_tpu_torch.ops import trace as ttrace
from go_raytracer_tpu_torch.ops import traverse8 as ttrav8
from go_raytracer_tpu_torch.scene import bvh8 as tbvh8
from go_raytracer_tpu_torch.scene import types as TT
from tests.test_bvh import _scenes_with_and_without_bvh
from tests.test_torch_stream import mesh_pair, rays

torch.set_num_threads(2)


def both(js, o, d, cap, dense_nodes=None):
    """(t, idx) of the Pallas kernel (interpret mode) and of the port's
    plain version on the same tables and rays."""
    bvh = js.tri_bvh
    nodes, dense = bvh.nodes8, bvh.bvh8_dense
    if dense_nodes is not None and dense_nodes != dense:
        # re-pack the node table the other way
        e = ttrav8.node_entries(torch.from_numpy(np.asarray(nodes)), dense)
        pack = jbvh8._pack_lines if dense_nodes else jbvh8._pad_lines
        nodes, dense = pack(e.numpy().copy()), dense_nodes
    jt, ji = ptrav8.bvh8_closest(
        jnp.asarray(nodes), bvh.tris8, jnp.asarray(o), jnp.asarray(d),
        None if cap is None else jnp.asarray(cap), dense_nodes=dense,
        interpret=True)
    tt = torch.from_numpy
    pt, pi = ttrav8.bvh8_closest(
        *ttrav8.pack_tables(np.asarray(nodes), np.asarray(bvh.tris8), dense),
        tt(o), tt(d), None if cap is None else tt(cap))
    return (np.asarray(jt), np.asarray(ji)), (pt.numpy(), pi.numpy())


@pytest.mark.parametrize("dense_nodes", [False, True])
def test_bvh8_closest_ref_matches_pallas_kernel(dense_nodes, monkeypatch):
    """Padded and line-packed node tables, capped rays (cap pruning) and
    dead rays (cap 0): idx exact, t within rtol 1e-6; a miss returns the
    cap and -1."""
    js, _ = mesh_pair(3000, 33, monkeypatch)
    o, d, cap, alive = rays(2176, 34)
    cap0 = np.where(alive, cap, 0.0).astype(np.float32)
    (jt, ji), (pt, pi) = both(js, o, d, cap0, dense_nodes=dense_nodes)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pt, jt, rtol=1e-6)
    miss = pi < 0
    np.testing.assert_array_equal(pt[miss], cap0[miss])
    assert (pi[~alive] == -1).all() and (pi >= 0).sum() > 100
    # pruning: a capped ray never reports a hit beyond its cap
    assert (pt[pi >= 0] < cap0[pi >= 0]).all()
    assert ttrav8.launches == 0            # CPU tensors never launch


def test_single_leaf_tree(monkeypatch):
    """A mesh smaller than one leaf: the root's only slot is the leaf."""
    js, _ = _scenes_with_and_without_bvh(3, seed=5)
    assert js.tri_bvh.n_nodes == 1
    o, d, _, _ = rays(512, 6, caps=False)
    o = (o * 0.5).astype(np.float32)
    (jt, ji), (pt, pi) = both(js, o, d, None)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pt, jt, rtol=1e-6)


def test_max_stack_bounds_the_walk(monkeypatch):
    """bvh8.max_stack is an upper bound of the deepest stack the plain
    walk reaches (rays through the whole tree, no cap), and small."""
    js, ms = mesh_pair(3000, 33, monkeypatch)
    bound = ms.tri_bvh.max_stack
    assert bound == tbvh8.max_stack(np.asarray(js.tri_bvh.nodes8),
                                    js.tri_bvh.bvh8_dense)
    assert 8 <= bound <= ttrav8.STACK


def test_walk_and_binned_routes_agree_on_statue():
    """On the procedural statue (shared edges, so equal-t ties occur) the
    port's walk route and binned route return the same winners and the
    same t, bit for bit."""
    from go_raytracer_tpu_torch.scene import obj_loader
    from go_raytracer_tpu_torch.scene.builder import SceneBuilder

    b = SceneBuilder()
    obj_loader.procedural_statue(
        b, b.lambertian((1, 1, 1)), obj_loader.LoadOptions(scale_factor=5.0),
        major_segments=64, minor_segments=32)
    ms = ttrace.to_device(b.build(cluster_tris=64), "cpu")
    assert ms.has_tri_bvh and ms.tri_bvh.cl_lo.shape[0] > 32
    rs = np.random.default_rng(9)
    n = 3000
    o = torch.from_numpy(rs.uniform(-8, 8, (n, 3)).astype(np.float32))
    d = -o + torch.from_numpy(rs.normal(size=(n, 3)).astype(np.float32)) * 2
    cap = torch.from_numpy(np.where(rs.uniform(size=n) < 0.3, 9.0, np.inf)
                           .astype(np.float32))
    alive = torch.from_numpy(rs.uniform(size=n) < 0.9)
    bt, bi = ttrace.mesh_closest(ms, o, d, cap, alive, mesh="binned")
    wt, wi = ttrace.mesh_closest(ms, o, d, cap, alive, mesh="walk")
    assert (bi >= 0).sum() > 500
    assert torch.equal(bi, wi) and torch.equal(bt, wt)
    with pytest.raises(ValueError, match="binned"):
        ttrace.mesh_closest(ms, o, d, mesh="other")


def _bvh8_tables(v, leaf_size, dense_nodes=None):
    """The K5 rows (nodes, tris; `ops/traverse8.pack_tables`), the node
    layout and `max_stack` of a BVH over triangle vertices v (T, 3, 3) with
    leaves of at most `leaf_size`, as the port's scene compile makes them
    (scene/bvh.build, then scene/bvh8.collapse), on the CPU."""
    from go_raytracer_tpu_torch.scene import bvh as tbvh

    fb = tbvh.build(v, leaf_size=leaf_size)
    vp = v[fb.order[:v.shape[0]]].astype(np.float32)
    b8 = tbvh8.collapse(fb.node_min, fb.node_max, fb.first, fb.count,
                        fb.skip, vp[:, 0], vp[:, 1] - vp[:, 0],
                        vp[:, 2] - vp[:, 0], max_leaf=leaf_size,
                        dense_nodes=dense_nodes)
    return (*ttrav8.pack_tables(b8.node_lines, b8.tri_lines, b8.dense_nodes),
            b8.dense_nodes, tbvh8.max_stack(b8.node_lines, b8.dense_nodes))


def _statue_vertices():
    """The procedural statue's triangles as vertices (T, 3, 3)."""
    from go_raytracer_tpu_torch.scene import obj_loader
    from go_raytracer_tpu_torch.scene.builder import SceneBuilder

    b = SceneBuilder()
    obj_loader.procedural_statue(
        b, b.lambertian((1, 1, 1)), obj_loader.LoadOptions(scale_factor=5.0),
        major_segments=64, minor_segments=32)
    tr = b.build().triangles
    v0, e0, e1 = (np.asarray(getattr(tr, f)) for f in ("v0", "e0", "e1"))
    return np.stack([v0, v0 + e0, v0 + e1], axis=1).astype(np.float32)


def _popc8(x):
    return sum((x >> b) & 1 for b in range(8))


def team_walk_model(nodes, tris, o, d, t_cap, *, team, steps=None):
    """CPU model of the schedule of csrc/traverse8.cu: a team of `team`
    lanes per ray, lane k holding child slots (and triangles) k, k + team,
    ... A node visit's pushes go to sp + the popcount of the team's ballot
    below the slot; a group's winner is the lex-least (t, -id) over the
    lanes, first within a lane over its slots, then by xor butterflies
    over the team, and it replaces t_best when below it; a two-group leaf
    tests both groups against the t_best from before it and takes group
    g's winner where below t_best, then group g + 1's where below that
    (the plain walk reduces g + 1 from the new t_best). The box test is the
    kernel's (NaN-ignoring fmin/fmax behind an explicit NaN check). Returns
    (t, idx, per-ray node visits, per-ray group tests); `steps` receives
    each step's popped entry per ray, as `bvh8_closest_ref` gives it."""
    n = o.shape[0]
    node_e, tri_e = ttrav8.entries(nodes, tris)
    ox, oy, oz = (o[:, k].contiguous() for k in range(3))
    dx, dy, dz = (d[:, k].contiguous() for k in range(3))
    ix, iy, iz = (ttrav8._safe_inv(x) for x in (dx, dy, dz))
    t_best = t_cap.clone()
    idx = torch.full((n,), -1, dtype=torch.int32)
    stack = torch.zeros((n, 128), dtype=torch.int64)
    sp = torch.ones(n, dtype=torch.int64)
    lanes = torch.arange(n)
    n_vis = torch.zeros(n, dtype=torch.int64)
    n_grp = torch.zeros(n, dtype=torch.int64)
    inf = torch.tensor(float("inf"))
    per = 8 // team
    while bool((sp > 0).any()):
        act = sp > 0
        sp = sp - act.to(torch.int64)
        m = stack[lanes, sp]
        if steps is not None:
            steps.append(torch.where(act, m, ttrav8.DONE))
        is_node, is_leaf = act & (m >= 0), act & (m < 0)
        n_vis += is_node
        # node visit: lane k tests slots k + j * team, then the ballot
        e = node_e[torch.where(is_node, m, 0)]
        hit = {}
        for k in range(team):
            for j in range(per):
                c = k + j * team
                tx0 = (e[:, c, 0] - ox) * ix
                tx1 = (e[:, c, 3] - ox) * ix
                ty0 = (e[:, c, 1] - oy) * iy
                ty1 = (e[:, c, 4] - oy) * iy
                tz0 = (e[:, c, 2] - oz) * iz
                tz1 = (e[:, c, 5] - oz) * iz
                ts = (tx0, tx1, ty0, ty1, tz0, tz1)
                finite = torch.stack([x == x for x in ts]).all(dim=0)
                near = torch.fmax(torch.fmax(torch.fmin(tx0, tx1),
                                             torch.fmin(ty0, ty1)),
                                  torch.fmin(tz0, tz1))
                far = torch.fmin(torch.fmin(torch.fmax(tx0, tx1),
                                            torch.fmax(ty0, ty1)),
                                 torch.fmax(tz0, tz1))
                hit[c] = is_node & finite & (
                    torch.fmax(near, torch.tensor(tstream.T_MIN))
                    < torch.fmin(far, t_best))
        mask = sum(hit[c].to(torch.int64) << c for c in range(8))
        for c in range(8):
            h = hit[c]
            pos = sp + _popc8(mask & ((1 << c) - 1))
            stack[lanes[h], pos[h]] = e[h, 0, 8 + c].to(torch.int64)
        sp = sp + _popc8(mask)
        # leaf visit: both groups against the t_best from before the leaf,
        # each reduced over the team; then group g's winner where below
        # t_best, and group g + 1's where below that
        enc = torch.where(is_leaf, -m - 1, 0)
        t_leaf = t_best
        for q, on in ((0, is_leaf), (1, is_leaf & ((enc & 1) > 0))):
            n_grp += on
            grp = tri_e[(enc >> 1) + q * on]
            bt = [inf.expand(n).clone() for _ in range(team)]
            bid = [torch.full((n,), -1.0) for _ in range(team)]
            for k in range(team):
                for j in range(per):
                    tri = grp[:, k + j * team]
                    tt, ok = tstream.mt_tri_ref(tri, ox, oy, oz, dx, dy, dz,
                                                t_leaf)
                    ok = ok & on
                    better = ok & ((tt < bt[k]) | ((tt == bt[k])
                                                   & (tri[:, 9] > bid[k])))
                    bt[k] = torch.where(better, tt, bt[k])
                    bid[k] = torch.where(better, tri[:, 9], bid[k])
            off = team // 2
            while off:
                nt = [bt[k ^ off] for k in range(team)]
                ni = [bid[k ^ off] for k in range(team)]
                for k in range(team):
                    take = (nt[k] < bt[k]) | ((nt[k] == bt[k])
                                              & (ni[k] > bid[k]))
                    bt[k] = torch.where(take, nt[k], bt[k])
                    bid[k] = torch.where(take, ni[k], bid[k])
                off //= 2
            assert all(torch.equal(bt[k], bt[0])
                       and torch.equal(bid[k], bid[0]) for k in range(team))
            upd = on & (bt[0] < t_best)
            t_best = torch.where(upd, bt[0], t_best)
            idx = torch.where(upd, bid[0].to(torch.int32), idx)
    return t_best, idx, n_vis, n_grp


def _model_case(tree):
    """Tables and rays of one case of the schedule test: the statue; 3,001
    random triangles in leaves of up to 16 (two-group leaves); and a mesh
    of which every triangle is there twice (ties inside a group and across
    leaves). Rays through the mesh, 30% capped, 10% with a zero cap."""
    rs = np.random.default_rng(41)
    if tree == "statue":
        v, leaf, scale = _statue_vertices(), 8, 8.0
    else:
        v = (rs.uniform(-10, 10, (1500, 1, 3))
             + rs.uniform(-0.8, 0.8, (1500, 3, 3))).astype(np.float32)
        if tree == "coincident":
            v = np.concatenate([v, v[::-1]])     # each triangle twice
        leaf, scale = 16, 12.0
    nodes, tris, dense, ms = _bvh8_tables(v, leaf)
    n = 700
    o = rs.uniform(-scale, scale, (n, 3)).astype(np.float32)
    d = (-o * rs.uniform(0, 1, (n, 1)) + rs.normal(size=(n, 3))) \
        .astype(np.float32)
    cap = np.where(rs.uniform(size=n) < 0.3, scale, np.inf)
    cap = np.where(rs.uniform(size=n) < 0.9, cap, 0.0).astype(np.float32)
    return nodes, tris, dense, ms, *(torch.from_numpy(x) for x in (o, d, cap))


@pytest.mark.parametrize("team", [8, 4])
@pytest.mark.parametrize("tree", ["statue", "two_group", "coincident"])
def test_team_schedule_equals_plain_walk(tree, team):
    """The kernel's team schedule (CPU model, 8 lanes a ray or 4 with two
    slots each) against `bvh8_closest_ref`: the same visit sequence per
    ray, step for step, the same per-ray node visits and group tests, and
    the winners and t bit for bit; on the statue, on leaves of two groups
    and on coincident triangles (a tie inside a group goes to the larger
    triangle id, across groups to the first in walk order), with NaN empty
    slots and zero caps in every case."""
    nodes, tris, dense, max_stack, o, d, cap = _model_case(tree)
    ref_steps, mod_steps, visits = [], [], {}
    pt, pi = ttrav8.bvh8_closest_ref(nodes, tris, o, d, cap, visits=visits,
                                     steps=ref_steps)
    mt, mi, mv, mg = team_walk_model(nodes, tris, o, d, cap, team=team,
                                     steps=mod_steps)
    assert len(mod_steps) == len(ref_steps)
    assert all(torch.equal(a, b) for a, b in zip(mod_steps, ref_steps))
    assert torch.equal(mv, visits["ray_visits"])
    assert torch.equal(mg, visits["ray_groups"])
    assert visits["node_visits"] == int(mv.sum()) > 0
    assert torch.equal(mi, pi) and torch.equal(mt, pt)
    # what the case covers
    node_e, tri_e = ttrav8.entries(nodes, tris)
    assert bool(torch.isnan(node_e[:, :, 0]).any())         # empty slots
    assert (pi[cap == 0] == -1).all() and (cap == 0).sum() > 30
    assert (pi >= 0).sum() > 100
    assert max_stack <= ttrav8.STACK
    popped = torch.stack(ref_steps)
    leaves = popped[(popped < 0)]
    if tree != "statue":
        assert bool(((-leaves - 1) & 1).any())               # two groups
    if tree == "coincident":
        # ties: hit lanes where another triangle of the table meets the ray
        # at the winner's t
        tri = tri_e.reshape(-1, 16)
        tri = tri[tri[:, 9] >= 0]
        h = torch.nonzero(pi >= 0)[:, 0]
        tt, ok = tstream.mt_tri_ref(
            tri[None], *(x[h, None] for x in (o[:, 0], o[:, 1], o[:, 2],
                                               d[:, 0], d[:, 1], d[:, 2])),
            torch.tensor(float("inf")))
        ties = (ok & (tt == pt[h, None])).sum(dim=1)
        assert (ties >= 2).sum() > 100


@pytest.mark.parametrize("dense_nodes", [False, True])
def test_pack_tables_round_trip(dense_nodes):
    """`pack_tables` keeps every value of scene/bvh8.collapse's lines in
    either node layout: `unpack_tables` gives the lines back exactly (NaN
    boxes of empty slots included), its node rows are 32 bytes and its
    triangle rows 48, and a table with data where the rows have no room
    is refused."""
    v = _statue_vertices()
    from go_raytracer_tpu_torch.scene import bvh as tbvh

    fb = tbvh.build(v, leaf_size=16)
    vp = v[fb.order[:v.shape[0]]]
    b8 = tbvh8.collapse(fb.node_min, fb.node_max, fb.first, fb.count,
                        fb.skip, vp[:, 0], vp[:, 1] - vp[:, 0],
                        vp[:, 2] - vp[:, 0], max_leaf=16,
                        dense_nodes=dense_nodes)
    nodes, tris = ttrav8.pack_tables(b8.node_lines, b8.tri_lines,
                                     dense_nodes)
    assert nodes.shape[1] * 4 == 32 and tris.shape[1] * 4 == 48
    back_n, back_t = ttrav8.unpack_tables(nodes, tris, dense_nodes)
    np.testing.assert_array_equal(back_n, b8.node_lines)
    np.testing.assert_array_equal(back_t, b8.tri_lines)
    assert np.isnan(b8.node_lines).any()
    bad = b8.tri_lines.copy()
    bad[0, 12] = 1.0
    with pytest.raises(ValueError, match="not zero"):
        ttrav8.pack_tables(b8.node_lines, bad, dense_nodes)
