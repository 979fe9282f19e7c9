"""The binary-BVH skip-link walk of the port (K12, ops/traverse.py) against
the JAX package: `pack_bvh`'s tables against the JAX rows value for value,
the plain version against the Pallas kernel `bvh_closest` in interpret
mode, and the walk route with the BVH8 walk turned off against the JAX
`pallas_bvh_closest` under GRT_MESH=walk GRT_TRAVERSE8=0; and the plain
version on the aligned tables against the walk over the plain 36-byte rows
that it replaced, on the statue and on a random mesh (bit for bit).

The Pallas kernel shares one walk per tile of 1024 rays, the port walks
each ray on its own; a lane where the two part ways is named in the
assertion message (none does on these rays)."""

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_raytracer_tpu.ops import trace as jtrace
from go_raytracer_tpu.ops.pallas import traverse as ptrav
from go_raytracer_tpu_torch.ops import trace as ttrace
from go_raytracer_tpu_torch.ops import traverse as ttrav
from go_raytracer_tpu_torch.ops import traverse8 as ttrav8
from go_raytracer_tpu_torch.ops.stream import T_MIN, mt_tri_ref, safe_inv
from go_raytracer_tpu_torch.scene import bvh as tbvh
from go_raytracer_tpu_torch.scene import types as TT
from go_raytracer_tpu_torch.scenes import registry
from tests.test_bvh import _scenes_with_and_without_bvh, random_mesh

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene_pair():
    """3000 random triangles behind a BVH (leaf size 4), as the JAX
    package's tests build them, and the same scene carried to the port."""
    js, _ = _scenes_with_and_without_bvh(3000, seed=33)
    ts = TT.scene_from_numpy(js)
    return js, ts, ttrace.to_device(ts, "cpu")


def _rays(n, seed):
    rs = np.random.default_rng(seed)
    o = rs.uniform(-15, 15, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    cap = np.where(rs.uniform(size=n) < 0.3, 5.0, np.inf).astype(np.float32)
    alive = rs.uniform(size=n) < 0.9
    return o, d, cap, alive


def _unpack(lines, rows, cols):
    return np.asarray(lines).reshape(-1, 16)[:rows, :cols]


def _differing_lanes(ti, tt_, ji, jt):
    bad = np.nonzero((ti != ji) | ~np.isclose(tt_, jt, rtol=1e-6))[0]
    return [(int(k), float(tt_[k]), float(jt[k]), int(ti[k]), int(ji[k]))
            for k in bad[:10]]


def _plain_rows(nodes, tris):
    """The aligned tables back to the 36-byte rows: nodes [min(3), max(3),
    first, count, skip], triangles [v0, e0, e1]."""
    nodes, tris = torch.as_tensor(nodes), torch.as_tensor(tris)
    return (ttrav.unpack_nodes(nodes).numpy(),
            tris.view(-1, 3, 4)[:, :, :3].reshape(-1, 9).numpy())


def test_pack_bvh_rows_equal_jax(scene_pair):
    """The aligned tables hold the JAX package's packed lines value for
    value: node rows [min, max, first, count, skip] (first, count and skip
    exact) and triangle rows [v0, e0, e1] + leaf_size zero rows, with a
    zero after each 3-vector."""
    js, ts, ms = scene_pair
    jn, jt = ptrav.pack_bvh(js)
    tn, tt_ = ttrav.pack_bvh(ts)
    m, r = tn.shape[0], tt_.shape[0]
    assert tn.shape == (js.tri_bvh.n_nodes, 8) and tn.dtype == np.float32
    assert tt_.shape == (js.triangles.count + js.tri_bvh.leaf_size, 12)
    rows, tris = _plain_rows(tn, tt_)
    np.testing.assert_array_equal(rows, _unpack(jn, m, 9))
    np.testing.assert_array_equal(tris, _unpack(jt, r, 9))
    assert not tt_[:, 3::4].any() and not tt_[-js.tri_bvh.leaf_size:].any()
    bvh = js.tri_bvh
    np.testing.assert_array_equal(rows[:, 6:].astype(np.int64), np.stack(
        [bvh.first, bvh.count, bvh.skip], axis=1))
    assert torch.equal(ms.tri_bvh.bvh_nodes, torch.from_numpy(tn))
    assert torch.equal(ms.tri_bvh.bvh_tris, torch.from_numpy(tt_))


def test_pack_tables_refuses_a_leaf_that_skips_ahead():
    """A leaf's skip link must be the next node (the aligned row keeps only
    its count); an inner node keeps any skip."""
    rows = np.array([[0, 0, 0, 1, 1, 1, 0, 0, 3],
                     [0, 0, 0, 1, 1, 1, 0, 2, 2],
                     [0, 0, 0, 1, 1, 1, 2, 2, 3]], np.float32)
    nodes, _ = ttrav.pack_tables(rows, np.zeros((4, 9), np.float32))
    assert nodes[:, 7].tolist() == [3.0, -2.0, -2.0]
    rows[1, 8] = 3
    with pytest.raises(ValueError, match="skip"):
        ttrav.pack_tables(rows, np.zeros((4, 9), np.float32))


def _row_walk(rows, tris, o, d, t_cap, n_nodes):
    """The plain walk over the 36-byte rows, as the port had it before the
    aligned tables (the same steps as `bvh_closest_ref`, reading [min(3),
    max(3), first, count, skip] and [v0, e0, e1])."""
    rows, tris = torch.from_numpy(rows), torch.from_numpy(tris)
    n = o.shape[0]
    ox, oy, oz = (o[:, k].contiguous() for k in range(3))
    dx, dy, dz = (d[:, k].contiguous() for k in range(3))
    ix, iy, iz = safe_inv(dx), safe_inv(dy), safe_inv(dz)
    t_best = t_cap.clone()
    idx = torch.full((n,), -1, dtype=torch.int32)
    node = torch.zeros(n, dtype=torch.int64)
    while True:
        act = torch.nonzero(node < n_nodes)[:, 0]
        if act.numel() == 0:
            return t_best, idx
        nc = node[act]
        r = rows[nc]
        ax, ay, az = ox[act], oy[act], oz[act]
        tx0, tx1 = (r[:, 0] - ax) * ix[act], (r[:, 3] - ax) * ix[act]
        ty0, ty1 = (r[:, 1] - ay) * iy[act], (r[:, 4] - ay) * iy[act]
        tz0, tz1 = (r[:, 2] - az) * iz[act], (r[:, 5] - az) * iz[act]
        near = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                           torch.minimum(ty0, ty1)),
                             torch.minimum(tz0, tz1))
        far = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                          torch.maximum(ty0, ty1)),
                            torch.maximum(tz0, tz1))
        tb, ib = t_best[act], idx[act]
        hit = torch.clamp(near, min=T_MIN) < torch.minimum(far, tb)
        count, first = r[:, 7].long(), r[:, 6].long()
        leaf = hit & (count > 0)
        for k in range(int(count[leaf].max()) if bool(leaf.any()) else 0):
            sel = leaf & (k < count)
            row = torch.where(sel, first + k, 0)
            tt, ok = mt_tri_ref(tris[row], ax, ay, az, dx[act], dy[act],
                                dz[act], tb)
            tb = torch.where(sel & ok, tt, tb)
            ib = torch.where(sel & ok, row.to(torch.int32), ib)
        t_best[act], idx[act] = tb, ib
        node[act] = torch.where(hit & (count == 0), nc + 1, r[:, 8].long())


@pytest.fixture(scope="module")
def statue_tables():
    """modelExample's statue (65,536 triangles, 4,096 full leaves of 16)
    as `pack_bvh` lays it out for the kernel."""
    scene, _ = registry.model_example()
    nodes, tris = ttrav.pack_bvh(scene)
    return nodes, tris, scene.tri_bvh.n_nodes


def _tables_for(v, leaf_size):
    """A BVH over triangle vertices v (T, 3, 3) with leaves of at most
    `leaf_size` (partial ones too): the aligned tables and the node
    count."""
    fb = tbvh.build(v, leaf_size=leaf_size)
    vp = v[fb.order[:v.shape[0]]].astype(np.float32)
    rows = np.concatenate([fb.node_min, fb.node_max, np.stack(
        [fb.first, fb.count, fb.skip], axis=1)], axis=1).astype(np.float32)
    tris = np.concatenate([vp[:, 0], vp[:, 1] - vp[:, 0],
                           vp[:, 2] - vp[:, 0]], axis=1)
    nodes, tris = ttrav.pack_tables(rows, tris)
    return nodes, tris, fb.n_nodes


@pytest.mark.parametrize("mesh", ["statue", "random"])
def test_ref_on_aligned_tables_equals_the_row_walk(mesh, statue_tables):
    """bvh_closest_ref on the aligned tables against the walk over the
    36-byte rows it replaced: t and idx bit for bit on 1,500 rays (30%
    capped, 10% dead), on the statue and on 2,000 random triangles with
    leaves of at most 16 (partial ones too)."""
    if mesh == "statue":
        nodes, tris, n_nodes = statue_tables
        rs = np.random.default_rng(61)
        o = rs.uniform(-6, 8, (1500, 3)).astype(np.float32)
        d = (-o * rs.uniform(0, 1, (1500, 1))
             + rs.normal(size=(1500, 3))).astype(np.float32)
    else:
        nodes, tris, n_nodes = _tables_for(random_mesh(2000, seed=62), 16)
        o, d, _, _ = _rays(1500, 63)
    rs = np.random.default_rng(64)
    cap = np.where(rs.uniform(size=1500) < 0.3, 6.0, np.inf)
    cap = np.where(rs.uniform(size=1500) < 0.9, cap, 0.0).astype(np.float32)
    to = torch.from_numpy
    rows, rtris = _plain_rows(nodes, tris)
    wt, wi = _row_walk(rows, rtris, to(o), to(d), to(cap), n_nodes)
    pt, pi = ttrav.bvh_closest_ref(to(nodes), to(tris), to(o), to(d),
                                   to(cap), n_nodes=n_nodes)
    assert torch.equal(pi, wi) and torch.equal(pt, wt)
    assert (pi >= 0).sum() > 150


def test_bvh_closest_ref_matches_pallas_kernel(scene_pair):
    """2,176 rays, 30% capped and 10% dead (cap 0): idx equal on every
    lane, t within rtol 1e-6, against the tile walk in interpret mode; the
    walk's work is counted."""
    js, ts, ms = scene_pair
    bvh = js.tri_bvh
    o, d, cap, alive = _rays(2176, 34)
    cap0 = np.where(alive, cap, 0.0).astype(np.float32)
    jn, jtr = ptrav.pack_bvh(js)
    jt, ji = ptrav.bvh_closest(jn, jtr, jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(cap0), n_nodes=bvh.n_nodes,
                               leaf_size=bvh.leaf_size, interpret=True)
    jt, ji = np.asarray(jt), np.asarray(ji)
    visits = {}
    pt, pi = ttrav.bvh_closest_ref(
        ms.tri_bvh.bvh_nodes, ms.tri_bvh.bvh_tris, torch.from_numpy(o),
        torch.from_numpy(d), torch.from_numpy(cap0),
        n_nodes=bvh.n_nodes, visits=visits)
    pt, pi = pt.numpy(), pi.numpy()
    assert np.array_equal(pi, ji), \
        f"lanes (lane, t port, t jax, idx port, idx jax): " \
        f"{_differing_lanes(pi, pt, ji, jt)}"
    np.testing.assert_allclose(pt, jt, rtol=1e-6)
    assert (pi >= 0).sum() > 300
    # dead lanes keep their zero cap; capped misses keep the cap
    assert (pi[~alive] == -1).all() and (pt[~alive] == 0).all()
    miss = pi < 0
    np.testing.assert_array_equal(pt[miss], cap0[miss])
    assert visits["node_visits"] > 2176 and visits["tri_tests"] > 0


def warp_walk_model(nodes, tris, o, d, t_cap, n_nodes, leaf_batch,
                    warp_rays=32):
    """Plain model of csrc/traverse.cu's warp schedule, warp by warp
    (`warp_rays` rays on the first lanes, the others only helping): the
    walk phase steps every lane that holds no leaf until none is walking
    (or `leaf_batch` lanes hold one); the leaf phase lays the held leaves
    out as rows of S lanes (S the least power of two >= the largest count,
    at most 32; chunks rows per leaf), 32 / S rows a step, each lane
    testing one triangle against its row's ray and t_best, and each row's
    lex-least (t, row) replacing the ray's best. Reads the aligned tables
    as the kernel does."""
    n = o.shape[0]
    n_pad = -(-n // warp_rays) * warp_rays
    t_out = torch.empty(n)
    i_out = torch.empty(n, dtype=torch.int32)
    tri9 = tris.view(-1, 3, 4)[:, :, :3].reshape(-1, 9)
    big = 2 ** 31 - 1
    lanes = torch.arange(32)
    for w0 in range(0, n_pad, warp_rays):
        live = ((w0 + lanes) < n) & (lanes < warp_rays)
        sel = torch.clamp(w0 + lanes, max=n - 1)
        ro, rd = o[sel].clone(), d[sel].clone()
        rd[~live] = 1.0
        t_best = torch.where(live, t_cap[sel], 0.0)
        inv = safe_inv(rd)
        idx = torch.full((32,), -1, dtype=torch.int32)
        node = torch.where(live, 0, n_nodes)
        pending = torch.zeros(32, dtype=torch.bool)
        first = torch.zeros(32, dtype=torch.int64)
        count = torch.zeros(32, dtype=torch.int64)
        while True:
            while True:
                walking = ~pending & (node < n_nodes)
                if not walking.any() or int(pending.sum()) >= leaf_batch:
                    break
                a = torch.nonzero(walking)[:, 0]
                r = nodes[node[a]]
                t0 = (r[:, 0:3] - ro[a]) * inv[a]
                t1 = (r[:, 4:7] - ro[a]) * inv[a]
                lo_, hi_ = torch.minimum(t0, t1), torch.maximum(t0, t1)
                near = torch.maximum(torch.maximum(lo_[:, 0], lo_[:, 1]),
                                     lo_[:, 2])
                far = torch.minimum(torch.minimum(hi_[:, 0], hi_[:, 1]),
                                    hi_[:, 2])
                hit = torch.clamp(near, min=T_MIN) < torch.minimum(far,
                                                                   t_best[a])
                leaf = r[:, 7] < 0
                take = hit & leaf
                pending[a[take]] = True
                first[a[take]] = r[take, 3].long()
                count[a[take]] = (-r[take, 7]).long()
                node[a] = torch.where(hit | leaf, node[a] + 1,
                                      r[:, 7].long())
            held = torch.nonzero(pending)[:, 0]
            if held.numel() == 0:
                break
            cmax = int(count[held].max())
            lg = 0
            while (1 << lg) < cmax and lg < 5:
                lg += 1
            per_step, chunks = 32 >> lg, -(-cmax // (1 << lg))
            rows = held.numel() * chunks
            for r0 in range(0, rows, per_step):
                row = r0 + (lanes >> lg)
                valid = row < rows
                q = torch.where(valid, row // chunks, 0)
                src = held[q]
                k = (row - q * chunks) * (1 << lg) + (lanes & ((1 << lg) - 1))
                ok_k = valid & (k < count[src])
                tri_row = torch.where(ok_k, first[src] + k, 0)
                tt, ok = mt_tri_ref(tri9[tri_row], ro[src, 0], ro[src, 1],
                                    ro[src, 2], rd[src, 0], rd[src, 1],
                                    rd[src, 2], t_best[src])
                ok = ok & ok_k
                bt = torch.where(ok, tt, float("inf")).view(per_step, -1)
                br = torch.where(ok, tri_row, big).view(per_step, -1)
                best_t = bt.amin(dim=1)
                best_r = torch.where(bt == best_t[:, None], br, big) \
                    .amin(dim=1)
                for j in range(per_step):
                    if r0 + j < rows and int(best_r[j]) != big:
                        lane = int(held[(r0 + j) // chunks])
                        t_best[lane], idx[lane] = best_t[j], int(best_r[j])
            pending[:] = False
        t_out[sel[live]] = t_best[live]
        i_out[sel[live]] = idx[live]
    return t_out, i_out


@pytest.mark.parametrize("leaf_size,leaf_batch,warp_rays", [
    (4, 1, 32), (4, 32, 32), (40, 1, 32), (40, 32, 32), (16, 4, 16),
    (16, 2, 8)])
def test_warp_schedule_model_equals_the_plain_walk(leaf_size, leaf_batch,
                                                   warp_rays):
    """The CUDA kernel's warp schedule (while-while walk, held leaves
    tested one triangle per lane, rows reduced to the lex-least (t, row))
    as a plain model gives `bvh_closest_ref`'s t bit for bit and its idx
    on every lane: 1,000 triangles with leaves of at most 4 (several rays'
    leaves a step), 16 and 40 (a leaf over two rows of 32 lanes), 999 rays
    (a partial last warp; 30% capped, 10% dead), 32, 16 or 8 rays a warp,
    the walk phase ended when every lane holds a leaf or at the first held
    ones; and two coincident triangles in one leaf keep the first in walk
    order."""
    nodes, tris, n_nodes = _tables_for(random_mesh(1000, seed=65), leaf_size)
    nodes, tris = torch.from_numpy(nodes), torch.from_numpy(tris)
    o, d, cap, alive = _rays(999, 66)
    d = d - o / 15.0
    cap0 = torch.from_numpy(np.where(alive, cap, 0.0).astype(np.float32))
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    pt, pi = ttrav.bvh_closest_ref(nodes, tris, o, d, cap0, n_nodes=n_nodes)
    mt, mi = warp_walk_model(nodes, tris, o, d, cap0, n_nodes, leaf_batch,
                             warp_rays)
    assert torch.equal(mi, pi) and torch.equal(mt, pt)
    assert (pi >= 0).sum() > 100
    # the tie: a duplicate of a hit triangle right after it in its leaf
    row = int(pi[pi >= 0][0])
    dup = tris.clone()
    hit_rays = pi == row
    dup[row + 1] = dup[row]
    mt2, mi2 = warp_walk_model(nodes, dup, o, d, cap0, n_nodes, leaf_batch,
                               warp_rays)
    pt2, pi2 = ttrav.bvh_closest_ref(nodes, dup, o, d, cap0, n_nodes=n_nodes)
    assert torch.equal(mi2, pi2) and torch.equal(mt2, pt2)
    assert (pi2[hit_rays] == row).all()


def test_walk_route_without_bvh8_matches_jax(scene_pair, monkeypatch):
    """mesh_closest(mesh="walk", traverse8=False) against the JAX
    pallas_bvh_closest with GRT_MESH=walk GRT_TRAVERSE8=0 (coherence sort,
    tile walk, unsort): idx equal, t within rtol 1e-6; and exactly the
    port's BVH8 walk's winners."""
    js, ts, ms = scene_pair
    monkeypatch.setenv("GRT_MESH", "walk")
    monkeypatch.setenv("GRT_TRAVERSE8", "0")
    o, d, cap, alive = _rays(2176, 44)
    jt, ji = jtrace.pallas_bvh_closest(js, jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(cap), jnp.asarray(alive))
    jt, ji = np.asarray(jt), np.asarray(ji)
    tt = torch.from_numpy
    counters = {}
    pt, pi = ttrace.mesh_closest(ms, tt(o), tt(d), tt(cap), tt(alive),
                                 mesh="walk", traverse8=False,
                                 counters=counters)
    assert np.array_equal(pi.numpy(), ji), \
        _differing_lanes(pi.numpy(), pt.numpy(), ji, jt)
    np.testing.assert_allclose(pt.numpy(), jt, rtol=1e-6)
    assert counters == {"mesh_calls": 1}
    wt, wi = ttrace.mesh_closest(ms, tt(o), tt(d), tt(cap), tt(alive),
                                 mesh="walk")
    assert torch.equal(wi, pi) and torch.equal(wt, pt)
    assert ttrav.launches == 0 and ttrav8.launches == 0


def test_tie_goes_to_the_first_triangle_in_walk_order():
    """Two coincident triangles in one leaf: the strict t < t_best keeps
    the first one found; a cap below the hit leaves idx -1 and t the cap;
    a zero cap ends the walk at the root."""
    v0 = np.array([0.0, 0.0, 5.0], np.float32)
    e0, e1 = np.array([4.0, 0, 0], np.float32), np.array([0, 4.0, 0], np.float32)
    row = np.concatenate([v0, e0, e1])
    nodes, tris = (torch.from_numpy(x) for x in ttrav.pack_tables(
        np.array([[-1, -1, 4, 5, 5, 6, 0, 2, 1]], np.float32),
        np.stack([row, row, np.zeros(9, np.float32),
                  np.zeros(9, np.float32)])))
    o = torch.tensor([[1.0, 1.0, 0.0]] * 3)
    d = torch.tensor([[0.0, 0.0, 1.0]] * 3)
    cap = torch.tensor([float("inf"), 4.0, 0.0])
    t, i = ttrav.bvh_closest(nodes, tris, o, d, cap, n_nodes=1)
    assert i.tolist() == [0, -1, -1] and t.tolist() == [5.0, 4.0, 0.0]
    with pytest.raises(ValueError, match="nodes"):
        ttrav.bvh_closest(nodes[:, :7], tris, o, d, cap, n_nodes=1)
