"""The binary-BVH skip-link walk of the port (K12, ops/traverse.py) against
the JAX package: `pack_bvh`'s rows, the plain version against the Pallas
kernel `bvh_closest` in interpret mode, and the walk route with the BVH8
walk turned off against the JAX `pallas_bvh_closest` under
GRT_MESH=walk GRT_TRAVERSE8=0.

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
from go_raytracer_tpu_torch.scene import types as TT
from tests.test_bvh import _scenes_with_and_without_bvh

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


def test_pack_bvh_rows_equal_jax(scene_pair):
    """Node rows [min, max, first, count, skip] and triangle rows [v0, e0,
    e1] + leaf_size zero rows: the JAX package's packed lines, unpacked."""
    js, ts, ms = scene_pair
    jn, jt = ptrav.pack_bvh(js)
    tn, tt_ = ttrav.pack_bvh(ts)
    m, r = tn.shape[0], tt_.shape[0]
    assert tn.shape == (js.tri_bvh.n_nodes, 9) and tn.dtype == np.float32
    assert r == js.triangles.count + js.tri_bvh.leaf_size
    np.testing.assert_array_equal(tn, _unpack(jn, m, 9))
    np.testing.assert_array_equal(tt_, _unpack(jt, r, 9))
    assert not tt_[-js.tri_bvh.leaf_size:].any()
    assert torch.equal(ms.tri_bvh.bvh_nodes, torch.from_numpy(tn))


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
    nodes = torch.tensor([[-1, -1, 4, 5, 5, 6, 0, 2, 1]], dtype=torch.float32)
    row = np.concatenate([v0, e0, e1])
    tris = torch.from_numpy(np.stack([row, row, np.zeros(9, np.float32),
                                      np.zeros(9, np.float32)]))
    o = torch.tensor([[1.0, 1.0, 0.0]] * 3)
    d = torch.tensor([[0.0, 0.0, 1.0]] * 3)
    cap = torch.tensor([float("inf"), 4.0, 0.0])
    t, i = ttrav.bvh_closest(nodes, tris, o, d, cap, n_nodes=1)
    assert i.tolist() == [0, -1, -1] and t.tolist() == [5.0, 4.0, 0.0]
    with pytest.raises(ValueError, match="nodes"):
        ttrav.bvh_closest(nodes[:, :8], tris, o, d, cap, n_nodes=1)
