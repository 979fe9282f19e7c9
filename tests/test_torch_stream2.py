"""The persistent-block binned intersector of the port (K11, ops/stream2.py)
against the JAX package: the finer `cl2_*` partition, the plain version
against the Pallas kernel `stream2_rows` in interpret mode on the same
coherence-sorted planes, and `binned2_closest` against the JAX route and
the port's BVH8 walk. The JAX kernel's blocks are 1024 rays, the port's
units `UNIT` = 32: the winners agree, the rounds differ."""

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_raytracer_tpu.ops import trace as jtrace
from go_raytracer_tpu.ops.pallas import stream2 as pstream2
from go_raytracer_tpu.scene import builder as jbuilder
from go_raytracer_tpu_torch.ops import stream2 as tstream2
from go_raytracer_tpu_torch.ops import trace as ttrace
from go_raytracer_tpu_torch.scene import builder as tbuilder
from go_raytracer_tpu_torch.scene import clusters as tcl
from go_raytracer_tpu_torch.scene import types as TT
from tests.test_bvh import random_mesh
from tests.test_torch_mesh_scene import assert_scenes_equal

torch.set_num_threads(2)


def _build(mod, n_tris, seed, **kw):
    b = mod.SceneBuilder()
    m = b.lambertian((1, 1, 1))
    b.add_mesh(random_mesh(n_tris, seed=seed),
               np.full(n_tris, m, dtype=np.int32))
    return b.build(bvh_threshold=1, bvh_leaf_size=4, **kw)


@pytest.fixture(scope="module")
def scene_pair():
    """3000 random triangles, 64-triangle clusters and 32-triangle cl2
    clusters, built by the JAX package (its env knobs) and by the port
    (its builder arguments)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("GRT_CLUSTER_TRIS", "64")
    mp.setenv("GRT_CLUSTER2_TRIS", "32")
    try:
        js = _build(jbuilder, 3000, 33)
    finally:
        mp.undo()
    ts = _build(tbuilder, 3000, 33, cluster_tris=64, cluster2_tris=32)
    return js, ts, ttrace.to_device(ts, "cpu")


def _rays(n, seed):
    rs = np.random.default_rng(seed)
    o = rs.uniform(-15, 15, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    cap = np.where(rs.uniform(size=n) < 0.3, 5.0, np.inf).astype(np.float32)
    alive = rs.uniform(size=n) < 0.9
    return o, d, cap, alive


def test_builder_makes_the_jax_cl2_partition(scene_pair, monkeypatch):
    """The port's own build equals the JAX build table for table, cl2_*
    included; the budget rule drops the cl2 tables, and binned2 then
    refuses to run rather than take another route."""
    js, ts, ms = scene_pair
    assert_scenes_equal(js, ts)
    k2 = ts.tri_bvh.cl2_gs.shape[0] - 1
    assert k2 == 128 and ms.tri_bvh.cl2_lo.shape == (k2, 3)
    monkeypatch.setattr(tbuilder, "CLUSTER2_TABLE_BYTES", 64 * 2999)
    small = _build(tbuilder, 3000, 33, cluster_tris=64, cluster2_tris=32)
    assert small.tri_bvh.cl2_lines is None and small.tri_bvh.cl2_gs is None
    with pytest.raises(ValueError, match="cl2"):
        ttrace.mesh_closest(ttrace.to_device(small, "cpu"),
                            torch.zeros((4, 3)), torch.ones((4, 3)),
                            mesh="binned2")


def test_boxes_lo_hi_drops_the_padding():
    """The packed box table (octets padded with inverted boxes) back to
    (K2, 3) lo and hi, for a K2 that is no multiple of 8."""
    rs = np.random.default_rng(1)
    lo = rs.normal(size=(13, 3)).astype(np.float32)
    hi = lo + 1
    blo, bhi = tstream2.boxes_lo_hi(
        torch.from_numpy(tcl.pack_cluster_boxes(lo, hi)), 13)
    assert np.array_equal(blo.numpy(), lo) and np.array_equal(bhi.numpy(), hi)


def test_stream2_rows_ref_matches_pallas_kernel(scene_pair):
    """3,072 coherence-sorted rays (30% capped, 10% dead and at the end):
    idx equal on every lane, t within rtol 1e-5 (the interpreted Pallas
    kernel is compiled by XLA, which may contract a multiply-add that the
    port keeps apart: one lane here is 1.4e-6 off); the work is counted
    and every block stops by itself."""
    js, ts, ms = scene_pair
    bvh = ms.tri_bvh
    n = 3072
    o, d, cap, alive = _rays(n, 34)
    t0 = np.where(alive, cap, 0.0).astype(np.float32)
    key = ttrace.coherence_key(bvh, torch.from_numpy(o), torch.from_numpy(d))
    key = torch.where(torch.from_numpy(t0) > 0, key, 0x7FFFFFFF)
    perm = torch.sort(key).indices.numpy()
    o, d, t0 = o[perm], d[perm], t0[perm]
    idx0 = np.full(n, -1, np.int32)
    k2 = bvh.cl2_gs.shape[0] - 1
    plane = lambda x: jnp.asarray(x).reshape(-1, 128)
    jt, ji = pstream2.stream2_rows(
        js.tri_bvh.cl2_lines, js.tri_bvh.cl2_boxes, js.tri_bvh.cl2_gs,
        *(plane(o[:, k]) for k in range(3)),
        *(plane(d[:, k]) for k in range(3)), plane(t0), plane(idx0), k2=k2,
        interpret=True)
    tt = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    work = {}
    pt, pi = tstream2.stream2_rows_ref(
        bvh.cl2_lines, bvh.cl2_lo, bvh.cl2_hi, bvh.cl2_gs,
        *(tt(o[:, k]) for k in range(3)), *(tt(d[:, k]) for k in range(3)),
        tt(t0), tt(idx0), work=work)
    ji, jt = np.asarray(ji).reshape(-1), np.asarray(jt).reshape(-1)
    np.testing.assert_array_equal(pi.numpy(), ji)
    np.testing.assert_allclose(pt.numpy(), jt, rtol=1e-5)
    assert (ji >= 0).sum() > 300
    rounds = work["rounds"]
    assert rounds.shape == (n // tstream2.UNIT,) \
        and 1 <= int(rounds.max()) < 4096
    assert int(rounds[-1]) == 0                 # the dead lanes' unit
    assert work["box_tests"] >= 128 * k2 and work["group_tests"] > 0
    # the wrapper on CPU tensors returns the same and fills `rounds`
    r = torch.zeros(n // tstream2.UNIT, dtype=torch.int64)
    wt, wi = tstream2.stream2_rows(
        bvh.cl2_lines, bvh.cl2_lo, bvh.cl2_hi, bvh.cl2_gs,
        *(tt(o[:, k]) for k in range(3)), *(tt(d[:, k]) for k in range(3)),
        tt(t0), tt(idx0), rounds=r)
    assert torch.equal(wi, pi) and torch.equal(wt, pt)
    assert torch.equal(r, rounds) and tstream2.launches == 0


def test_stream2_rows_ref_unit_changes_rounds_not_winners(scene_pair):
    """The plain version in units of `UNIT` = 32 rays and on the earlier
    kernel's schedule (blocks of 128, a window of 32 clusters) on the same
    3,072 sorted rays: idx and t equal on every lane; rounds and work are
    counted per unit of each size."""
    js, ts, ms = scene_pair
    bvh = ms.tri_bvh
    n = 3072
    o, d, cap, alive = _rays(n, 37)
    t0 = torch.from_numpy(np.where(alive, cap, 0.0).astype(np.float32))
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    key = torch.where(t0 > 0, ttrace.coherence_key(bvh, o, d), 0x7FFFFFFF)
    perm = torch.sort(key).indices
    args = (bvh.cl2_lines, bvh.cl2_lo, bvh.cl2_hi, bvh.cl2_gs,
            *(x[perm, k].contiguous() for x in (o, d) for k in range(3)),
            t0[perm].contiguous(), torch.full((n,), -1, dtype=torch.int32))
    w32, w128 = {}, {}
    t32, i32 = tstream2.stream2_rows_ref(*args, work=w32)
    t128, i128 = tstream2.stream2_rows_ref(*args, unit=128, range_w=32,
                                           work=w128)
    assert torch.equal(i32, i128) and torch.equal(t32, t128)
    assert (i32 >= 0).sum() > 300
    r32, r128 = w32["rounds"], w128["rounds"]
    assert r32.shape == (n // 32,) and r128.shape == (n // 128,)
    assert int(r32.max()) >= 1 and int(r128.max()) >= 1
    assert int(r32[-1]) == int(r128[-1]) == 0   # the dead lanes' unit
    assert min(w32["group_tests"], w128["group_tests"]) > 0


def test_binned2_route_matches_jax_and_the_walk(scene_pair):
    """binned2_closest on 2,176 rays (capped, dead, a pool that is no
    multiple of 1024): idx equal to the JAX route's on every lane, t within
    rtol 1e-5 (the JAX package's bound for its routes); and bit-equal to
    the port's BVH8 walk."""
    js, ts, ms = scene_pair
    o, d, cap, alive = _rays(2176, 36)
    jt, ji = jtrace.binned2_closest(js, jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(cap), jnp.asarray(alive))
    tt = torch.from_numpy
    counters = {}
    pt, pi = ttrace.mesh_closest(ms, tt(o), tt(d), tt(cap), tt(alive),
                                 mesh="binned2", counters=counters)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=1e-5)
    assert counters == {"mesh_calls": 1}
    wt, wi = ttrace.mesh_closest(ms, tt(o), tt(d), tt(cap), tt(alive),
                                 mesh="walk")
    assert torch.equal(wi, pi) and torch.equal(wt, pt)


def test_binned2_with_a_partial_last_octet():
    """A cl2 partition of 52 clusters (no multiple of 8) and rays that
    start outside every cluster box: the port scans only real clusters
    and finds the walk's winners. (The JAX kernel also scans the octet's
    padding boxes, lo = +inf and hi = -inf, which its slab test reads as
    boxes holding everything; ROADMAP.md records the difference.)"""
    ts = _build(tbuilder, 1300, 33, cluster_tris=64, cluster2_tris=40)
    ms = ttrace.to_device(ts, "cpu")
    assert ms.tri_bvh.cl2_lo.shape[0] == 52
    rs = np.random.default_rng(35)
    o = rs.normal(size=(1024, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 60
    d = -o + rs.normal(size=o.shape) * 5
    o, d = (torch.from_numpy(x.astype(np.float32)) for x in (o, d))
    bt, bi = ttrace.mesh_closest(ms, o, d, mesh="binned2")
    wt, wi = ttrace.mesh_closest(ms, o, d, mesh="walk")
    assert (wi >= 0).sum() > 300
    assert torch.equal(bi, wi) and torch.equal(bt, wt)
