"""The binned mesh intersector of the port against the JAX package: the
plain version of the row-stream kernel against the Pallas kernel in
interpret mode on the same sorted planes and ranges, `binned_closest`
against the JAX `binned_closest`, and both against oracles that share
nothing with them (the skip-link walk and the dense all-pairs test)."""

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_raytracer_tpu.ops import trace as jtrace
from go_raytracer_tpu.ops.pallas import stream as pstream
from go_raytracer_tpu_torch.ops import intersect as tix
from go_raytracer_tpu_torch.ops import stream as tstream
from go_raytracer_tpu_torch.ops import trace as ttrace
from go_raytracer_tpu_torch.scene import types as TT
from tests.test_bvh import _scenes_with_and_without_bvh

torch.set_num_threads(2)
INF = float("inf")


def mesh_pair(n_tris, seed, monkeypatch):
    """A random triangle soup behind a BVH with 64-triangle clusters: the
    JAX scene, and the same tables carried to the port on the CPU."""
    monkeypatch.setenv("GRT_CLUSTER_TRIS", "64")
    js, _ = _scenes_with_and_without_bvh(n_tris, seed=seed)
    return js, ttrace.to_device(TT.scene_from_numpy(js), "cpu")


def rays(n, seed, caps=True):
    rs = np.random.default_rng(seed)
    o = rs.uniform(-15, 15, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    cap = np.where(rs.uniform(size=n) < 0.3, 5.0, np.inf).astype(np.float32)
    alive = rs.uniform(size=n) < 0.9
    if not caps:
        cap[:], alive[:] = np.inf, True
    return o, d, cap, alive


def test_stream_rows_ref_matches_pallas_kernel(monkeypatch):
    """Same sorted planes, same group ranges: idx exact, t within rtol
    1e-6 (XLA may contract a multiply-add the plain version does not).
    The Pallas kernel's blocks are 1024 rays, the port's 128, so each
    Pallas range is given to the port's eight blocks inside it. Blocks
    with an empty range, capped rays and dead rays (t = 0) included."""
    js, ms = mesh_pair(3000, 33, monkeypatch)
    bvh = ms.tri_bvh
    n = 4096
    o, d, cap, alive = rays(n, 34)
    rs = np.random.default_rng(35)
    k_cl = bvh.cl_lo.shape[0]
    key = np.sort(rs.integers(0, k_cl, n))
    key[3072:] = k_cl                      # the last Pallas block is empty
    gs = bvh.cl_gs.numpy()
    kb = key.reshape(-1, 1024)
    last = np.where(kb < k_cl, kb, -1).max(axis=1)
    empty = last < 0
    glo = np.where(empty, 0, gs[np.clip(kb[:, 0], 0, k_cl - 1)]).astype(np.int32)
    ghi = np.where(empty, 0, gs[np.clip(last, 0, k_cl - 1) + 1]).astype(np.int32)
    assert empty.any() and (ghi > glo).any()
    t0 = np.where(alive, cap, 0.0).astype(np.float32)
    idx0 = np.full(n, -1, np.int32)
    plane = lambda x: jnp.asarray(x).reshape(-1, 128)
    jt, ji = pstream.stream_rows(
        js.tri_bvh.cl_lines, jnp.asarray(glo), jnp.asarray(ghi),
        *(plane(o[:, k]) for k in range(3)),
        *(plane(d[:, k]) for k in range(3)), plane(t0), plane(idx0),
        interpret=True)
    tt = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    pt, pi = tstream.stream_rows(
        bvh.cl_lines, tt(np.repeat(glo, 8)), tt(np.repeat(ghi, 8)),
        *(tt(o[:, k]) for k in range(3)), *(tt(d[:, k]) for k in range(3)),
        tt(t0), tt(idx0))
    ji, jt = np.asarray(ji).reshape(-1), np.asarray(jt).reshape(-1)
    np.testing.assert_array_equal(pi.numpy(), ji)
    np.testing.assert_allclose(pt.numpy(), jt, rtol=1e-6)
    assert (ji >= 0).sum() > 100
    # an untouched block keeps its t and idx
    np.testing.assert_array_equal(pt.numpy()[3072:], t0[3072:])
    assert tstream.launches == 0           # CPU tensors never launch


def test_stream_rows_ref_chunking_is_invisible(monkeypatch):
    """The plain version's groups-per-step does not change a result."""
    _, ms = mesh_pair(600, 91, monkeypatch)
    bvh = ms.tri_bvh
    n = 512
    o, d, cap, _ = rays(n, 92)
    n_groups = int(bvh.cl_gs[-1])
    glo = torch.tensor([0, 5, 7, 7], dtype=torch.int32)
    ghi = torch.tensor([n_groups, 40, 7, 9], dtype=torch.int32)
    tt = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    args = (bvh.cl_lines, glo, ghi, *(tt(o[:, k]) for k in range(3)),
            *(tt(d[:, k]) for k in range(3)), tt(cap),
            torch.full((n,), -1, dtype=torch.int32))
    want = tstream.stream_rows_ref(*args)
    for chunk in (1, 3):
        monkeypatch.setattr(tstream, "_REF_CHUNK", chunk)
        got = tstream.stream_rows_ref(*args)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("seed,n_tris,n_rays,caps", [
    (33, 3000, 2176, True), (51, 500, 777, True), (77, 500, 9216, False)])
def test_binned_closest_matches_jax(seed, n_tris, n_rays, caps, monkeypatch):
    """Winners exact and t within rtol 1e-5 of the JAX `binned_closest`,
    with caps and dead lanes, a pool that is no block multiple (777) and
    one whose eighth is no tile multiple of the JAX kernel (9216); and
    exact against the port's own BVH8 walk."""
    js, ms = mesh_pair(n_tris, seed, monkeypatch)
    o, d, cap, alive = rays(n_rays, seed + 1, caps=caps)
    jt, ji = jtrace.binned_closest(
        js, jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(cap) if caps else None,
        jnp.asarray(alive) if caps else None)
    tt = torch.from_numpy
    counters = {}
    pt, pi = ttrace.binned_closest(
        ms, tt(o), tt(d), tt(cap) if caps else None,
        tt(alive) if caps else None, counters=counters)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=1e-5)
    assert counters["mesh_calls"] == 1
    assert 1 <= counters["rounds"] < counters["host_reads"] <= 512
    wt, wi = ttrace.mesh_closest(ms, tt(o), tt(d), tt(cap), tt(alive),
                                 mesh="walk")
    assert torch.equal(wi, pi) and torch.equal(wt, pt)


def test_binned_closest_matches_independent_oracles(monkeypatch):
    """Against the plain skip-link walk (same winners, t exact where the
    arithmetic is the walk's own: rtol 1e-5) and the dense all-pairs test
    of a scene without any BVH (same hit set, t within rtol 2e-4: the
    repo's bound between its local and its dense Moller-Trumbore forms)."""
    monkeypatch.setenv("GRT_CLUSTER_TRIS", "64")
    js, jd = _scenes_with_and_without_bvh(400, seed=21)
    ms = ttrace.to_device(TT.scene_from_numpy(js), "cpu")
    md = ttrace.to_device(TT.scene_from_numpy(jd), "cpu")
    o, d, _, _ = rays(777, 22, caps=False)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    pt, pi = ttrace.mesh_closest(ms, o, d)            # default: binned
    wt, wi = ttrace.bvh_tri_closest(ms, o, d, ttrace.T_MIN, INF)
    hit = torch.isfinite(wt)
    assert torch.equal(pi >= 0, hit) and hit.sum() > 30
    assert torch.equal(pi[hit], wi[hit])
    np.testing.assert_allclose(pt[hit].numpy(), wt[hit].numpy(), rtol=1e-5)
    dense = tix.tri_ts(md.triangles, o, d, 1e-3, INF).amin(dim=1)
    assert torch.equal(torch.isfinite(dense), hit)
    np.testing.assert_allclose(pt[hit].numpy(), dense[hit].numpy(), rtol=2e-4)
    # misses keep the cap (inf here) and idx -1
    assert torch.isinf(pt[~hit]).all() and (pi[~hit] == -1).all()


def test_range_bits_guards_the_shift_by_32():
    lo = torch.tensor([0, 0, 5, 32, 31, 0], dtype=torch.int32)
    hi = torch.tensor([32, 0, 9, 32, 32, 31], dtype=torch.int32)
    got = tstream.range_bits(lo, hi).tolist()
    want = [-1, 0, 0b111100000, 0, -(1 << 31), (1 << 31) - 1]
    assert got == want
