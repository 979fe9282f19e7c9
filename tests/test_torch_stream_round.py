"""The fused round of the binned intersector (K10, ops/stream.py
`stream_round_rows`) against the JAX package: the plain version against
the Pallas kernel in interpret mode on the same sorted planes, ranges and
processed bits (t, idx, next key and bits), and `binned_closest(...,
b1_fused=True)` against the JAX route under GRT_B1_FUSED=1 and against
the port's unfused route (same rounds, bit-equal results); and a plain
model of the CUDA round (K4's work items and merge, then the finish pass:
decode, mark, scan) against the plain version on very uneven ranges."""

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_raytracer_tpu.ops import trace as jtrace
from go_raytracer_tpu.ops.pallas import stream as pstream
from go_raytracer_tpu_torch.ops import stream as tstream
from go_raytracer_tpu_torch.ops import trace as ttrace
from go_raytracer_tpu_torch.scene import types as TT
from tests.test_bvh import _scenes_with_and_without_bvh
from tests.test_torch_stream import split_merge_model

torch.set_num_threads(2)


def mesh_pair(n_tris, seed, monkeypatch):
    """A random triangle soup behind a BVH with 64-triangle clusters (the
    JAX tests' size): the JAX scene, and the same tables on the port."""
    monkeypatch.setenv("GRT_CLUSTER_TRIS", "64")
    js, _ = _scenes_with_and_without_bvh(n_tris, seed=seed)
    return js, ttrace.to_device(TT.scene_from_numpy(js), "cpu")


def rays(n, seed):
    rs = np.random.default_rng(seed)
    o = rs.uniform(-15, 15, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    cap = np.where(rs.uniform(size=n) < 0.3, 5.0, np.inf).astype(np.float32)
    alive = rs.uniform(size=n) < 0.9
    return o, d, cap, alive


def test_stream_round_rows_ref_matches_pallas_kernel(monkeypatch):
    """4,096 sorted rays (30% capped, 10% dead), random processed bits, the
    last Pallas block empty: t within rtol 1e-6, idx equal, and the next
    key and the bit planes equal bit for bit. Each 1024-ray Pallas block's
    range and interval go to the port's eight 128-ray blocks inside it."""
    js, ms = mesh_pair(3000, 33, monkeypatch)
    bvh = ms.tri_bvh
    k_cl = bvh.cl_lo.shape[0]
    n_mask = (k_cl + 31) // 32
    n = 4096
    o, d, cap, alive = rays(n, 34)
    rs = np.random.default_rng(35)
    key = np.sort(rs.integers(0, k_cl, n))
    key[3072:] = k_cl
    gs = bvh.cl_gs.numpy()
    kb = key.reshape(-1, 1024)
    first, last = kb[:, 0], np.where(kb < k_cl, kb, -1).max(axis=1)
    empty = last < 0
    glo = np.where(empty, 0, gs[np.clip(first, 0, k_cl - 1)]).astype(np.int32)
    ghi = np.where(empty, 0, gs[np.clip(last, 0, k_cl - 1) + 1]) \
        .astype(np.int32)
    ca = np.where(empty, 0, first).astype(np.int32)
    cb = last.astype(np.int32)
    masks = rs.integers(-(1 << 31), 1 << 31, (n_mask, n), dtype=np.int64) \
        .astype(np.int32) & (rs.uniform(size=(n_mask, n)) < 0.5)
    masks = masks.astype(np.int32)
    t0 = np.where(alive, cap, 0.0).astype(np.float32)
    idx0 = np.full(n, -1, np.int32)
    plane = lambda x: jnp.asarray(x).reshape(-1, 128)
    jt, ji, jk, jm = pstream.stream_round_rows(
        js.tri_bvh.cl_lines, js.tri_bvh.cl_boxes, jnp.asarray(glo),
        jnp.asarray(ghi), jnp.asarray(ca), jnp.asarray(cb),
        *(plane(o[:, k]) for k in range(3)),
        *(plane(d[:, k]) for k in range(3)), plane(t0), plane(idx0),
        tuple(plane(m) for m in masks), k_cl=k_cl, interpret=True)
    tt = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    rep = lambda x: tt(np.repeat(x, 8))
    pt, pi, pk, pm = tstream.stream_round_rows(
        bvh.cl_lines, bvh.cl_lo, bvh.cl_hi, rep(glo), rep(ghi), rep(ca),
        rep(cb), *(tt(o[:, k]) for k in range(3)),
        *(tt(d[:, k]) for k in range(3)), tt(t0), tt(idx0), tt(masks))
    flat = lambda x: np.asarray(x).reshape(-1)
    np.testing.assert_array_equal(pi.numpy(), flat(ji))
    np.testing.assert_allclose(pt.numpy(), flat(jt), rtol=1e-6)
    np.testing.assert_array_equal(pk.numpy(), flat(jk))
    np.testing.assert_array_equal(pm.numpy(),
                                  np.stack([flat(m) for m in jm]))
    assert (pi.numpy() >= 0).sum() > 100
    assert 0 < (pk.numpy() < k_cl).sum() < n
    # the empty blocks' rays keep their bits, t and idx
    np.testing.assert_array_equal(pm.numpy()[:, 3072:], masks[:, 3072:])
    assert tstream.launches_round == 0


@pytest.mark.parametrize("ch", [8, tstream.CH, 64])
def test_item_round_equals_the_plain_round(ch, monkeypatch):
    """The CUDA round as a plain model: the stream split into work items of
    `ch` groups and merged on each ray's 64-bit key (the model of
    tests/test_torch_stream.py), then the finish pass (the decoded t and
    idx, the mark of [ca, cb], the candidate scan on the decoded t) equals
    `stream_round_rows_ref` bit for bit (t, idx, key, bits) on a pool whose
    ranges are very uneven: one block spanning every cluster beside
    single-cluster blocks, an empty block and a block of sentinel rays."""
    _, ms = mesh_pair(2000, 71, monkeypatch)
    bvh = ms.tri_bvh
    k_cl = bvh.cl_lo.shape[0]
    n_mask = (k_cl + 31) // 32
    blocks = 8
    n = blocks * tstream.BLOCK
    gs = bvh.cl_gs.long()
    rs = np.random.default_rng(72)
    first = np.array([0] + sorted(rs.integers(0, k_cl, 5).tolist())
                     + [0, 0])
    last = first.copy()
    last[0] = k_cl - 1                                  # the whole table
    last[6:] = -1                                       # empty; sentinels
    empty = last < 0
    glo = torch.from_numpy(np.where(empty, 0, gs[first].numpy())).int()
    ghi = torch.from_numpy(np.where(empty, 0, gs[np.clip(last, 0, None) + 1]
                                    .numpy())).int()
    ca = torch.from_numpy(np.where(empty, 0, first)).int()
    cb = torch.from_numpy(last).int()
    assert int(ghi[0] - glo[0]) > 20 * int((ghi[1:6] - glo[1:6]).max())
    o, d, cap, alive = rays(n, 73)
    tt = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    planes = [tt(o[:, k]) for k in range(3)] + [tt(d[:, k]) for k in range(3)]
    t0 = tt(np.where(alive, cap, 0.0).astype(np.float32))
    idx0 = torch.full((n,), -1, dtype=torch.int32)
    masks = tt(rs.integers(-(1 << 31), 1 << 31, (n_mask, n)).astype(np.int32)
               & (rs.uniform(size=(n_mask, n)) < 0.3).astype(np.int32))
    want = tstream.stream_round_rows_ref(bvh.cl_lines, bvh.cl_lo, bvh.cl_hi,
                                         glo, ghi, ca, cb, *planes, t0,
                                         idx0, masks)
    t1, i1 = split_merge_model(bvh.cl_lines, glo, ghi, *planes, t0, idx0,
                               ch=ch)
    m1 = tstream.mark_range(masks, ca.repeat_interleave(tstream.BLOCK),
                            cb.repeat_interleave(tstream.BLOCK))
    k1, _ = tstream.candidates(bvh.cl_lo, bvh.cl_hi, *planes, t1,
                               tstream.processed(m1, k_cl))
    for got, w in zip((t1, i1, k1, m1), want):
        assert torch.equal(got, w)
    assert (i1[:tstream.BLOCK] >= 0).sum() > 5
    assert torch.equal(m1[:, 6 * tstream.BLOCK:], masks[:, 6 * tstream.BLOCK:])


def test_binned_fused_route_matches_jax_and_the_unfused_route(monkeypatch):
    """binned_closest(b1_fused=True) on 2,500 triangles and 2,176 rays:
    idx equal to the JAX route's under GRT_B1_FUSED=1 on every lane, t
    within rtol 1e-5 (the JAX package's bound for its routes: XLA may
    contract a multiply-add of the Moller-Trumbore that the port keeps
    apart; one lane here is 1.8e-6 off); and the port's unfused route makes
    the same rounds and host reads with bit-equal t and idx."""
    js, ms = mesh_pair(2500, 55, monkeypatch)
    monkeypatch.setenv("GRT_B1_FUSED", "1")
    o, d, cap, alive = rays(2176, 56)
    jt, ji = jtrace.binned_closest(js, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(cap), jnp.asarray(alive))
    tt = torch.from_numpy
    cf, cu = {}, {}
    ft, fi = ttrace.mesh_closest(ms, tt(o), tt(d), tt(cap), tt(alive),
                                 mesh="binned", b1_fused=True, counters=cf)
    np.testing.assert_array_equal(fi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ft.numpy(), np.asarray(jt), rtol=1e-5)
    ut, ui = ttrace.mesh_closest(ms, tt(o), tt(d), tt(cap), tt(alive),
                                 mesh="binned", counters=cu)
    assert torch.equal(fi, ui) and torch.equal(ft, ut)
    assert cf == cu and cf["rounds"] >= 2
    assert (fi >= 0).sum() > 300


def test_fused_route_refuses_what_it_cannot_run(monkeypatch):
    """No fallback: more than 256 clusters, no cluster-box table, or the
    option on another route raises ValueError; so does the kernel itself
    for K > 256."""
    _, ms = mesh_pair(600, 91, monkeypatch)
    bvh = ms.tri_bvh
    o = torch.zeros((128, 3))
    d = torch.ones((128, 3))
    with pytest.raises(ValueError, match="binned route"):
        ttrace.mesh_closest(ms, o, d, mesh="walk", b1_fused=True)
    big = torch.zeros((257, 3))
    monkeypatch.setattr(bvh, "cl_lo", big)
    with pytest.raises(ValueError, match="256"):
        ttrace.mesh_closest(ms, o, d, mesh="binned", b1_fused=True)
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="256"):
        tstream.stream_round_rows(bvh.cl_lines, big, big, z, z, z, z,
                                  *(torch.zeros(128),) * 7,
                                  torch.zeros(128, dtype=torch.int32),
                                  torch.zeros((9, 128), dtype=torch.int32))
    monkeypatch.setattr(bvh, "cl_lo", torch.zeros((10, 3)))
    monkeypatch.setattr(bvh, "cl_boxes", None)
    with pytest.raises(ValueError, match="cluster-box"):
        ttrace.mesh_closest(ms, o, d, mesh="binned", b1_fused=True)


def test_mark_range_and_processed_bits():
    """mark_range ORs [ca, cb] into the words (cb < ca: nothing), across a
    word boundary too; processed() reads them back per cluster."""
    masks = torch.zeros((3, 4), dtype=torch.int32)
    ca = torch.tensor([0, 30, 5, 64], dtype=torch.int32)
    cb = torch.tensor([-1, 33, 5, 95], dtype=torch.int32)
    m = tstream.mark_range(masks, ca, cb)
    proc = tstream.processed(m, 70)
    want = torch.zeros((4, 70), dtype=torch.bool)
    want[1, 30:34] = want[2, 5] = want[3, 64:70] = True
    assert torch.equal(proc, want)
    assert m[2, 3].item() == -1 and m[:, 0].eq(0).all()
