"""The binned mesh intersector of the port against the JAX package: the
plain version of the row-stream kernel against the Pallas kernel in
interpret mode on the same sorted planes and ranges, a plain model of the
CUDA kernel's split into work items and merge against the plain version,
`binned_closest` against the JAX `binned_closest`, and both against
oracles that share nothing with them (the skip-link walk and the dense
all-pairs test)."""

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


def pack_lines(entries):
    """Entries (L*8, 8, 16) back to the line-packed (L*8, 128) table: the
    inverse of `stream.unpack_lines`."""
    return entries.view(-1, 8, 8, 16).permute(0, 2, 1, 3).reshape(-1, 128) \
        .contiguous()


_NO_HIT = (1 << 63) - 1     # above every key (t bits < 2^31)


def split_merge_model(tri_lines, glo, ghi, ox, oy, oz, dx, dy, dz, t, idx,
                      ch):
    """Plain model of the CUDA kernel's split and merge (csrc/stream.cu):
    each block's range [glo, ghi) is cut into items at multiples of `ch` in
    the global group index; every item streams its groups in ascending
    order from t_in, one group at a time, and a ray that found a hit
    offers the key (float bits of t) << 32 | g << 3 | slot of its winner;
    each ray keeps the least key, and the finalize step reads t from the
    key and idx from field 9 of (g, slot), or keeps t_in and idx_in."""
    entries = tstream.unpack_lines(tri_lines)
    n_groups = entries.shape[0]
    blk = tstream.BLOCK
    rays = [x.view(-1, blk) for x in (ox, oy, oz, dx, dy, dz)]
    t_in = t.view(-1, blk)
    key = torch.full(t_in.shape, _NO_HIT, dtype=torch.int64)
    for b in range(t_in.shape[0]):
        lo, hi = max(int(glo[b]), 0), min(int(ghi[b]), n_groups)
        r = [x[b] for x in rays]
        for c in range(lo // ch, (hi - 1) // ch + 1) if hi > lo else ():
            t_b = t_in[b].clone()
            i_b = torch.full((blk,), -1, dtype=torch.int32)
            g_b = torch.full((blk,), -1, dtype=torch.int64)
            for g in range(max(lo, c * ch), min(hi, (c + 1) * ch)):
                t_n, i_n = tstream.mt_groups_ref(entries[g][None], *r, t_b,
                                                 i_b)
                g_b = torch.where(t_n < t_b, g, g_b)
                t_b, i_b = t_n, i_n
            hit = g_b >= 0
            ids = entries[g_b.clamp(min=0), :, 9]           # (BLOCK, 8)
            slot = (ids == i_b[:, None].float()).int().argmax(dim=1)
            k = (t_b.view(torch.int32).long() << 32) | (g_b << 3) | slot
            key[b] = torch.where(hit, torch.minimum(key[b], k), key[b])
    found = key != _NO_HIT
    g, slot = (key & 0xFFFFFFFF) >> 3, key & 7
    t_out = torch.where(found, (key >> 32).int().view(torch.float32), t_in)
    idx_out = torch.where(
        found, entries[g.clamp(max=n_groups - 1), slot, 9].int(),
        idx.view(-1, blk))
    return t_out.reshape(t.shape), idx_out.reshape(idx.shape)


@pytest.mark.parametrize("ch", [1, 8, 16, 64])
def test_split_merge_equals_the_stream(ch, monkeypatch):
    """The kernel's split into items of `ch` groups and its merge on a
    64-bit key give `stream_rows_ref`'s t bit for bit and its idx on every
    lane: a block whose range is the whole table, an empty one, short and
    long ranges, capped and dead rays, and a triangle duplicated (another
    id) from group 63 into group 64, a boundary of every `ch`, which rays
    of the whole-table block hit at one t: the earlier group's id wins."""
    _, ms = mesh_pair(1000, 93, monkeypatch)
    entries = tstream.unpack_lines(ms.tri_bvh.cl_lines).clone()
    n_groups = entries.shape[0]
    assert n_groups > 80
    src_id, dup_id = float(entries[63, 2, 9]), 123457.0
    assert src_id >= 0
    entries[64, 5] = entries[63, 2]
    entries[64, 5, 9] = dup_id
    lines = pack_lines(entries)
    assert torch.equal(tstream.unpack_lines(lines), entries)
    n = 6 * tstream.BLOCK
    glo = torch.tensor([0, 5, 7, 7, 60, 3], dtype=torch.int32)
    ghi = torch.tensor([n_groups, 40, 7, 9, 70, n_groups - 2],
                       dtype=torch.int32)
    _, _, cap, alive = rays(n, 94)
    t0 = np.where(alive, cap, 0.0).astype(np.float32)
    # every ray starts above a real triangle of its block's range (block 0:
    # the duplicated one) and looks down on it, so hits abound and nearby
    # triangles of other groups compete
    rs = np.random.default_rng(95)
    e = entries.numpy()
    real = np.argwhere(e[:, :, 9] >= 0)
    pick = np.empty((n, 2), np.int64)
    for b in range(6):
        lo, hi = int(glo[b]), max(int(ghi[b]), int(glo[b]) + 1)
        pool = real[(real[:, 0] >= lo) & (real[:, 0] < hi)]
        pick[b * 128:(b + 1) * 128] = pool[rs.integers(0, len(pool), 128)]
    pick[:tstream.BLOCK] = (63, 2)
    tri = e[pick[:, 0], pick[:, 1]]
    v0, e0, e1 = tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]
    nrm = np.cross(e0, e1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    u = rs.uniform(0.05, 0.45, (n, 2))
    dist = np.where(np.arange(n) < tstream.BLOCK, 0.05,
                    rs.uniform(0.05, 3.0, n))[:, None]
    o = (v0 + u[:, :1] * e0 + u[:, 1:] * e1 + dist * nrm).astype(np.float32)
    d = (-nrm + rs.normal(scale=0.05, size=(n, 3))).astype(np.float32)
    d[:tstream.BLOCK] = -nrm[:tstream.BLOCK]
    t0[:tstream.BLOCK] = np.inf
    tt = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    args = (lines, glo, ghi, *(tt(o[:, k]) for k in range(3)),
            *(tt(d[:, k]) for k in range(3)), tt(t0),
            torch.full((n,), -1, dtype=torch.int32))
    want_t, want_i = tstream.stream_rows_ref(*args)
    got_t, got_i = split_merge_model(*args, ch=ch)
    assert torch.equal(got_i, want_i) and torch.equal(got_t, want_t)
    head = want_i[:tstream.BLOCK]
    assert (head == int(src_id)).sum() > 100 and not (head == dup_id).any()
    assert (want_i[tstream.BLOCK:] >= 0).sum() > 300
    assert torch.equal(want_t[2 * tstream.BLOCK:3 * tstream.BLOCK],
                       tt(t0[2 * tstream.BLOCK:3 * tstream.BLOCK]))


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
    pt, pi = ttrace.mesh_closest(ms, o, d, mesh="binned")
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
