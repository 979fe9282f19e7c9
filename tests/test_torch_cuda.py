"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: they skip on a machine without one (the CPU tests hold the
plain versions against the JAX package). Run on a GPU machine with
`python -m pytest tests/test_torch_cuda.py -m gpu`; chip_smoke.py runs the
same comparisons at the flagship's shapes."""

import types

import numpy as np
import pytest
import torch

from go_raytracer_tpu_torch.integrator import regen
from go_raytracer_tpu_torch.ops import bounce, harvest, intersect, stream
from go_raytracer_tpu_torch.ops import stream2, trace, traverse, traverse8
from go_raytracer_tpu_torch.render.camera import Camera
from go_raytracer_tpu_torch.scene.builder import SceneBuilder
from go_raytracer_tpu_torch.scenes import registry

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _cornell(dev, n, seed=0, scene="cornell_box"):
    scene, cam = getattr(registry, scene)()
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    tables = tuple(to(t) for t in bounce.pack_scene(scene))
    rs = np.random.default_rng(seed)
    o = rs.uniform(50, 500, (n, 3)).astype(np.float32)
    d = (rs.normal(size=(n, 3)) * 300).astype(np.float32)
    state = [to(o[:, k]) for k in range(3)] + [to(d[:, k]) for k in range(3)] \
        + [to(rs.uniform(0, 1, n).astype(np.float32)),
           to((rs.uniform(size=n) < 0.6).astype(np.int32)),
           to(rs.integers(0, 50, n).astype(np.int32))]
    return (scene, cam, tables, bounce.scene_statics(scene),
            to(bounce.pack_camera(cam.derived())),
            to(np.asarray(scene.background, np.float32)), state)


RTOL = ATOL = 2e-3     # FMA / rsqrtf / __sincosf rounding, as chip_smoke
MISMATCH_FRAC = 2e-3   # lanes whose ray grazes an edge may branch the other way
# the three scenes of the fused kernels, and the fraction each may flip:
# book3's glass sphere turns a rounding into a reflect/refract flip within
# a few levels (tests/test_torch_fused.py measures 2.5e-3 against the JAX
# package at 3 levels)
FUSED_SCENES = {"cornell_box": MISMATCH_FRAC, "book3": 5e-3,
                "cornell_smoke": MISMATCH_FRAC}


def _started_ranks_are_a_prefix(fl, take):
    """Per level, the started lanes' ranks (FL bits 3..) are exactly
    0 .. take-1: no item is skipped or given to two lanes."""
    s, n = fl.shape
    started = (fl & 4) != 0
    lvl = torch.arange(s, device=fl.device)[:, None].expand(s, n)[started]
    hits = torch.zeros(s * n, dtype=torch.int32, device=fl.device)
    hits.index_add_(0, lvl * n + (fl[started] >> 3).long(),
                    torch.ones_like(lvl, dtype=torch.int32))
    want = torch.arange(n, device=fl.device)[None, :] < take[:, None]
    return torch.equal(hits.view(s, n), want.to(torch.int32))


@pytest.mark.parametrize("scene", FUSED_SCENES)
def test_bounce_kernel_matches_plain(cuda, scene):
    """Starts at level 0 only, 8 levels, 512 blocks (so each block sums
    the dead counts of the blocks before it over more than one pass), on
    cornellBox, book3 and cornellSmoke tables: exact takes and starts;
    level-0 V within rtol = atol = 2e-3 wherever the flags agree; over all
    levels, at most 0.2% (book3: 0.5%) of the flags, alive bits, V values
    and alive lanes' origins beyond that tolerance (a lane that branched
    the other way at one level carries a different path from then on)."""
    n, n_inner = 512 * bounce.BLOCK, 8
    frac = FUSED_SCENES[scene]
    scene, cam, tables, st, cam_row, bg, state = _cornell(cuda, n,
                                                          scene=scene)
    seed4 = torch.tensor([12345, 1, 0, 360000 * 100], dtype=torch.int32,
                         device=cuda)
    kw = dict(has_defocus=False, max_depth=50, n_inner=n_inner, width=600,
              sqrt_spp=10, npix=360000)
    k = bounce.bounce_fused_q(tables, st, cam_row, bg, seed4, *state, **kw)
    p = bounce.bounce_fused_q_ref(tables, st, cam_row, bg, seed4, *state, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k[3], p[3])
    assert torch.equal(k[0][3][0] & ~3, p[0][3][0] & ~3)
    assert _started_ranks_are_a_prefix(k[0][3], k[3])
    assert ((k[0][3] & 7) != (p[0][3] & 7)).float().mean() <= frac
    assert (k[4 + 7] != p[4 + 7]).float().mean() <= frac
    agree0 = k[0][3][0] == p[0][3][0]
    for a, b in zip(k[0][:3], p[0][:3]):
        torch.testing.assert_close(a[0][agree0], b[0][agree0], rtol=RTOL,
                                   atol=ATOL, equal_nan=True)
        off = ~torch.isclose(a, b, rtol=RTOL, atol=ATOL, equal_nan=True)
        assert off.float().mean() <= frac
    alive = (k[4 + 7] > 0) & (p[4 + 7] > 0)
    for a, b in zip(k[4:7], p[4:7]):
        off = ~torch.isclose(a[alive], b[alive], rtol=RTOL, atol=ATOL)
        assert off.float().mean() <= frac


def test_bounce_kernel_ranks_every_refill_level(cuda):
    """Refill at every level, 512 blocks: each level's starts take the
    items base .. base+take-1 once each, and the bases chain the cursor."""
    n, n_inner = 512 * bounce.BLOCK, 8
    scene, cam, tables, st, cam_row, bg, state = _cornell(cuda, n, seed=1)
    seed4 = torch.tensor([99, n_inner, 1000, 360000 * 100],
                         dtype=torch.int32, device=cuda)
    out = bounce.FusedQOut.empty(n, n_inner, cuda)
    bounce.bounce_fused_q(tables, st, cam_row, bg, seed4, *state, out=out,
                          has_defocus=False, max_depth=50, n_inner=n_inner,
                          width=600, sqrt_spp=10, npix=360000)
    torch.cuda.synchronize()
    assert _started_ranks_are_a_prefix(out.rec[3], out.take)
    base, take = out.base.tolist(), out.take.tolist()
    assert base[0] == 1000
    assert all(base[j + 1] == base[j] + take[j] for j in range(n_inner - 1))
    assert int(out.cursor) == base[-1] + take[-1]


def test_harvest_kernel_matches_plain(cuda):
    n, n_inner = 512 * bounce.BLOCK, 8
    scene, cam, tables, st, cam_row, bg, state = _cornell(cuda, n)
    seed4 = torch.tensor([777, n_inner, 50, 360000 * 100], dtype=torch.int32,
                         device=cuda)
    out = bounce.FusedQOut.empty(n, n_inner, cuda)
    bounce.bounce_fused_q(tables, st, cam_row, bg, seed4, *state, out=out,
                          has_defocus=False, max_depth=50, n_inner=n_inner,
                          width=600, sqrt_spp=10, npix=360000)
    end = int(out.cursor)
    acc_k = torch.zeros((end - 50 + n, 3), device=cuda)
    acc_p = torch.zeros_like(acc_k)
    kw = dict(item_base=50, s_run=n_inner, refill_levels=n_inner,
              max_contribution=cam.max_contribution)
    harvest.harvest_levels_into(acc_k, *out.rec, out.base, **kw)
    rows = harvest.reverse_harvest_levels_ref(
        *out.rec, refill_levels=n_inner,
        max_contribution=cam.max_contribution)
    harvest.write_rows_ref(acc_p, rows, out.base, item_base=50,
                           n_rows=n_inner)
    assert torch.equal(acc_k[:end - 50], acc_p[:end - 50])


def test_exact_accounting_on_kernels(cuda):
    b = SceneBuilder(background=(1.0, 1.0, 1.0))
    m = b.lambertian((0.5, 0.5, 0.5))
    b.quad((0, 0, 1e8), (1, 0, 0), (0, 1, 0), m)
    b.add_light(b.quad((0, 0, 1e8), (1, 0, 0), (0, 1, 0),
                       b.diffuse_light((1, 1, 1))))
    cam = Camera(width=32, aspect_ratio=1.0, samples_per_pixel=9, max_depth=4)
    cam.position((0, 0, 5), (0, 0, 0))
    bounce.launches = harvest.launches = 0
    img, st = regen.render_regen(b.build(), cam, n_lanes=4096, cadence=3,
                                 device=cuda)
    np.testing.assert_array_equal(img, 1.0)
    assert st["segments"] == 32 * 32 * 9
    assert bounce.launches > 0 and harvest.launches > 0


# ---------------------------------------------------------------------------
# the mesh path's kernels (scene 8's tables)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene8():
    return registry.model_example()


def _mesh_rays(dev, n, seed):
    """Rays around and towards the statue, some capped, some dead."""
    rs = np.random.default_rng(seed)
    o = rs.uniform(-6, 8, (n, 3)).astype(np.float32)
    d = (-o * rs.uniform(0, 1, (n, 1)) + rs.normal(size=(n, 3))) \
        .astype(np.float32)
    cap = np.where(rs.uniform(size=n) < 0.3, 6.0, np.inf).astype(np.float32)
    alive = rs.uniform(size=n) < 0.9
    to = lambda a: torch.from_numpy(a).to(dev)
    return to(o), to(d), to(cap), to(alive)


def test_stream_kernel_matches_plain(cuda, scene8):
    """K4 on sorted pools: idx equal on every lane and t bit for bit,
    empty blocks, capped and dead lanes included."""
    ms = trace.to_device(scene8[0], cuda)
    bvh = ms.tri_bvh
    n = 128 * stream.BLOCK
    o, d, cap, alive = _mesh_rays(cuda, n, 1)
    k_cl = bvh.cl_lo.shape[0]
    rs = np.random.default_rng(2)
    key = np.sort(rs.integers(0, k_cl, n))
    key[-5 * stream.BLOCK:] = k_cl
    kb = torch.from_numpy(key).to(cuda).view(-1, stream.BLOCK)
    last = torch.where(kb < k_cl, kb, -1).amax(dim=1)
    empty = last < 0
    gs = bvh.cl_gs.long()
    glo = torch.where(empty, 0, gs[kb[:, 0].clamp(0, k_cl - 1)]).int()
    ghi = torch.where(empty, 0, gs[last.clamp(0, k_cl - 1) + 1]).int()
    planes = [o[:, k].contiguous() for k in range(3)] \
        + [d[:, k].contiguous() for k in range(3)]
    t0 = torch.where(alive, cap, 0.0)
    idx0 = torch.full((n,), -1, dtype=torch.int32, device=cuda)
    before = stream.launches
    kt, ki = stream.stream_rows(bvh.cl_lines, glo, ghi, *planes, t0, idx0)
    torch.cuda.synchronize()
    assert stream.launches == before + 1
    pt, pi = stream.stream_rows_ref(bvh.cl_lines, glo, ghi, *planes, t0, idx0)
    assert torch.equal(ki, pi) and torch.equal(kt, pt)
    assert (ki >= 0).sum() > 100


def test_stream_kernel_on_adversarial_ranges(cuda, scene8):
    """K4's split and merge on ranges the sort never makes: one block holding
    the whole table, empty blocks, a range ending at the table's end, ranges
    cut mid-octet, dead and capped lanes, and a triangle duplicated (another
    id) from group 63 into group 64, a boundary of every item size, hit by a
    block of rays at one t: idx equal on every lane, t bit for bit, and the
    earlier group's id wins the tie."""
    ms = trace.to_device(scene8[0], cuda)
    entries = stream.unpack_lines(ms.tri_bvh.cl_lines).clone()
    n_groups = entries.shape[0]
    src_id = int(entries[63, 2, 9])
    entries[64, 5] = entries[63, 2]
    entries[64, 5, 9] = 999999.0
    lines = entries.view(-1, 8, 8, 16).permute(0, 2, 1, 3).reshape(-1, 128) \
        .contiguous()
    blocks = 40
    n = blocks * stream.BLOCK
    o, d, cap, alive = _mesh_rays(cuda, n, 21)
    v0, e0, e1 = (entries[63, 2, k:k + 3] for k in (0, 3, 6))
    nrm = torch.linalg.cross(e0, e1)
    nrm = nrm / nrm.norm()
    u = torch.rand((stream.BLOCK, 2), generator=torch.Generator().manual_seed(3))
    head = slice(0, stream.BLOCK)
    o[head] = v0 + u[:, :1].to(cuda) * 0.4 * e0 + u[:, 1:].to(cuda) * 0.4 * e1 \
        + 0.05 * nrm
    d[head] = -nrm
    alive[head] = True
    cap[head] = float("inf")
    rs = np.random.default_rng(22)
    lo = np.sort(rs.integers(0, n_groups, blocks))
    hi = np.minimum(lo + rs.integers(0, 200, blocks), n_groups)
    lo[0], hi[0] = 0, n_groups              # the whole table
    lo[1:4] = hi[1:4] = 17                  # empty
    lo[4], hi[4] = n_groups - 11, n_groups  # up to the table's end
    lo[5], hi[5] = 3, 5                     # inside one octet
    planes = [o[:, k].contiguous() for k in range(3)] \
        + [d[:, k].contiguous() for k in range(3)]
    args = (lines, torch.from_numpy(lo).int().to(cuda),
            torch.from_numpy(hi).int().to(cuda), *planes,
            torch.where(alive, cap, 0.0),
            torch.full((n,), -1, dtype=torch.int32, device=cuda))
    before = stream.launches
    kt, ki = stream.stream_rows(*args)
    torch.cuda.synchronize()
    assert stream.launches == before + 1
    pt, pi = stream.stream_rows_ref(*args)
    assert torch.equal(ki, pi) and torch.equal(kt, pt)
    assert (ki[head] == src_id).sum() > 100 and not (ki == 999999).any()
    assert (ki[stream.BLOCK:] >= 0).sum() > 100
    assert torch.equal(kt[stream.BLOCK:4 * stream.BLOCK],
                       args[9][stream.BLOCK:4 * stream.BLOCK])


def test_bvh8_kernel_matches_plain(cuda, scene8):
    """K5 on the statue: idx equal and t bit for bit, on the rows packed
    from the padded node table and from a line-packed copy (the same
    rows); a dead lane keeps cap 0 and -1."""
    from go_raytracer_tpu_torch.scene import bvh8

    ms = trace.to_device(scene8[0], cuda)
    bvh = ms.tri_bvh
    o, d, cap, alive = _mesh_rays(cuda, 20000, 3)
    cap0 = torch.where(alive, cap, 0.0)
    entries = traverse8.node_entries(bvh.nodes8, bvh.bvh8_dense).cpu().numpy()
    lines = bvh8._pack_lines(entries.copy())
    rows = traverse8.pack_tables(lines, bvh.tris8.cpu().numpy(), True)
    torch.testing.assert_close(rows[0][:bvh.bvh8_nodes.shape[0]].cuda(),
                               bvh.bvh8_nodes, rtol=0, atol=0, equal_nan=True)
    for nodes, tris in ((bvh.bvh8_nodes, bvh.bvh8_tris),
                        tuple(x.to(cuda) for x in rows)):
        before = traverse8.launches
        kt, ki = traverse8.bvh8_closest(nodes, tris, o, d, cap0,
                                        max_stack=bvh.max_stack)
        torch.cuda.synchronize()
        assert traverse8.launches == before + 1
        pt, pi = traverse8.bvh8_closest_ref(nodes, tris, o, d, cap0)
        assert torch.equal(ki, pi) and torch.equal(kt, pt)
        assert (ki >= 0).sum() > 1000 and (ki[~alive] == -1).all()
    with pytest.raises(ValueError, match="max_stack"):
        traverse8.bvh8_closest(bvh.bvh8_nodes, bvh.bvh8_tris, o, d, cap0)


def _bvh8_tables(v, leaf_size, dev):
    """K5's rows (nodes, tris; `traverse8.pack_tables`) and `max_stack` of
    a BVH over triangle vertices v (T, 3, 3) with leaves of at most
    `leaf_size`, on `dev`."""
    from go_raytracer_tpu_torch.scene import bvh as bvh_mod
    from go_raytracer_tpu_torch.scene import bvh8 as bvh8_mod
    fb = bvh_mod.build(v, leaf_size=leaf_size)
    vp = v[fb.order[:v.shape[0]]].astype(np.float32)
    b8 = bvh8_mod.collapse(fb.node_min, fb.node_max, fb.first, fb.count,
                           fb.skip, vp[:, 0], vp[:, 1] - vp[:, 0],
                           vp[:, 2] - vp[:, 0], max_leaf=leaf_size)
    return (*(x.to(dev) for x in traverse8.pack_tables(
        b8.node_lines, b8.tri_lines, b8.dense_nodes)),
            bvh8_mod.max_stack(b8.node_lines, b8.dense_nodes))


@pytest.mark.parametrize("team,block,leaf_batch", [
    (8, 128, 2), (8, 64, 1), (8, 128, 4), (4, 256, 8), (4, 128, 2)])
@pytest.mark.parametrize("tree", ["statue", "leaf16", "coincident"])
def test_bvh8_kernel_on_incoherent_and_sorted_rays(cuda, scene8, tree, team,
                                                   block, leaf_batch,
                                                   monkeypatch):
    """K5 with 8 lanes a ray (or 4 with two slots each), blocks of 64 to
    256 threads and the walk phase ended at 1 to 8 held leaves, on
    unsorted incoherent rays (random origins and directions through the
    mesh, 30% capped, 10% dead, a lane count that is not a multiple of
    the block) and on the same rays sorted as the walk route sorts them:
    on the statue, on 3,001 random triangles in leaves of up to 16
    (two-group leaves) and on a mesh with every triangle twice (ties inside
    a group and across leaves): idx equal and t bit for bit."""
    monkeypatch.setattr(traverse8, "TEAM", team)
    monkeypatch.setattr(traverse8, "BLOCK", block)
    monkeypatch.setattr(traverse8, "LEAF_BATCH", leaf_batch)
    rs = np.random.default_rng(23)
    if tree == "statue":
        bvh = trace.to_device(scene8[0], cuda).tri_bvh
        nodes, tris = bvh.bvh8_nodes, bvh.bvh8_tris
        max_stack, scale = bvh.max_stack, 8.0
    else:
        v = rs.uniform(-10, 10, (3001, 1, 3)) \
            + rs.uniform(-0.8, 0.8, (3001, 3, 3))
        if tree == "coincident":
            v = np.concatenate([v, v[::-1]])
        nodes, tris, max_stack = _bvh8_tables(v, 16, cuda)
        scale = 12.0
    n = 20000 + 77
    o = rs.uniform(-scale, scale, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    cap = np.where(rs.uniform(size=n) < 0.3, scale, np.inf)
    cap = np.where(rs.uniform(size=n) < 0.9, cap, 0.0).astype(np.float32)
    o, d, cap = (torch.from_numpy(x).to(cuda) for x in (o, d, cap))
    # the walk route's key over the rays' cube
    box = types.SimpleNamespace(node_min=torch.full((1, 3), -scale,
                                                    device=cuda),
                                node_max=torch.full((1, 3), scale,
                                                    device=cuda))
    key = torch.where(cap > 0, trace.coherence_key(box, o, d), 0x7FFFFFFF)
    perm = torch.sort(key).indices
    for o_, d_, cap_ in ((o, d, cap), (o[perm].contiguous(),
                                       d[perm].contiguous(),
                                       cap[perm].contiguous())):
        before = traverse8.launches
        kt, ki = traverse8.bvh8_closest(nodes, tris, o_, d_, cap_,
                                        max_stack=max_stack)
        torch.cuda.synchronize()
        assert traverse8.launches == before + 1
        pt, pi = traverse8.bvh8_closest_ref(nodes, tris, o_, d_, cap_)
        assert torch.equal(ki, pi) and torch.equal(kt, pt)
        assert (ki >= 0).sum() > 1000 and (ki[cap_ == 0] == -1).all()


def test_mesh_closest_routes_agree_on_card(cuda, scene8):
    """The binned route (K4) and the walk route (K5) return the same
    winners and t, and the plain skip-link walk agrees with them."""
    ms = trace.to_device(scene8[0], cuda)
    o, d, cap, alive = _mesh_rays(cuda, 10000, 5)
    bt, bi = trace.mesh_closest(ms, o, d, cap, alive, mesh="binned")
    wt, wi = trace.mesh_closest(ms, o, d, cap, alive, mesh="walk")
    assert torch.equal(bi, wi) and torch.equal(bt, wt)
    st, si = trace.bvh_tri_closest(ms, o, d, trace.T_MIN, float("inf"))
    hit = torch.isfinite(st) & (st < cap) & alive
    assert ((bi >= 0) == hit).float().mean() > 0.999
    both = (bi >= 0) & hit
    assert (bi[both] == si[both]).float().mean() > 0.999


def test_bounce_ext_kernel_matches_plain(cuda, scene8):
    """K3 on scene 8 from a real closest hit (the walk's winner, gathered
    in the kernel): alive and cf mismatch at most 1e-3 of the lanes, E/W
    and the scattered rays within rtol = atol = 2e-3 on all but 1e-3 of
    the agreeing lanes, against the plain gather and bounce."""
    scene = scene8[0]
    st = bounce.scene_statics(scene, ext=True)
    ms = trace.to_device(scene, cuda)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    tables = tuple(to(t) for t in bounce.pack_scene(scene))
    tri = bounce.TriTable.build(ms.triangles,
                                to(bounce.tri_mat_table(scene, st)))
    n = 1 << 16
    o, d, _, alive = _mesh_rays(cuda, n, 7)
    tm = torch.zeros(n, device=cuda)
    u = to(np.random.default_rng(8).random((n, 9)).astype(np.float32))
    cap = intersect.sphere_ts(ms.spheres, o, d, tm, 1e-3,
                              float("inf")).amin(dim=1)
    hit = bounce.MeshHit(*trace.mesh_closest(ms, o, d, cap, alive))
    bg = to(np.asarray(scene.background, np.float32))
    before = bounce.launches_bounce
    k = bounce.bounce(tables, st, o, d, tm, alive, u, bg, ext=hit, tri=tri)
    torch.cuda.synchronize()
    assert bounce.launches_bounce == before + 1
    p = bounce.bounce_ref(tables, st, o, d, tm, alive, u, bg, ext=hit,
                          tri=tri)
    assert (k[5] != p[5]).float().mean() <= 1e-3
    assert (k[2] != p[2]).float().mean() <= 1e-3
    agree = k[5] == p[5]
    for a, b in ((k[0], p[0]), (k[1], p[1])):
        off = ~torch.isclose(a[agree], b[agree], rtol=RTOL, atol=ATOL,
                             equal_nan=True)
        assert off.float().mean() <= 1e-3
    go_on = agree & k[5]
    for a, b in ((k[3], p[3]), (k[4], p[4])):
        off = ~torch.isclose(a[go_on], b[go_on], rtol=RTOL, atol=ATOL)
        assert off.float().mean() <= 1e-3
    assert not k[5][~alive].any() and not k[0][~alive].any()
    # given output buffers are written in place, with the same values
    out = bounce.bounce_out(n, cuda)
    k2 = bounce.bounce(tables, st, o, d, tm, alive, u, bg, ext=hit, out=out,
                       tri=tri)
    assert all(a is b for a, b in zip(k2[:6], out))
    assert all(torch.equal(a, b) for a, b in zip(k2[:6], k[:6]))
    # the card takes the walk's winner, not planes
    with pytest.raises(ValueError):
        bounce.bounce(tables, st, o, d, tm, alive, u, bg,
                      ext=bounce.ext_planes_from_hit(st, tri, o, d, hit),
                      tri=tri)


def test_scene8_render_on_kernels(cuda, scene8):
    """A small scene-8 render on the kernels: both routes render the same
    image from one seed, and it agrees with a render on the plain
    versions (CPU, its own random stream) statistically: segments within
    4% and channel means within 0.03, about four standard deviations of
    the difference of two 48 px, 16 spp renders."""
    scene, cam = registry.model_example()
    cam.width, cam.samples_per_pixel, cam.max_depth = 48, 16, 6
    for m in (bounce, stream, traverse8, harvest):
        m.launches = 0
    bounce.launches_bounce = 0
    img_k, st_k = regen.render_regen(scene, cam, seed=3, n_lanes=4096,
                                     device=cuda, mesh="binned")
    assert bounce.launches_bounce > 0 and stream.launches > 0
    assert harvest.launches > 0 and traverse8.launches == 0
    img_w, st_w = regen.render_regen(scene, cam, seed=3, n_lanes=4096,
                                     device=cuda, mesh="walk")
    assert traverse8.launches > 0
    np.testing.assert_array_equal(img_w, img_k)
    img_p, st_p = regen.render_regen(scene, cam, seed=4, n_lanes=4096,
                                     device="cpu", mesh="walk")
    assert st_k["paths"] == st_p["paths"] and st_k["nonfinite"] == 0
    assert abs(st_k["segments"] - st_p["segments"]) < 0.04 * st_p["segments"]
    np.testing.assert_allclose(img_k.mean(axis=(0, 1)),
                               img_p.mean(axis=(0, 1)), atol=0.03)


# ---------------------------------------------------------------------------
# the `queue` and `positional` schedules' kernels (cornellBox tables)
# ---------------------------------------------------------------------------

def _queue_refill(state, next_item, item_end):
    """The refill planes of one real queue refill of `state`."""
    return regen.queue_refill_planes(
        torch.tensor(next_item, device=state[7].device), state[7], item_end,
        width=600, npix=360000, sqrt_spp=10)


def _fused_close(k, p, frac=MISMATCH_FRAC):
    """Outputs of one fused call, kernel against plain version: the alive
    count of level 0 is exact (it depends on the inputs only); flags,
    records and the alive lanes' rays agree within rtol = atol = 2e-3 on
    all but `frac` of the lanes. Returns the lanes that did not flip: equal
    integer records and float records within the tolerance at every level,
    and equal alive at the end (a lane that took another way through glass
    keeps its flags: no clamp flag either way). On those the time and depth
    planes are exact."""
    krec, _, kseg, *kst = k
    prec, _, pseg, *pst = p
    assert kseg[0].item() == pseg[0].item()
    assert ((kseg - pseg).abs() <= frac * kst[0].numel()).all()
    noflip = kst[7] == pst[7]
    assert (~noflip).float().mean() <= frac
    for a, b in zip(krec, prec):
        if a.dtype == torch.int32:
            assert (a != b).float().mean() <= frac
            noflip &= (a == b).all(dim=0)
        else:
            off = ~torch.isclose(a, b, rtol=RTOL, atol=ATOL, equal_nan=True)
            assert off.float().mean() <= frac
            noflip &= ~off.any(dim=0)
    alive = (kst[7] > 0) & (pst[7] > 0)
    for a, b in zip(kst[:6], pst[:6]):
        off = ~torch.isclose(a[alive], b[alive], rtol=RTOL, atol=ATOL)
        assert off.float().mean() <= frac
    assert (~noflip).float().mean() <= frac
    assert torch.equal(kst[6][noflip], pst[6][noflip])
    assert torch.equal(kst[8][noflip], pst[8][noflip])
    return noflip


@pytest.mark.parametrize("scene", FUSED_SCENES)
def test_bounce_fused_kernel_matches_plain(cuda, scene):
    """K6 at 512 blocks, 8 levels, the refill planes of a real refill that
    runs out of items before the last dead lane, on the three scenes."""
    n, n_inner = 512 * bounce.BLOCK, 8
    frac = FUSED_SCENES[scene]
    scene, cam, tables, st, cam_row, bg, state = _cornell(cuda, n,
                                                          scene=scene)
    n_dead = int((state[7] == 0).sum())
    refill = _queue_refill(state, 1000, 1000 + n_dead - 100)
    assert int(refill[0].sum()) == n_dead - 100
    seed = torch.tensor([-123456789], dtype=torch.int32, device=cuda)
    kw = dict(has_defocus=False, max_depth=50, n_inner=n_inner)
    before = bounce.launches_fused
    k = bounce.bounce_fused(tables, st, cam_row, bg, seed, *state, *refill,
                            **kw)
    torch.cuda.synchronize()
    assert bounce.launches_fused == before + 1
    p = bounce.bounce_fused_ref(tables, st, cam_row, bg, seed, *state,
                                *refill, **kw)
    _fused_close(k, p, frac)
    assert k[2][0].item() == n - 100
    # in place: the state planes may be the outputs
    st2 = [s.clone() for s in state]
    out = bounce.FusedOut.empty(n, n_inner, cuda)
    out.state = st2
    bounce.bounce_fused(tables, st, cam_row, bg, seed, *st2, *refill,
                        out=out, **kw)
    assert all(torch.equal(a, b) for a, b in zip(st2, k[3:]))
    assert all(torch.equal(a, b) for a, b in zip(out.rec, k[0]))


@pytest.mark.parametrize("scene", FUSED_SCENES)
def test_bounce_fused_pos_kernel_matches_plain(cuda, scene):
    """K8 at 512 blocks, 8 levels, `rem` mixed (zero, one, many), pointers
    near every carry, the refill cut after level 5, on the three scenes:
    the pointer planes are exact on every lane that did not flip."""
    n, n_inner, width, sq = 512 * bounce.BLOCK, 8, 600, 10
    frac = FUSED_SCENES[scene]
    scene, cam, tables, st, cam_row, bg, state = _cornell(cuda, n, seed=2,
                                                          scene=scene)
    rs = np.random.default_rng(3)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)
    ptr = [to(rs.choice([0, 7, width - 1], n)), to(rs.integers(0, 500, n)),
           to(rs.choice([0, sq - 1], n)), to(rs.choice([0, 3, sq - 1], n)),
           to(rs.choice([0, 1, 2, 300], n))]
    seed2 = torch.tensor([24680, 5], dtype=torch.int32, device=cuda)
    kw = dict(has_defocus=False, max_depth=50, n_inner=n_inner, width=width,
              sqrt_spp=sq)
    before = bounce.launches_fused_pos
    k = bounce.bounce_fused_pos(tables, st, cam_row, bg, seed2, *state, *ptr,
                                **kw)
    torch.cuda.synchronize()
    assert bounce.launches_fused_pos == before + 1
    p = bounce.bounce_fused_pos_ref(tables, st, cam_row, bg, seed2, *state,
                                    *ptr, **kw)
    noflip = _fused_close(k, p, frac)
    for a, b in zip(k[3 + 9:], p[3 + 9:]):
        assert torch.equal(a[noflip], b[noflip])
    ST = k[0][7]
    assert torch.equal(ST[0], p[0][7][0])
    assert not ST[5:].any() and ST[:5].any(dim=1).all()
    assert torch.equal(ST.sum(dim=0).float(), ptr[4] - k[3 + 13])


@pytest.mark.parametrize("schedule", ["queue", "positional"])
def test_schedule_window_kernels_match_plain(cuda, schedule):
    """One window of each schedule on the kernels, then the window's
    epilogue repeated with the plain versions on the kernels' records: for
    `queue`, K7 against `reverse_harvest_ref` + `write_rows_ref` (bit for
    bit, every started item written once and nothing else); for
    `positional`, exact accounting of the starts."""
    n, cad, depth = 64 * bounce.BLOCK, 4, 6
    scene, cam, tables, st, cam_row, bg, _ = _cornell(cuda, n)
    npix, sq, width = 360000, 10, 600
    total = 5 * n
    refill, window = 12, 20
    seeds = regen.window_seeds(5, 0, window // cad).to(cuda)
    kw = dict(width=width, sqrt_spp=sq, window=window, refill=refill,
              cadence=cad, max_depth=depth,
              max_contribution=cam.max_contribution)
    if schedule == "queue":
        bufs = regen.SchedBuffers.empty(n, window // cad, cad, cuda, 3)
        acc = torch.full((total + n, 3), float("nan"), device=cuda)
        before = (bounce.launches_fused, harvest.launches_rows)
        _, _, cur = regen._queue_window(
            tables, st, cam_row, bg, acc, regen._init_state(n, cuda),
            torch.tensor(0, device=cuda), seeds, 0, total, npix=npix,
            bufs=bufs, **kw)
        torch.cuda.synchronize()
        assert bounce.launches_fused == before[0] + window // cad
        assert harvest.launches_rows == before[1] + 1
        nxt = int(cur[0])
        counts = bufs.sts.sum(dim=1)
        nis = bufs.nis.tolist()
        assert nis[0] == 0 and nxt == nis[-1] + int(counts[-1]) \
            and all(nis[r + 1] == nis[r] + int(counts[r]) for r in range(2))
        rows = harvest.reverse_harvest_ref(
            *(r.view(window // cad, cad, n) for r in bufs.rec), bufs.sts,
            cadence=cad, refill_outer=3,
            max_contribution=cam.max_contribution)
        acc_p = torch.full_like(acc, float("nan"))
        harvest.write_rows_ref(acc_p, rows, bufs.nis, item_base=0, n_rows=3)
        assert not torch.isnan(acc[:nxt]).any()
        assert torch.equal(acc[:nxt], acc_p[:nxt])
        assert torch.isnan(acc[nxt:]).all()
    else:
        quota, lane_base, first_pix, G = regen.pos_tables(npix, 1, n)
        state = regen._init_state_pos(n, cuda, quota, lane_base, 1, width)
        B = torch.zeros((3, G, n), device=cuda)
        before = bounce.launches_fused_pos
        _, state, cur = regen._pos_window(
            tables, st, cam_row, bg, B, state,
            torch.from_numpy(quota).to(cuda),
            torch.from_numpy(first_pix.astype(np.float32)).to(cuda), seeds,
            G=G, **kw)
        torch.cuda.synchronize()
        assert bounce.launches_fused_pos == before + window // cad
        started = int(cur[0])
        k = regen._pos_state_k(state, quota)
        assert started == int(k.sum()) > n and (k <= quota).all()
        assert torch.isfinite(B).all() and float(B.sum()) > 0


def _sorted_synthetic_window(dev, outer, cadence, refill_outer, blocks):
    """K7's unwinding entry on a synthetic window (the invariants of
    tests/test_torch_reorder.py's `_window`: emission only at terminal
    vertices, starts only in refill rows) whose rows were sorted by random
    bijections, at item base 1000: bit for bit what the plain version
    writes, and with identity perms what K7 writes. The acc starts as NaN
    and holds as many slots before its tail as the window has starts, so
    no NaN before the tail and only NaN in it means every start wrote its
    own slot once and nothing else was written."""
    n, maxc, base = blocks * harvest.ROWS_BLOCK, 1.5, 1000
    rs = np.random.default_rng(18 + outer * cadence + refill_outer)
    shape = (outer, cadence, n)
    term = rs.uniform(size=shape) < 0.35
    V = np.where(term[None], rs.uniform(0.0, 2.0, (3,) + shape),
                 rs.uniform(0.0, 1.0, (3,) + shape)).astype(np.float32)
    FL = (rs.uniform(size=shape) < 0.3).astype(np.int32) \
        | (term.astype(np.int32) << 1)
    STs = np.zeros((outer, n), np.int32)
    STs[:refill_outer] = rs.uniform(size=(refill_outer, n)) < 0.3
    perms = np.stack([rs.permutation(n) for _ in range(outer)]).astype(
        np.int32)
    counts = STs.sum(axis=1)
    nis = (base + np.concatenate([[0], np.cumsum(counts)])[:outer]).astype(
        np.int32)
    total = int(counts.sum())
    cpu = [torch.from_numpy(np.ascontiguousarray(a))
           for a in (V[0], V[1], V[2], FL, STs, nis, perms)]
    card = [t.to(dev) for t in cpu]
    hkw = dict(cadence=cadence, refill_outer=refill_outer,
               max_contribution=maxc)
    acc_p = torch.full((total + n, 3), float("nan"))
    harvest.write_rows_ref(acc_p, harvest.reverse_harvest_ref(
        *cpu[:5], perms=cpu[6], **hkw), cpu[5], item_base=base,
        n_rows=refill_outer)
    ident = torch.arange(n, dtype=torch.int32, device=dev).repeat(outer, 1)
    out = {}
    for tag, perm in (("perm", card[6]), ("ident", ident), ("k7", None)):
        before = (harvest.launches_rows, harvest.launches_rows_perm)
        acc = torch.full((total + n, 3), float("nan"), device=dev)
        harvest.reverse_harvest_into(acc, *card[:6], item_base=base,
                                     perms=perm, **hkw)
        torch.cuda.synchronize()
        assert (harvest.launches_rows, harvest.launches_rows_perm) == (
            before[0] + (perm is None), before[1] + (perm is not None))
        assert not torch.isnan(acc[:total]).any()
        assert torch.isnan(acc[total:]).all()
        out[tag] = acc[:total].cpu()
    assert torch.equal(out["perm"], acc_p[:total])
    assert torch.equal(out["ident"], out["k7"])


# (outer, cadence, refill_outer, blocks of 256 lanes) of the synthetic
# windows; "past_the_grid" has more tiles than the card holds blocks at
# once, so the entry's blocks walk them grid-stride
SORTED_SYNTHETIC = {"no_refill": (5, 2, 0, 64), "one_row": (1, 3, 1, 64),
                    "cadence1": (40, 1, 30, 64), "cadence4": (12, 4, 9, 64),
                    "past_the_grid": (6, 1, 4, 2048)}


@pytest.mark.parametrize("case", ["window"] + list(SORTED_SYNTHETIC))
def test_sorted_queue_window_harvest_matches_plain(cuda, case):
    """One `queue` window with the lane coherence sort on the kernels: the
    sort on the card gives the CPU's permutation on every call's pool (bit
    for bit), and K7's unwinding entry (`perms`, one more count on
    `launches_rows_perm` a call) writes what `reverse_harvest_ref(perms=)`
    + `write_rows_ref` write, bit for bit, every started item once and
    nothing else; with identity `perms` it writes what K7 writes. The other
    cases run the entry on synthetic windows (`_sorted_synthetic_window`)."""
    if case in SORTED_SYNTHETIC:
        _sorted_synthetic_window(cuda, *SORTED_SYNTHETIC[case])
        return
    n, cad, depth = 64 * bounce.BLOCK, 4, 6
    scene, cam, tables, st, cam_row, bg, _ = _cornell(cuda, n)
    npix, sq, width = 360000, 10, 600
    total = 5 * n
    refill, window, outer = 12, 20, 5
    seeds = regen.window_seeds(5, 0, outer).to(cuda)
    kw = dict(width=width, sqrt_spp=sq, window=window, refill=refill,
              cadence=cad, max_depth=depth,
              max_contribution=cam.max_contribution)
    bounds = tuple(torch.from_numpy(b).to(cuda)
                   for b in bounce.coherence_bounds(scene))
    bufs = regen.SchedBuffers.empty(n, outer, cad, cuda, 3, reorder=True)
    acc = torch.full((total + n, 3), float("nan"), device=cuda)
    before = (bounce.launches_fused, harvest.launches_rows,
              harvest.launches_rows_perm)
    _, _, cur = regen._queue_window(
        tables, st, cam_row, bg, acc, regen._init_state(n, cuda),
        torch.tensor(0, device=cuda), seeds, 0, total, npix=npix, bufs=bufs,
        reorder=bounds, **kw)
    torch.cuda.synchronize()
    assert (bounce.launches_fused, harvest.launches_rows,
            harvest.launches_rows_perm) == (before[0] + outer, before[1],
                                            before[2] + 1)
    nxt = int(cur[0])
    rec = [r.view(outer, cad, n) for r in bufs.rec]
    hkw = dict(cadence=cad, refill_outer=3,
               max_contribution=cam.max_contribution)
    rows = harvest.reverse_harvest_ref(*rec, bufs.sts, perms=bufs.perm,
                                       **hkw)
    acc_p = torch.full_like(acc, float("nan"))
    harvest.write_rows_ref(acc_p, rows, bufs.nis, item_base=0, n_rows=3)
    assert not torch.isnan(acc[:nxt]).any()
    assert torch.equal(acc[:nxt], acc_p[:nxt])
    assert torch.isnan(acc[nxt:]).all()
    # the sort itself, card against CPU, on a pool in mid-flight
    pool = _cornell(cuda, n, seed=3)[6]
    outs = []
    for dev in (cuda, torch.device("cpu")):
        out = regen._init_state(n, dev)
        perm = torch.empty(n, dtype=torch.int32, device=dev)
        regen.coherence_sort([x.to(dev) for x in pool],
                             *(b.to(dev) for b in bounds), out, perm)
        outs.append([perm.cpu()] + [x.cpu() for x in out])
    for a, b in zip(*outs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    # identity perms: K7's output
    ident = torch.arange(n, dtype=torch.int32, device=cuda).repeat(outer, 1)
    acc_i = torch.full_like(acc, float("nan"))
    acc_k = torch.full_like(acc, float("nan"))
    harvest.reverse_harvest_into(acc_i, *rec, bufs.sts, bufs.nis,
                                 item_base=0, perms=ident, **hkw)
    harvest.reverse_harvest_into(acc_k, *rec, bufs.sts, bufs.nis,
                                 item_base=0, **hkw)
    torch.cuda.synchronize()
    assert torch.equal(acc_i[:nxt], acc_k[:nxt])
    assert torch.isnan(acc_i[nxt:]).all()


# ---------------------------------------------------------------------------
# K9-K12: the direct-record queue and the further mesh routes' kernels
# ---------------------------------------------------------------------------

def test_direct_rec_kernel_matches_k1_and_plain(cuda):
    """K9 at 131072 lanes: its rows at base 3 of a 12-row buffer equal K1's
    planes bit for bit (the same device code), the other rows keep their
    marker; against the plain version within K1's tolerances."""
    n, n_inner, base = 1 << 17, 8, 3
    _, _, tables, st, cam_row, bg, state = _cornell(cuda, n)
    seed4 = torch.tensor([-5, n_inner, 1000, 360000 * 100],
                         dtype=torch.int32, device=cuda)
    kw = dict(has_defocus=False, max_depth=50, n_inner=n_inner, width=600,
              sqrt_spp=10, npix=360000)
    k1 = bounce.bounce_fused_q(tables, st, cam_row, bg, seed4, *state, **kw)
    bufs = [torch.full((12, n), -7.5, device=cuda) for _ in range(3)] \
        + [torch.full((12, n), -9, dtype=torch.int32, device=cuda)]
    before = bounce.launches_direct
    k9 = bounce.bounce_fused_q_direct(
        tables, st, cam_row, bg, seed4,
        torch.tensor([base], dtype=torch.int32, device=cuda), bufs, *state,
        **kw)
    torch.cuda.synchronize()
    assert bounce.launches_direct == before + 1
    rows = slice(base, base + n_inner)
    for a, b in zip(bufs, k1[0]):
        assert torch.equal(a[rows], b)
        assert (a[:base] == a.new_tensor(-9 if a.dtype == torch.int32
                                         else -7.5)).all()
        assert (a[base + n_inner:] == a[0, 0]).all()
    assert torch.equal(k9[4], k1[2]) and torch.equal(k9[5], k1[3])
    assert all(torch.equal(a, b) for a, b in zip(k9[6:], k1[4:]))
    pbufs = [b.clone() for b in bufs]
    p = bounce.bounce_fused_q_direct_ref(
        tables, st, cam_row, bg, seed4,
        torch.tensor([base], dtype=torch.int32, device=cuda), pbufs, *state,
        **kw)
    assert p[5][0].item() == k9[5][0].item()
    fl_k, fl_p = bufs[3][rows], pbufs[3][rows]
    assert torch.equal(fl_k[0] & 4, fl_p[0] & 4)
    assert ((fl_k & 7) != (fl_p & 7)).float().mean() <= MISMATCH_FRAC
    agree = fl_k == fl_p
    for a, b in zip(bufs[:3], pbufs[:3]):
        off = ~torch.isclose(a[rows][agree], b[rows][agree], rtol=RTOL,
                             atol=ATOL, equal_nan=True)
        assert off.float().mean() <= MISMATCH_FRAC


def test_direct_rec_window_equals_plane_window(cuda):
    """One cornellBox window through K9 and through K1: the same records,
    bases, counts and accumulator, bit for bit."""
    scene, cam, tables, st, cam_row, bg, _ = _cornell(cuda, 8)
    n, cad, window = 1 << 15, 8, 64
    npix = 600 * 600
    res = []
    for direct in (False, True):
        bufs = regen.WindowBuffers.empty(n, window // cad, cad, cuda)
        for r in bufs.rec:
            r.zero_()
        acc = torch.zeros((npix * 100 + n, 3), device=cuda)
        _, _, cur = regen._window_impl(
            tables, st, cam_row, bg, acc, regen._init_state(n, cuda),
            torch.zeros(1, dtype=torch.int32, device=cuda),
            regen.window_seeds(0, 0, window // cad), 0, npix * 100,
            width=600, npix=npix, sqrt_spp=10, window=window, refill=40,
            cadence=cad, max_depth=50,
            max_contribution=cam.max_contribution, bufs=bufs,
            direct_rec=direct)
        torch.cuda.synchronize()
        ran = int(cur[2]) // cad          # count rows of the calls that ran
        res.append((cur.cpu(), [r.clone() for r in bufs.rec],
                    bufs.base[:ran].clone(), bufs.seg[:ran].clone(), acc))
    (c0, r0, b0, s0, a0), (c1, r1, b1, s1, a1) = res
    assert torch.equal(c0, c1) and torch.equal(b0, b1) and torch.equal(s0, s1)
    assert all(torch.equal(x, y) for x, y in zip(r0, r1))
    assert torch.equal(a0, a1)


def test_stream_round_kernel_matches_plain(cuda, scene8):
    """K10 on a sorted pool with random processed bits: t, idx, the next
    key and the bits equal the plain version's bit for bit; an empty
    block keeps its rays."""
    ms = trace.to_device(scene8[0], cuda)
    bvh = ms.tri_bvh
    n = 128 * stream.BLOCK
    o, d, cap, alive = _mesh_rays(cuda, n, 11)
    k_cl = bvh.cl_lo.shape[0]
    rs = np.random.default_rng(12)
    key = np.sort(rs.integers(0, k_cl, n))
    key[-5 * stream.BLOCK:] = k_cl
    kb = torch.from_numpy(key).to(cuda).view(-1, stream.BLOCK)
    first, last = kb[:, 0], torch.where(kb < k_cl, kb, -1).amax(dim=1)
    empty = last < 0
    gs = bvh.cl_gs.long()
    glo = torch.where(empty, 0, gs[first.clamp(0, k_cl - 1)]).int()
    ghi = torch.where(empty, 0, gs[last.clamp(0, k_cl - 1) + 1]).int()
    ca = torch.where(empty, 0, first).int()
    cb = last.int()
    masks = torch.from_numpy(rs.integers(
        -(1 << 31), 1 << 31, ((k_cl + 31) // 32, n)).astype(np.int32)).to(cuda)
    planes = [o[:, k].contiguous() for k in range(3)] \
        + [d[:, k].contiguous() for k in range(3)]
    t0 = torch.where(alive, cap, 0.0)
    idx0 = torch.full((n,), -1, dtype=torch.int32, device=cuda)
    args = (bvh.cl_lines, bvh.cl_lo, bvh.cl_hi, glo, ghi, ca, cb, *planes,
            t0, idx0, masks)
    before = stream.launches_round
    k = stream.stream_round_rows(*args)
    torch.cuda.synchronize()
    assert stream.launches_round == before + 1
    p = stream.stream_round_rows_ref(*args)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    assert (k[1] >= 0).sum() > 100 and (k[2] < k_cl).any()
    tail = slice(n - 5 * stream.BLOCK, n)
    assert torch.equal(k[3][:, tail], masks[:, tail])


def test_stream_round_kernel_on_uneven_ranges(cuda, scene8):
    """K10 on a pool whose blocks' group ranges are very uneven: one block
    spanning every cluster beside single-cluster blocks, blocks of two
    neighbouring clusters, empty blocks and sentinel rays: t, idx, the next
    key and the bits equal the plain version's bit for bit."""
    ms = trace.to_device(scene8[0], cuda)
    bvh = ms.tri_bvh
    k_cl = bvh.cl_lo.shape[0]
    blocks = 96
    n = blocks * stream.BLOCK
    o, d, cap, alive = _mesh_rays(cuda, n, 16)
    rs = np.random.default_rng(17)
    first = np.sort(rs.integers(0, k_cl - 1, blocks))
    last = first.copy()
    last[1::4] += 1                          # two neighbouring clusters
    first[0], last[0] = 0, k_cl - 1          # the whole table
    first[40], last[40] = 3, k_cl - 2        # most of it
    last[-6:] = -1                           # empty, sentinel rays
    empty = last < 0
    gs = bvh.cl_gs.long().cpu().numpy()
    to = lambda x: torch.from_numpy(np.ascontiguousarray(x)).int().to(cuda)
    glo = to(np.where(empty, 0, gs[first]))
    ghi = to(np.where(empty, 0, gs[np.clip(last, 0, None) + 1]))
    ca, cb = to(np.where(empty, 0, first)), to(last)
    masks = torch.from_numpy(rs.integers(
        -(1 << 31), 1 << 31, ((k_cl + 31) // 32, n)).astype(np.int32)).to(cuda)
    planes = [o[:, k].contiguous() for k in range(3)] \
        + [d[:, k].contiguous() for k in range(3)]
    args = (bvh.cl_lines, bvh.cl_lo, bvh.cl_hi, glo, ghi, ca, cb, *planes,
            torch.where(alive, cap, 0.0),
            torch.full((n,), -1, dtype=torch.int32, device=cuda), masks)
    before = stream.launches_round, stream.launches
    k = stream.stream_round_rows(*args)
    torch.cuda.synchronize()
    assert (stream.launches_round, stream.launches) == (before[0] + 1,
                                                         before[1])
    p = stream.stream_round_rows_ref(*args)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    assert (k[1][:stream.BLOCK] >= 0).sum() > 10 and (k[2] < k_cl).any()


@pytest.mark.parametrize("team", [1, 2, 4, 8])
def test_stream2_kernel_matches_plain(cuda, scene8, team, monkeypatch):
    """K11 on 20,480 coherence-sorted rays of the statue (capped, dead),
    with one, two, four or eight warps per unit: idx equal, t bit for bit, and
    every unit's rounds equal the plain version's."""
    monkeypatch.setattr(stream2, "TEAM", team)
    ms = trace.to_device(scene8[0], cuda)
    bvh = ms.tri_bvh
    n = 640 * stream2.UNIT
    o, d, cap, alive = _mesh_rays(cuda, n, 13)
    t0 = torch.where(alive, cap, 0.0)
    key = torch.where(t0 > 0, trace.coherence_key(bvh, o, d), 0x7FFFFFFF)
    perm = torch.sort(key).indices
    planes = [x[perm, k].contiguous() for x in (o, d) for k in range(3)]
    args = (bvh.cl2_lines, bvh.cl2_lo, bvh.cl2_hi, bvh.cl2_gs, *planes,
            t0[perm].contiguous(),
            torch.full((n,), -1, dtype=torch.int32, device=cuda))
    rounds = torch.zeros(n // stream2.UNIT, dtype=torch.int32, device=cuda)
    before = stream2.launches
    kt, ki = stream2.stream2_rows(*args, rounds=rounds)
    torch.cuda.synchronize()
    assert stream2.launches == before + 1
    work = {}
    pt, pi = stream2.stream2_rows_ref(*args, work=work)
    assert torch.equal(ki, pi) and torch.equal(kt, pt)
    assert torch.equal(rounds.long(), work["rounds"])
    assert (ki >= 0).sum() > 1000


def test_bvh_kernel_matches_plain(cuda, scene8):
    """K12 on the statue: idx equal and t bit for bit (one walk per ray in
    both); a dead lane keeps cap 0 and -1."""
    ms = trace.to_device(scene8[0], cuda)
    bvh = ms.tri_bvh
    o, d, cap, alive = _mesh_rays(cuda, 20000, 14)
    cap0 = torch.where(alive, cap, 0.0)
    before = traverse.launches
    kt, ki = traverse.bvh_closest(bvh.bvh_nodes, bvh.bvh_tris, o, d, cap0,
                                  n_nodes=bvh.n_nodes)
    torch.cuda.synchronize()
    assert traverse.launches == before + 1
    pt, pi = traverse.bvh_closest_ref(bvh.bvh_nodes, bvh.bvh_tris, o, d, cap0,
                                      n_nodes=bvh.n_nodes)
    assert torch.equal(ki, pi) and torch.equal(kt, pt)
    assert (ki >= 0).sum() > 1000 and (ki[~alive] == -1).all()


def _bvh_tables(v, leaf_size, dev):
    """The aligned K12 tables of a BVH over triangle vertices v (T, 3, 3)
    with leaves of at most `leaf_size`, on `dev`, and the node count."""
    from go_raytracer_tpu_torch.scene import bvh as bvh_mod
    fb = bvh_mod.build(v, leaf_size=leaf_size)
    vp = v[fb.order[:v.shape[0]]].astype(np.float32)
    rows = np.concatenate([fb.node_min, fb.node_max, np.stack(
        [fb.first, fb.count, fb.skip], axis=1)], axis=1).astype(np.float32)
    tris = np.concatenate([vp[:, 0], vp[:, 1] - vp[:, 0],
                           vp[:, 2] - vp[:, 0]], axis=1)
    nodes, tris = traverse.pack_tables(rows, tris)
    return (torch.from_numpy(nodes).to(dev), torch.from_numpy(tris).to(dev),
            fb.n_nodes)


@pytest.mark.parametrize("warp_rays,leaf_batch", [(32, 1), (32, 32),
                                                   (16, 8), (8, 2)])
@pytest.mark.parametrize("tree", ["statue", "partial16", "leaf40"])
def test_bvh_kernel_on_incoherent_rays(cuda, scene8, tree, warp_rays,
                                       leaf_batch, monkeypatch):
    """K12 on unsorted, incoherent rays (random origins and directions
    through the mesh, 30% capped, 10% dead, a lane count that is not a
    multiple of the block), with 32, 16 or 8 rays a warp and the walk
    phase ended at 1 to 32 held leaves: on the statue, on 3,001 random
    triangles with leaves of at most 16 (partial leaves, a partial last
    one) and with leaves of up to 40 (a leaf tested over two rows of 32
    lanes): idx equal and t bit for bit; and on the statue's
    coherence-sorted rays too."""
    monkeypatch.setattr(traverse, "LEAF_BATCH", leaf_batch)
    monkeypatch.setattr(traverse, "WARP_RAYS", warp_rays)
    if tree == "statue":
        bvh = trace.to_device(scene8[0], cuda).tri_bvh
        nodes, tris, n_nodes = bvh.bvh_nodes, bvh.bvh_tris, bvh.n_nodes
        v = None
    else:
        # tests/test_bvh.py's random_mesh (that file imports JAX)
        rs = np.random.default_rng(18)
        v = rs.uniform(-10, 10, (3001, 1, 3)) \
            + rs.uniform(-0.8, 0.8, (3001, 3, 3))
        nodes, tris, n_nodes = _bvh_tables(
            v, 16 if tree == "partial16" else 40, cuda)
    n = 20000 + 77
    rs = np.random.default_rng(19)
    scale = 8.0 if v is None else 12.0
    o = rs.uniform(-scale, scale, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    cap = np.where(rs.uniform(size=n) < 0.3, scale, np.inf)
    cap = np.where(rs.uniform(size=n) < 0.9, cap, 0.0).astype(np.float32)
    o, d, cap = (torch.from_numpy(x).to(cuda) for x in (o, d, cap))
    runs = [(o, d, cap)]
    if tree == "statue":
        perm = torch.sort(trace.coherence_key(bvh, o, d)).indices
        runs.append((o[perm].contiguous(), d[perm].contiguous(),
                     cap[perm].contiguous()))
    for o_, d_, cap_ in runs:
        before = traverse.launches
        kt, ki = traverse.bvh_closest(nodes, tris, o_, d_, cap_,
                                      n_nodes=n_nodes)
        torch.cuda.synchronize()
        assert traverse.launches == before + 1
        pt, pi = traverse.bvh_closest_ref(nodes, tris, o_, d_, cap_,
                                          n_nodes=n_nodes)
        assert torch.equal(ki, pi) and torch.equal(kt, pt)
        assert (ki >= 0).sum() > 1000


def test_five_routes_agree_on_card(cuda, scene8):
    """binned, binned + b1_fused, binned2, walk and walk on the binary BVH
    return the same winners and t on the card, each through its kernel."""
    ms = trace.to_device(scene8[0], cuda)
    o, d, cap, alive = _mesh_rays(cuda, 10000, 15)
    routes = [dict(mesh="binned"), dict(mesh="binned", b1_fused=True),
              dict(mesh="binned2"), dict(mesh="walk"),
              dict(mesh="walk", traverse8=False)]
    counts = (lambda: (stream.launches, stream.launches_round,
                       stream2.launches, traverse8.launches,
                       traverse.launches))
    ref = None
    for k, route in enumerate(routes):
        before = counts()
        t, i = trace.mesh_closest(ms, o, d, cap, alive, **route)
        torch.cuda.synchronize()
        grew = [b > a for a, b in zip(before, counts())]
        assert grew[k] and sum(grew) == 1, route
        if ref is None:
            ref = (t, i)
        assert torch.equal(i, ref[1]) and torch.equal(t, ref[0]), route


# simpleLight (marble noise) and book1 (checker, 389 spheres, glass,
# metal, defocus) and the fraction of the lanes each may flip; their new
# rays are counted over all lanes: on a random pool few lanes stay alive in
# both runs after 8 levels, and a ray that a rounding of the large ground
# sphere's f32 acne sent elsewhere is a large share of those
TEX_SCENES = {"simple_light": MISMATCH_FRAC, "book1": 5e-3}


@pytest.mark.parametrize("scene", TEX_SCENES)
def test_textured_scene_kernels_match_plain(cuda, scene):
    """K1, K6 and K8 at 512 blocks, 8 levels, on simpleLight and book1 at
    their registry camera (400 x 225, defocus on book1): K1's takes,
    starts, ranks and time plane exact; flags, alive bits and records
    beyond rtol = atol = 2e-3 on at most `frac` of the lanes, and so the
    alive lanes' new rays, counted over all lanes."""
    _dense_scene_kernels_match_plain(cuda, scene, TEX_SCENES[scene])


def _texel_moved(krec, prec, probe, weights, flags):
    """Lanes that took a texel in the plain version (its `probe`) and agree
    on the record planes `flags`, and among them those whose kernel weight
    (the record planes `weights`) is not the plain one to rtol 1e-4: the
    kernel read another texel (the two ratios agree to ~1e-6; neighbouring
    texels of 8-bit images differ by 1/255 at least, where they differ)."""
    img = torch.stack(probe) >= 0
    agree = img.clone()
    for f in flags:
        agree &= krec[f] == prec[f]
    moved = torch.zeros_like(agree)
    for c in weights:
        moved |= ~torch.isclose(krec[c], prec[c], rtol=1e-4, atol=0.0)
    return img, agree, moved & agree


def _dense_scene_kernels_match_plain(cuda, scene, frac, texel_frac=None):
    """K1, K6 and K8 at 512 blocks, 8 levels, on a registry scene at its
    camera: K1's takes, starts, ranks and time plane exact; flags, alive
    bits and records beyond rtol = atol = 2e-3 on at most `frac` of the
    lanes, and so the alive lanes' new rays, counted over all lanes. With
    `texel_frac` (a scene with image textures), each call's texels too
    (`_texel_moved`) at level 0, where both ran on the same rays: at
    least 100 image lanes, and on all but `texel_frac` of the image lanes
    whose flags agree the kernel's weight is the plain one to rtol 1e-4
    (the same texel and pdf ratio; chip_smoke.py tells the two apart)."""
    images = texel_frac is not None
    n, n_inner = 512 * bounce.BLOCK, 8
    scene, cam, tables, st, cam_row, bg, state = _cornell(cuda, n,
                                                          scene=scene)
    w, sq = cam.width, cam.spp_sqrt
    npix, dfc = w * cam.image_height, cam.defocus_angle > 0
    kw = dict(has_defocus=dfc, max_depth=50, n_inner=n_inner)

    def close(k, p, probe, weights, flags):
        krec, _, kseg, *kst = k
        prec, _, pseg, *pst = p
        assert kseg[0].item() == pseg[0].item()
        assert (kst[7] != pst[7]).float().mean() <= frac
        for a, b in zip(krec, prec):
            off = (a != b) if a.dtype == torch.int32 else ~torch.isclose(
                a, b, rtol=RTOL, atol=ATOL, equal_nan=True)
            assert off.float().mean() <= frac
        alive = (kst[7] > 0) & (pst[7] > 0)
        for a, b in zip(kst[:6], pst[:6]):
            off = ~torch.isclose(a[alive], b[alive], rtol=RTOL, atol=ATOL)
            assert off.float().sum().item() <= frac * n
        if images:
            img, agree, moved = _texel_moved(krec, prec, probe, weights,
                                             flags)
            assert img[0].sum().item() >= 100
            assert moved[0].sum().item() <= texel_frac * agree[0].sum().item()

    # (images) the queue from the middle row: quads' random rays miss it,
    # and its first rows see no image
    cursor = (cam.image_height // 2) * w if images else 0
    seed4 = torch.tensor([12345, 1, cursor, npix * 100], dtype=torch.int32,
                         device=cuda)
    qkw = dict(kw, width=w, sqrt_spp=sq, npix=npix)
    k = bounce.bounce_fused_q(tables, st, cam_row, bg, seed4, *state, **qkw)
    probe = []
    p = bounce.bounce_fused_q_ref(tables, st, cam_row, bg, seed4, *state,
                                  probe=probe, **qkw)
    torch.cuda.synchronize()
    assert torch.equal(k[3], p[3])
    assert torch.equal(k[0][3][0] & ~3, p[0][3][0] & ~3)
    assert torch.equal(k[4 + 6], p[4 + 6])
    assert _started_ranks_are_a_prefix(k[0][3], k[3])
    close((k[0], None, k[2], *k[4:]), (p[0], None, p[2], *p[4:]), probe,
          (0, 1, 2), (3,))
    refill = regen.queue_refill_planes(
        torch.tensor(cursor + 1000, device=cuda), state[7], npix * 100,
        width=w, npix=npix, sqrt_spp=sq)
    seed = torch.tensor([-123456789], dtype=torch.int32, device=cuda)
    probe = []
    close(bounce.bounce_fused(tables, st, cam_row, bg, seed, *state, *refill,
                              **kw),
          bounce.bounce_fused_ref(tables, st, cam_row, bg, seed, *state,
                                  *refill, probe=probe, **kw),
          probe, (0, 1, 2), (3,))
    rs = np.random.default_rng(3)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)
    # the columns next to the carries, or (images) every column: the edge
    # columns of quads and book2 see no image
    ptr = [to(rs.integers(0, w, n) if images
              else rs.choice([0, 7, w - 1], n)),
           to(rs.integers(0, cam.image_height - 1, n)),
           to(rs.choice([0, sq - 1], n)), to(rs.choice([0, 3, sq - 1], n)),
           to(rs.choice([0, 1, 2, 300], n))]
    seed2 = torch.tensor([24680, 5], dtype=torch.int32, device=cuda)
    pkw = dict(kw, width=w, sqrt_spp=sq)
    probe = []
    close(bounce.bounce_fused_pos(tables, st, cam_row, bg, seed2, *state,
                                  *ptr, **pkw),
          bounce.bounce_fused_pos_ref(tables, st, cam_row, bg, seed2, *state,
                                      *ptr, probe=probe, **pkw),
          probe, (3, 4, 5), (6, 7))


# quads (the earth map on a quad, marble, metal) and book2 (the earth map
# on a sphere, 1,006 spheres, 400 boxes, glass, two sphere media, marble).
# book2's marble sphere is ~900 units from the camera, where a root
# carries ~6e-4 units of float32 rounding, which its 7 turbulence octaves
# (x 10 inside the sine) turn into ~0.06 rad: chip_smoke.py measures
# 1.07e-2 of its records beyond the tolerance over 8 levels (IMG_MISMATCH
# _FRAC there), and 5.4e-3 of its lanes' alive bits apart here
IMG_SCENES = {"quads_scene": MISMATCH_FRAC, "book2": 2e-2}
# the image lanes whose weight may move at level 0, of those that agree on
# their flags: a texel or a light-pdf test one rounding apart (chip_smoke
# phase 24 measured quads 0 of 11,277, book2 52 of 12,477: 6 texels one
# column over, 46 pdf ratios, its earth sphere's roots at ~1,000 units)
TEXEL_FRAC = {"quads_scene": 1e-3, "book2": 1e-2}


@pytest.mark.parametrize("scene", IMG_SCENES)
def test_image_scene_kernels_match_plain(cuda, scene):
    """K1, K6 and K8 on quads and book2 against their plain versions, as
    on the textured scenes, and their texels."""
    _dense_scene_kernels_match_plain(cuda, scene, IMG_SCENES[scene],
                                     TEXEL_FRAC[scene])


# the synthetic scan scene (scenes/synthetic.py) at MAX_PRIMS rows: spheres
# past the kernels' staging budget, or quads past it; lambertian and metal
SCAN_SETS = {"spheres": (3500, 300, 296), "quads": (200, 1800, 2096)}


def _scan(dev, n, counts, seed=0):
    """The scan scene's tables, statics, camera row and background at this
    mix of rows, and a mixed lane state of rays among its primitives."""
    from go_raytracer_tpu_torch.scenes import synthetic as syn
    _, cam, tabs, st = syn.build(*counts, seed=seed, dielectric=False)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    state = [to(x) for x in syn.lane_state(n, seed + 1)]
    return (cam, tuple(to(t) for t in tabs), st,
            to(bounce.pack_camera(cam.derived())),
            to(np.asarray(syn.CAMERA["background"], np.float32)), state)


@pytest.mark.parametrize("mix", SCAN_SETS)
def test_staged_scan_kernels_match_plain_at_one_level(cuda, mix):
    """K1, K9, K6 and K8 on the scan scene at MAX_PRIMS rows (rows staged
    in shared memory, then rows read from global memory), 512 blocks, one
    level: the queue's outputs exact (takes, bases, cursor, the level-0
    count, the starts and their ranks); flag words, alive bits, depths,
    records and new rays within rtol = atol = 2e-3 on all but
    MISMATCH_FRAC of the lanes (a ray grazing an edge may take the other
    side: the kernel fuses multiply-adds); K9 equal to K1 bit for bit;
    the coincident pair's tie to the first row."""
    from go_raytracer_tpu_torch.scenes import synthetic as syn
    n = 512 * bounce.BLOCK
    cam, tables, st, cam_row, bg, state = _scan(cuda, n, SCAN_SETS[mix])
    assert st["n_sph"] + st["n_quad"] + st["n_box"] == bounce.MAX_PRIMS
    w, sq = cam.width, cam.spp_sqrt
    npix = w * cam.image_height
    qkw = dict(has_defocus=False, max_depth=50, n_inner=1, width=w,
               sqrt_spp=sq, npix=npix)
    seed4 = torch.tensor([-123456789, 1, 1000, npix * sq * sq],
                         dtype=torch.int32, device=cuda)
    k = bounce.FusedQOut.empty(n, 1, cuda)
    bounce.bounce_fused_q(tables, st, cam_row, bg, seed4, *state, out=k,
                          **qkw)
    torch.cuda.synchronize()
    p = bounce.FusedQOut.empty(n, 1, cuda)
    bounce.bounce_fused_q_ref(tables, st, cam_row, bg, seed4, *state, out=p,
                              **qkw)
    for a, b in ((k.take, p.take), (k.base, p.base), (k.seg, p.seg),
                 (k.cursor, p.cursor), (k.rec[3] & ~3, p.rec[3] & ~3)):
        assert torch.equal(a, b)
    for a, b in ((k.rec[3], p.rec[3]), (k.state[7], p.state[7]),
                 (k.state[8], p.state[8])):
        assert (a != b).float().mean() <= MISMATCH_FRAC
    for a, b in zip(k.rec[:3], p.rec[:3]):
        assert (~torch.isclose(a, b, rtol=RTOL, atol=ATOL, equal_nan=True)
                ).float().mean() <= MISMATCH_FRAC
    alive = (k.state[7] > 0) & (p.state[7] > 0)
    for a, b in zip(k.state[:6], p.state[:6]):
        assert (~torch.isclose(a[alive], b[alive], rtol=RTOL, atol=ATOL)
                ).float().sum() <= MISMATCH_FRAC * n
    fl0 = k.rec[3][0]
    emit = ((fl0 & 4) != 0) & ((fl0 & 2) != 0)
    v0 = torch.stack([k.rec[c][0] for c in range(3)], dim=1)
    first = (v0 == torch.tensor(syn.TIE_FIRST, device=cuda)).all(1)
    second = (v0 == torch.tensor(syn.TIE_SECOND, device=cuda)).all(1)
    assert int(first[emit].sum()) > 1000 and not second.any()
    bufs = [torch.zeros((3, n), device=cuda) for _ in range(3)] \
        + [torch.zeros((3, n), dtype=torch.int32, device=cuda)]
    base = torch.tensor([1], dtype=torch.int32, device=cuda)
    bounce.bounce_fused_q_direct(tables, st, cam_row, bg, seed4, base, bufs,
                                 *state, **qkw)
    assert all(torch.equal(b[1], r[0]) for b, r in zip(bufs, k.rec))
    seed = torch.tensor([-123456789], dtype=torch.int32, device=cuda)
    refill = regen.queue_refill_planes(
        torch.tensor(1000, device=cuda), state[7], npix * sq * sq, width=w,
        npix=npix, sqrt_spp=sq)
    rs = np.random.default_rng(4)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)
    ptr = [to(rs.integers(0, w, n)), to(rs.integers(0, w - 1, n)),
           to(rs.integers(0, sq, n)), to(rs.integers(0, sq, n)),
           to(rs.choice([0, 1, 2, 40], n))]
    seed2 = torch.tensor([24680, 1], dtype=torch.int32, device=cuda)
    kw = dict(has_defocus=False, max_depth=50, n_inner=1)
    for fn, ref, args in (
            (bounce.bounce_fused, bounce.bounce_fused_ref,
             (seed, *state, *refill)),
            (bounce.bounce_fused_pos, bounce.bounce_fused_pos_ref,
             (seed2, *state, *ptr))):
        extra = dict(width=w, sqrt_spp=sq) if fn is bounce.bounce_fused_pos \
            else {}
        kk = fn(tables, st, cam_row, bg, *args, **kw, **extra)
        torch.cuda.synchronize()
        pp = ref(tables, st, cam_row, bg, *args, **kw, **extra)
        _fused_close(kk, pp)


@pytest.mark.parametrize("mix", SCAN_SETS)
def test_staged_scan_bounce_kernel_matches_plain(cuda, mix):
    """K3 on the scan scene at MAX_PRIMS rows, one bounce from given
    uniforms: alive and clamp flags, E, W and the scattered rays within
    rtol = atol = 2e-3 on all but K3's fraction of the lanes (1e-3, as
    chip_smoke holds K3)."""
    n = 256 * bounce.BLOCK
    _, tables, st, _, bg, state = _scan(cuda, n, SCAN_SETS[mix], seed=5)
    o = torch.stack(state[:3], dim=1).contiguous()
    d = torch.stack(state[3:6], dim=1).contiguous()
    alive = state[7] > 0
    u = torch.from_numpy(np.random.default_rng(6).uniform(
        0, 1, (n, bounce.N_U)).astype(np.float32)).to(cuda)
    k = bounce.bounce(tables, st, o, d, state[6], alive, u, bg)
    torch.cuda.synchronize()
    p = bounce.bounce_ref(tables, st, o, d, state[6], alive, u, bg)
    frac = 1e-3
    assert (k[5] != p[5]).float().mean() <= frac
    assert (k[2] != p[2]).float().mean() <= frac
    for a, b in zip(k[:2], p[:2]):
        assert (~torch.isclose(a, b, rtol=RTOL, atol=ATOL, equal_nan=True)
                ).any(-1).float().mean() <= frac
    go = k[5] & p[5]
    for a, b in zip(k[3:5], p[3:5]):
        assert (~torch.isclose(a[go], b[go], rtol=RTOL, atol=ATOL)
                ).any(-1).float().sum() <= frac * n


def test_staged_scan_keeps_four_blocks_per_sm(cuda):
    """Every fused variant keeps 4 resident blocks per SM with its staged
    geometry, on the seven dense registry scenes and on the scan scene at
    MAX_PRIMS rows; the staged bytes stay within the budget
    (bounce.STAGE_BYTES, csrc/bounce_core.cuh)."""
    from go_raytracer_tpu_torch.ops import _cuda
    from go_raytracer_tpu_torch.scenes import synthetic as syn
    statics = [bounce.scene_statics(getattr(registry, sc)()[0])
               for sc in ("cornell_box", "book3", "cornell_smoke",
                          "simple_light", "book1", "quads_scene", "book2")]
    statics += [syn.build(*c, dielectric=False)[3]
                for c in SCAN_SETS.values()]
    for st in statics:
        for lib in ("bounce_fused_q", "bounce_fused", "bounce_fused_pos"):
            info = _cuda.kernel_info(lib, bounce.fused_features(st),
                                     st["n_sph"], st["n_quad"], st["n_box"])
            assert info["blocks_per_sm"] >= 4
            assert 0 < info["dynamic_smem"] <= bounce.STAGE_BYTES


@pytest.mark.parametrize("scene", ["book1", "scan_spheres"])
def test_staged_scan_cull_changes_no_winner(cuda, scene):
    """The cull on the card (book1's 389 spheres in 49 blocks; the scan
    scene's 3,500 spheres, 300 quads and 296 boxes, past the staging
    budget): the kernels' outputs on a table whose every 13th sphere row
    from the sixth is
    cleared to kind -1 equal those on a table with the same rows moved
    straight below the ground sphere, 1e6 down, bit for bit, at one level
    and at 8 (a moved row stretches its block's bounds, so the two tables
    cull different blocks; a skipped block or a cleared row decides
    nothing). chip_smoke.py phase 23 holds the same at 131,072 lanes."""
    n = 512 * bounce.BLOCK
    if scene == "book1":
        _, cam, tables, st, cam_row, bg, state = _cornell(cuda, n,
                                                          scene="book1")
    else:
        cam, tables, st, cam_row, bg, state = _scan(cuda, n,
                                                    SCAN_SETS["spheres"])
    w, sq = cam.width, cam.spp_sqrt
    npix = w * cam.image_height
    rows = torch.arange(st["sph_base"] + 5, st["sph_base"] + st["n_sph"], 13,
                        device=cuda)
    cleared = tables[0].clone()
    cleared[rows] = -1.0
    moved = tables[0].clone()
    moved[rows, 1:4] = torch.tensor([0.0, -1e6, 0.0], device=cuda)
    moved[rows, 4:7] = 0.0
    seed4 = torch.tensor([77, 1, 0, npix * sq * sq], dtype=torch.int32,
                         device=cuda)
    for levels in (1, 8):
        qkw = dict(has_defocus=cam.defocus_angle > 0, max_depth=50,
                   n_inner=levels, width=w, sqrt_spp=sq, npix=npix)
        outs = []
        for t in (cleared, moved):
            o = bounce.FusedQOut.empty(n, levels, cuda)
            bounce.bounce_fused_q((t,) + tables[1:], st, cam_row, bg, seed4,
                                  *state, out=o, **qkw)
            outs.append([x.view(torch.int32) if x.is_floating_point() else x
                         for x in (*o.rec, o.seg, o.take, o.base, o.cursor,
                                   *o.state)])
        for a, b in zip(*outs):
            assert torch.equal(a, b)

# ---------------------------------------------------------------------------
# the mesh window's level glue (ops/mesh_level) and its graphed window
# ---------------------------------------------------------------------------

def _level_pool(dev, n, seed):
    """A `MeshLevel` on `dev` with a mixed lane pool (60% alive, depths up
    to 8) and a level's uniforms, and a bounce's outputs (NaN emissions
    among them), from numpy."""
    from go_raytracer_tpu_torch.ops import mesh_level
    rs = np.random.default_rng(seed)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    lv = mesh_level.MeshLevel.empty(n, 16, 9, dev)
    lv.begin([to(rs.normal(size=(n, 3)).astype(np.float32)),
              to(rs.normal(size=(n, 3)).astype(np.float32)),
              to(rs.random(n).astype(np.float32)), to(rs.random(n) < 0.6),
              to(rs.integers(0, 9, n).astype(np.int32))], 0)
    lv.u_cam.copy_(to(rs.random((n, 5)).astype(np.float32)))
    emit = rs.random(n) < 0.3
    E = np.where(emit[:, None], rs.random((n, 3)) * 4, 0.0).astype(np.float32)
    E[rs.random(n) < 0.01, 2] = np.nan
    W = np.where(emit[:, None], 0.0, rs.random((n, 3))).astype(np.float32)
    bounce_res = (to(E), to(W), to(rs.random(n) < 0.5),
                  to(rs.normal(size=(n, 3)).astype(np.float32)),
                  to(rs.normal(size=(n, 3)).astype(np.float32)),
                  to(rs.random(n) < 0.7))
    return lv, bounce_res


def _clone_level(lv):
    import dataclasses
    return dataclasses.replace(lv, **{f.name: getattr(lv, f.name).clone()
                                      for f in dataclasses.fields(lv)})


@pytest.mark.parametrize("scene", ["modelExample", "cornellBox"])
def test_mesh_level_glue_matches_plain(cuda, scene):
    """The glue kernel's two entries against their plain versions on the
    same mixed pool, bit for bit: 32,768 lanes (128 blocks, so a lane's
    rank sums the dead lanes of many blocks before it), at a level that
    refills across item_end (half the dead lanes take), then at one past
    the refill; defocus on (modelExample) and off (cornellBox)."""
    from go_raytracer_tpu_torch.ops import mesh_level
    _, cam = registry.get_scene(scene)[1]()
    n = 128 * mesh_level.BLOCK
    lv, res = _level_pool(cuda, n, seed=len(scene))
    arrays = cam.derived().to(cuda)
    cam_row = mesh_level.pack_camera(arrays, cuda)
    npix = cam.width * cam.image_height
    n_dead = int((~lv.alive).sum())
    item_end = npix * cam.spp_sqrt ** 2
    glue = dict(item_end=item_end, refill=6, cadence=1, width=cam.width,
                npix=npix, sqrt_spp=cam.spp_sqrt)
    as_bits = lambda x: x.view(torch.int32) if x.is_floating_point() else x
    for s in (5, 6):
        lv.lvl.fill_(s)
        lv.cnt[s, mesh_level.CURSOR] = item_end - n_dead // 2
        lp = _clone_level(lv)
        base_k = torch.full((16,), -1, dtype=torch.int32, device=cuda)
        base_p = base_k.clone()
        rec_k = [torch.full((16, n), -3.0, device=cuda) for _ in range(3)] \
            + [torch.full((16, n), -3, dtype=torch.int32, device=cuda)]
        rec_p = [r.clone() for r in rec_k]
        launches = mesh_level.launches_refill, mesh_level.launches_record
        mesh_level.refill(lv, arrays, cam_row, base_k, **glue)
        mesh_level.refill_ref(lp, arrays, cam_row, base_p, **glue)
        takes = int(lv.cnt[s + 1, mesh_level.TAKES])
        assert takes == (n_dead // 2 if s == 5 else 0)
        mesh_level.record(lv, rec_k, *res, max_depth=cam.max_depth)
        mesh_level.record_ref(lp, rec_p, *res, max_depth=cam.max_depth)
        torch.cuda.synchronize()
        assert (mesh_level.launches_refill, mesh_level.launches_record) == (
            launches[0] + 1, launches[1] + 1)
        for a, b in zip(lv.state + [lv.start, lv.cnt, lv.lvl, base_k]
                        + rec_k, lp.state + [lp.start, lp.cnt, lp.lvl,
                                             base_p] + rec_p):
            assert torch.equal(as_bits(a), as_bits(b))
        lv.alive.copy_(torch.rand(n, device=cuda) < 0.6)


@pytest.mark.parametrize("route", ["walk", "binned2"])
def test_mesh_window_graph_matches_eager(cuda, scene8, route, monkeypatch):
    """One scene-8 window (48x27, 16 spp, depth 50, 8,192 lanes, 60
    levels, refill 40) replayed as a CUDA graph against the same window
    run eagerly on the glue's plain versions, from the same state, seed
    and cursor (the state of an earlier window, lanes mid-path): records,
    bases, accumulator, cursor, segments and levels recorded bit for
    bit, and the graph's levels counted in every kernel's launches."""
    from go_raytracer_tpu_torch.ops import mesh_level
    scene, cam = scene8
    cam.width, cam.samples_per_pixel = 48, 16
    n, window, refill = 8192, 60, 40
    npix = cam.width * cam.image_height
    total = npix * cam.spp_sqrt ** 2
    kw = dict(width=cam.width, npix=npix, sqrt_spp=cam.spp_sqrt,
              window=window, refill=refill, max_depth=cam.max_depth,
              max_contribution=cam.max_contribution)
    ctx_g = regen.MeshContext.build(scene, cam, cuda, mesh=route)
    ctx_e = regen.MeshContext.build(scene, cam, cuda, mesh=route)
    assert ctx_g.graph and ctx_e.graph
    ctx_e.graph = False
    plain = dict(refill=mesh_level.refill_ref, record=mesh_level.record_ref)
    kernel = dict(refill=mesh_level.refill, record=mesh_level.record)

    def glue(fns):
        for name, fn in fns.items():
            monkeypatch.setattr(mesh_level, name, fn)

    # an earlier window leaves lanes mid-path
    glue(plain)
    bufs0 = regen.WindowBuffers.empty(n, 7, 1, cuda)
    state0, cur0, _ = regen._mesh_window(
        ctx_e, torch.zeros((total + n, 3), device=cuda),
        regen._init_state_mesh(n, cuda), 0,
        regen.window_generator(5, 0, cuda), total,
        **dict(kw, window=7, refill=7), bufs=bufs0)
    state0 = [s.clone() for s in state0]
    assert 0 < int(state0[3].sum()) < n
    outs = {}
    for name, ctx in (("graph", ctx_g), ("eager", ctx_e)):
        glue(kernel if ctx.graph else plain)
        bufs = regen.WindowBuffers.empty(n, window, 1, cuda)
        for r in bufs.rec:
            r.zero_()
        acc = torch.zeros((total + n, 3), device=cuda)
        k3 = bounce.launches_bounce
        st, cur, n_run = regen._mesh_window(
            ctx, acc, [s.clone() for s in state0], cur0[0],
            regen.window_generator(5, 1, cuda), total, bufs=bufs, **kw)
        torch.cuda.synchronize()
        outs[name] = (bufs, acc, cur, n_run, bounce.launches_bounce - k3)
    (bg, ag, cg, ng, kg), (be, ae, ce, ne, ke) = outs["graph"], outs["eager"]
    assert ctx_g.levels.graph is not None and ctx_e.levels.graph is None
    assert torch.equal(cg, ce) and int(cg[0]) > int(cur0[0])
    levels = int(cg[2])
    assert 0 < levels <= min(ng, ne)
    for a, b in zip(bg.rec + [bg.base], be.rec + [be.base]):
        assert torch.equal(a[:levels], b[:levels])
    assert torch.equal(ag, ae)
    # K3 once a level run, in the graph's replays as in the eager levels
    assert kg == ng and ke == ne
    assert ctx_g.counters["mesh_calls"] == ng
    assert ctx_g.counters["replays"] == ng - 1


# the reference engine's levels and the train step as CUDA graphs


def _camera_rays(scene_name, dev, n, seed=0):
    """(device scene, camera, n camera rays o, d, t) of a registry scene."""
    from go_raytracer_tpu_torch.render import camera as camera_mod
    scene, cam = getattr(registry, scene_name)()
    g = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, cam.width * cam.image_height, (n,), device=dev,
                        generator=g)
    s = torch.zeros(n, device=dev)
    u = torch.rand((n, camera_mod.N_U_RAYGEN), generator=g, device=dev)
    return (scene, cam, *camera_mod.generate_rays(
        cam.derived().to(dev), cam.width, ids, s, s, u))


@pytest.mark.parametrize("name,backend,mode", [
    ("cornell_box", "auto", "while"), ("cornell_box", "xla", "while"),
    ("model_example", "xla", "scan")])
def test_radiance_graph_matches_eager(cuda, name, backend, mode):
    """`wavefront.radiance` with every level a CUDA graph replay against
    the same call run eagerly (graph=False) on the same rays and seeds,
    three calls each (the first runs level 0 eagerly and captures the
    level, the second captures the combine): L, segments and levels
    recorded bit for bit, and the generators left at the same offset
    (a "while" call moves on as if it had drawn every level, wherever it
    saw the drain). K3 (cornellBox "auto") or K5 (modelExample) runs once
    a level run, in the graph's replays as eagerly."""
    from go_raytracer_tpu_torch.integrator import wavefront
    scene, cam, o, d, t = _camera_rays(name, cuda, 65536)
    ds_g, ds_e = trace.to_device(scene, cuda), trace.to_device(scene, cuda)
    depth = 10 if mode == "scan" else cam.max_depth
    for call in range(3):
        out = {}
        for tag, ds, graph in (("graph", ds_g, None), ("eager", ds_e, False)):
            gen = torch.Generator(device=cuda).manual_seed(20 + call)
            k3, k5 = bounce.launches_bounce, traverse8.launches
            L, st = wavefront.radiance(ds, o, d, t, gen, depth,
                                       cam.max_contribution, mode=mode,
                                       backend=backend, graph=graph)
            torch.cuda.synchronize()
            kernel = (bounce.launches_bounce - k3 if backend == "auto"
                      else traverse8.launches - k5)
            out[tag] = (L, st, gen.get_offset(), kernel)
        (Lg, sg, og, kg), (Le, se, oe, ke) = out["graph"], out["eager"]
        assert sg["graph"] and not se["graph"]
        assert torch.equal(Lg, Le) and og == oe
        assert int(sg["segments"]) == int(se["segments"]) > 0
        assert int(sg["levels"]) == int(se["levels"])
        if backend == "auto" or name == "model_example":
            assert kg == sg["levels_run"] and ke == se["levels_run"]
    assert ds_g.engine["levels"].level is not None \
        and ds_g.engine["levels"].combine is not None


def test_radiance_graph_replays_draw_new_uniforms(cuda):
    """Two graphed calls on one continuing generator read new uniforms
    (a frozen draw would render the same noise twice); a third call on
    the first seed again gives the first call's bits."""
    from go_raytracer_tpu_torch.integrator import wavefront
    scene, cam, o, d, t = _camera_rays("cornell_box", cuda, 16384, seed=2)
    ds = trace.to_device(scene, cuda)
    gen = torch.Generator(device=cuda).manual_seed(8)
    L = []
    for _ in range(3):
        L.append(wavefront.radiance(ds, o, d, t, gen, 8,
                                    cam.max_contribution, backend="xla")[0])
    us = ds.engine["levels"].u.clone()
    L.append(wavefront.radiance(ds, o, d, t, gen, 8, cam.max_contribution,
                                backend="xla")[0])
    assert ds.engine["levels"].level is not None
    assert not torch.equal(L[1], L[2]) and not torch.equal(L[2], L[3])
    assert not torch.equal(us, ds.engine["levels"].u)
    again = wavefront.radiance(
        ds, o, d, t, torch.Generator(device=cuda).manual_seed(8), 8,
        cam.max_contribution, backend="xla")[0]
    assert torch.equal(again, L[0])


def test_train_step_graph_matches_eager(cuda):
    """`make_train_step` as one CUDA graph (the first step eager on a side
    stream, the second captured, the rest replayed) against the eager
    step on the same generator seed, five steps on cornellBox at 32x32, 4
    batches, depth 6: losses within 1e-6 relative; each leaf within
    3.1e-6 of its largest entry (the backward's atomic scatter-adds add
    in another order); the loss falls; a step given other params
    raises."""
    from go_raytracer_tpu_torch.parallel import mesh as pmesh
    scene, cam = registry.cornell_box()
    cam.width, cam.aspect_ratio, cam.max_depth = 32, 1.0, 6
    npix = 32 * 32
    ids = pmesh.pixel_ids(npix, 4, cuda)
    target = torch.full((npix, 3), 0.3, device=cuda)
    runs = {}
    for graph in (True, False):
        step, params, _ = pmesh.make_train_step(
            scene, cam, n_rays=npix, n_sample_batches=4, max_depth=6,
            learning_rate=0.05, device=cuda, graph=graph,
            generator=torch.Generator(device=cuda).manual_seed(3))
        losses = [step(params, ids, target) for _ in range(5)]
        runs[graph] = (losses, params)
        if graph:
            with pytest.raises(ValueError):
                step(dict(params, fuzz=params["fuzz"].clone()), ids, target)
    (lg, pg), (le, pe) = runs[True], runs[False]
    assert np.allclose(lg, le, rtol=1e-6, atol=0) and lg[-1] < lg[0]
    for k in pg:
        scale = float(pe[k].detach().abs().max()) or 1.0
        assert float((pg[k] - pe[k]).abs().max()) <= 3.1e-6 * scale, k


def test_unfused_window_graph_matches_eager(cuda):
    """regen's unfused window on the reference engine's bounce (`--backend
    xla`) with every level a CUDA graph against the same render run
    eagerly: cornellBox and lanternhouse (triangle lights, no triangle
    BVH), the same image and segments bit for bit."""
    for scene, cam in (registry.cornell_box(),
                       registry.model_example(
                           obj_path="assets/lanternhouse.obj")):
        cam.width, cam.samples_per_pixel, cam.max_depth = 48, 4, 8
        img_g, st_g = regen.render_regen(scene, cam, n_lanes=4096,
                                         backend="xla", device=cuda)
        img_e, st_e = regen.render_regen(scene, cam, n_lanes=4096,
                                         backend="xla", device=cuda,
                                         graph=False)
        assert st_g["graph"] and not st_e["graph"]
        assert st_g["bounce"] == "wavefront"
        assert np.array_equal(img_g, img_e)
        assert st_g["segments"] == st_e["segments"] > 0
