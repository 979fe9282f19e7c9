"""The lane coherence sort (`reorder=True`) on the port's fused `queue`
schedule, on the CPU (the kernels' plain versions), against the JAX
package: the Morton box and the permutation bit for bit, the harvest's
unwinding against JAX's lane sort and path for path under random
relabelling, one cornellBox window against JAX's sorted window, the
renders of tests/test_regen.py's reorder tests, and the resolution and
refusals of `render_regen(reorder=...)`.

The K7 variant that unwinds the sort on the card is held to its plain
version in tests/test_torch_cuda.py (marked `gpu`) and chip_smoke.py."""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_raytracer_tpu.integrator import regen as jregen
from go_raytracer_tpu.ops.pallas import bounce as jpb
from go_raytracer_tpu.scene.builder import SceneBuilder as JSceneBuilder
from go_raytracer_tpu.scenes import registry as jreg
from go_raytracer_tpu_torch.integrator import regen
from go_raytracer_tpu_torch.ops import bounce as tpb
from go_raytracer_tpu_torch.ops import harvest as tph
from go_raytracer_tpu_torch.render.camera import Camera
from go_raytracer_tpu_torch.scene import types as TT
from go_raytracer_tpu_torch.scene.builder import SceneBuilder
from go_raytracer_tpu_torch.scenes import registry

torch.set_num_threads(2)


def empty_scene(bg=(1.0, 1.0, 1.0), builder=SceneBuilder):
    """tests/test_regen.py's all-miss scene: a sphere and a light quad far
    behind the camera."""
    b = builder(background=bg)
    m = b.lambertian((0.5, 0.5, 0.5))
    b.sphere((0, 0, 1e8), 1.0, m)
    b.add_light(b.quad((0, 0, 1e8), (1, 0, 0), (0, 1, 0),
                       b.diffuse_light((1, 1, 1))))
    return b.build()


def mirror_corridor():
    """tests/test_regen.py's deterministic corridor: camera -> mirror A ->
    mirror B -> an emissive wall, exactly (2, 3, 4) at depth 2."""
    b = SceneBuilder(background=(0, 0, 0))
    mirror = b.metal((1.0, 1.0, 1.0), 0.0)
    b.quad((-2, -1.41421356, -0.58578644), (4, 0, 0),
           (0, 2.82842712, -2.82842712), mirror)
    b.quad((-1.41421356, 0.58578644, 0), (0, 0, -4),
           (2.82842712, 2.82842712, 0), mirror)
    b.add_light(b.quad((5, 0, -4), (0, 0, 4), (0, 4, 0),
                       b.diffuse_light((2, 3, 4))))
    return b.build()


def moving_scene():
    """A moving sphere, a hollow one (negative radius), a slanted quad and
    a rotated, offset box: every term of the three kinds' boxes."""
    from go_raytracer_tpu.scene.builder import Transform

    b = JSceneBuilder(background=(0.5, 0.7, 1.0))
    m = b.lambertian((0.5, 0.5, 0.5))
    b.sphere((1.0, 2.0, 3.0), 0.75, m, center2=(1.5, 2.5, 2.0))
    b.sphere((-4.0, 1.0, 0.5), -0.5, b.dielectric(1.5))
    b.quad((-3, -1, -2), (6, 0.5, 0), (0, 0, 4), m)
    b.box((-1, 0, -1), (1, 2, 1), m, transform=Transform(30.0, (2, 0, -3)))
    b.add_light(b.quad((0, 5, 0), (1, 0, 0), (0, 0, 1),
                       b.diffuse_light((4, 4, 4))))
    return b.build()


# ----------------------------------------------------------- the Morton box

BOUND_SCENES = ("cornell_box", "book1", "book2", "book3", "cornell_smoke",
                "simple_light", "quads_scene", "moving", "empty")


def _jax_scene(name):
    if name == "moving":
        return moving_scene()
    if name == "empty":
        return empty_scene(builder=JSceneBuilder)
    return getattr(jreg, name)()[0]


@pytest.mark.parametrize("name", BOUND_SCENES)
def test_coherence_bounds_match_jax(name):
    """blo and bext as the JAX window computes them from
    `pack_scene(scene, cull=True)`'s block table (integrator/regen.py
    there: `blo = min(blk[:, 0:3])`, `bext = max(max(blk[:, 3:6]) - blo,
    1e-6)`), bit for bit."""
    js = _jax_scene(name)
    blk = jpb.pack_scene(js, cull=True)[3]
    jlo = jnp.min(blk[:, 0:3], axis=0)
    jext = jnp.maximum(jnp.max(blk[:, 3:6], axis=0) - jlo, 1e-6)
    blo, bext = tpb.coherence_bounds(TT.scene_from_numpy(js))
    assert blo.dtype == bext.dtype == np.float32
    np.testing.assert_array_equal(blo, np.asarray(jlo))
    np.testing.assert_array_equal(bext, np.asarray(jext))


def test_coherence_bounds_without_dense_primitives():
    """No sphere, quad or box: the JAX block table is its one zero row, so
    blo is 0 and bext 1e-6."""
    ts = TT.scene_from_numpy(empty_scene(builder=JSceneBuilder))
    ts = dataclasses.replace(ts, has_spheres=False, has_quads=False,
                             has_boxes=False)
    blo, bext = tpb.coherence_bounds(ts)
    np.testing.assert_array_equal(blo, np.zeros(3, np.float32))
    np.testing.assert_array_equal(bext, np.full(3, 1e-6, np.float32))


# ----------------------------------------------------------- the permutation

def _jax_coherence_sort(planes, item_id, blo, bext):
    """The JAX window's `coherence_sort` (integrator/regen.py there), its
    calls as they stand: `_morton30` of the origin, the octant, dead lanes
    last, one sort by (key, iota) of every state plane."""
    ox, oy, oz, dx, dy, dz, t, alive, depth = (jnp.asarray(p) for p in planes)
    alive = alive != 0
    n = ox.shape[0]
    morton = jpb._morton30(jnp.stack([ox, oy, oz], axis=-1), jnp.asarray(blo),
                           jnp.asarray(bext))
    octant = ((dx > 0).astype(jnp.int32) << 2) \
        | ((dy > 0).astype(jnp.int32) << 1) | (dz > 0).astype(jnp.int32)
    key = (octant << 27) | (morton >> 3)
    key = jnp.where(alive, key, jnp.int32(0x7FFFFFFF))
    iota = jnp.arange(n, dtype=jnp.int32)
    out = jax.lax.sort(
        (key, iota, iota, ox, oy, oz, dx, dy, dz, t, alive.astype(jnp.int32),
         jnp.asarray(item_id), depth),
        dimension=0, num_keys=2, is_stable=False)
    return np.asarray(out[2]), [np.asarray(x) for x in out[3:]]


def _pool(case, n, rs):
    """Nine state planes (numpy) of a test pool and the scene's box."""
    cb = tpb.coherence_bounds(TT.scene_from_numpy(jreg.cornell_box()[0]))
    if case == "aged_cornell":
        return _aged_cornell(n), cb
    o = rs.uniform(-50, 600, (3, n)).astype(np.float32)
    d = rs.normal(size=(3, n)).astype(np.float32)
    alive = (rs.uniform(size=n) < 0.7).astype(np.int32)
    if case == "one_cell":
        # every lane in one of two Morton cells: the lane order breaks
        # the ties
        o = np.where(rs.uniform(size=(1, n)) < 0.5, 100.25, 300.5) \
            .astype(np.float32) * np.ones((3, 1), np.float32)
        d = np.abs(d)
    elif case == "zero_dir":
        d[rs.uniform(size=(3, n)) < 0.4] = 0.0
        d[0, :17] = -0.0
    planes = [o[0], o[1], o[2], d[0], d[1], d[2],
              rs.uniform(0, 1, n).astype(np.float32), alive,
              rs.integers(0, 50, n).astype(np.int32)]
    return planes, cb


def _aged_cornell(n):
    """cornellBox's pool after four `queue` calls of two levels: camera
    rays, bounced rays and dead lanes."""
    scene, cam = registry.cornell_box()
    tables = tuple(torch.from_numpy(t) for t in tpb.pack_scene(scene))
    statics = tpb.scene_statics(scene)
    cam_row = torch.from_numpy(tpb.pack_camera(cam.derived()))
    bg = torch.from_numpy(np.asarray(scene.background, np.float32))
    state = regen._init_state(n, "cpu")
    nxt = torch.tensor(300 * 600)     # the image's middle rows
    for i in range(4):
        rp = regen.queue_refill_planes(nxt, state[7], 360000 * 100, width=600,
                                       npix=360000, sqrt_spp=10)
        nxt = nxt + rp[0].sum()
        out = tpb.bounce_fused(tables, statics, cam_row, bg,
                               torch.tensor([977 * i + 5], dtype=torch.int32),
                               *state, *rp, has_defocus=False, max_depth=50,
                               n_inner=2)
        state = [x.clone() for x in out[3:]]
    alive = state[7]
    assert 0 < int(alive.sum()) < n
    return [x.numpy() for x in state]


@pytest.mark.parametrize("case", ["random", "one_cell", "zero_dir",
                                  "aged_cornell"])
def test_coherence_sort_matches_jax(case):
    """The port's `coherence_sort` against the JAX window's, bit for bit:
    the permutation and every gathered plane (floats compared as bits)."""
    n = 1024
    rs = np.random.default_rng({"random": 1, "one_cell": 2, "zero_dir": 3,
                                "aged_cornell": 4}[case])
    planes, (blo, bext) = _pool(case, n, rs)
    item_id = rs.integers(0, 1 << 20, n).astype(np.int32)
    jperm, jout = _jax_coherence_sort(planes, item_id, blo, bext)
    state = [torch.from_numpy(np.ascontiguousarray(p)) for p in planes]
    out = regen._init_state(n, "cpu")
    perm = torch.empty(n, dtype=torch.int32)
    got = regen.coherence_sort(state, torch.from_numpy(blo),
                               torch.from_numpy(bext), out, perm)
    assert got is out
    np.testing.assert_array_equal(perm.numpy(), jperm)
    if case == "one_cell":
        # a stable order: within a cell, lanes keep their order
        keys = regen.coherence_keys(state, torch.from_numpy(blo),
                                    torch.from_numpy(bext)).numpy()
        assert len(np.unique(keys[planes[7] != 0])) <= 2
    mine = [x.numpy() for x in out]
    want = jout[:8] + [jout[9]]       # JAX's planes without the item id
    for a, b in zip(mine, want):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    np.testing.assert_array_equal(item_id[perm.numpy()], jout[8])


def test_unwinding_equals_jax_lane_sort():
    """The JAX harvest unwinds a row with `lax.sort((perm, L), num_keys=1)`
    (integrator/regen.py there, `rev_outer`); the port's plain harvest with
    `L_prev[perm] = L`. A two-row window whose row 1 emits V at every lane
    and whose row 0 passes L through and starts every lane harvests L_prev
    in row 0's lane order: it equals JAX's sort."""
    n = 512
    rs = np.random.default_rng(9)
    perm = rs.permutation(n).astype(np.int32)
    V1 = rs.uniform(0.0, 2.0, (3, n)).astype(np.float32)
    _, *jl = jax.lax.sort((jnp.asarray(perm),) + tuple(
        jnp.asarray(V1[c]) for c in range(3)), dimension=0, num_keys=1,
        is_stable=False)
    V = np.ones((3, 2, 1, n), np.float32)
    V[:, 1, 0] = V1
    FL = np.zeros((2, 1, n), np.int32)
    FL[1, 0] = 2
    STs = np.zeros((2, n), np.int32)
    STs[0] = 1
    perms = np.stack([np.arange(n, dtype=np.int32), perm])
    rows = tph.reverse_harvest_ref(
        *(torch.from_numpy(V[c]) for c in range(3)), torch.from_numpy(FL),
        torch.from_numpy(STs), cadence=1, refill_outer=1,
        max_contribution=1e30, perms=torch.from_numpy(perms))
    for c in range(3):
        np.testing.assert_array_equal(rows[c][0].numpy(), np.asarray(jl[c]))


def _window(rs, outer, cadence, n, refill_outer):
    """Merged V/FL records with the real invariants (tests/test_harvest.py's
    window): emission only at terminal vertices, starts only in refill
    rows; (V (3, outer, cadence, N), FL, STs)."""
    E = rs.uniform(0.0, 2.0, (3, outer, cadence, n)).astype(np.float32)
    Wt = rs.uniform(0.0, 1.0, (3, outer, cadence, n)).astype(np.float32)
    term = rs.uniform(size=(outer, cadence, n)) < 0.35
    V = np.where(term[None], E, Wt)
    FL = ((rs.uniform(size=(outer, cadence, n)) < 0.3).astype(np.int32)
          | (term.astype(np.int32) << 1))
    STs = np.zeros((outer, n), np.int32)
    STs[:refill_outer] = rs.uniform(size=(refill_outer, n)) < 0.3
    return V, FL, STs


def test_unwinding_harvest_path_for_path():
    """A window whose lanes were relabelled at every outer boundary by
    random bijections (records, started flags and so item ranks moving
    with the lanes) harvests every path's radiance bit for bit as the
    same paths without relabelling; with identity `perms` the harvest is
    `reverse_harvest_ref`'s without them. Both through the plain
    `reverse_harvest_into` as well, at each path's item slot."""
    outer, cadence, n, refill_outer, maxc = 7, 3, 96, 5, 1.5
    rs = np.random.default_rng(11)
    V, FL, STs = _window(rs, outer, cadence, n, refill_outer)
    pos = np.stack([rs.permutation(n) for _ in range(outer)])  # timeline -> lane
    Vp, FLp, STp = np.empty_like(V), np.empty_like(FL), np.empty_like(STs)
    perms = np.empty((outer, n), np.int32)
    for r in range(outer):
        Vp[:, r][..., pos[r]] = V[:, r]
        FLp[r][:, pos[r]] = FL[r]
        STp[r][pos[r]] = STs[r]
        perms[r][pos[r]] = pos[r - 1] if r else rs.permutation(n)
    kw = dict(cadence=cadence, refill_outer=refill_outer,
              max_contribution=maxc)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    plain = tph.reverse_harvest_ref(*(t(V[c]) for c in range(3)), t(FL),
                                    t(STs), **kw)
    moved = tph.reverse_harvest_ref(*(t(Vp[c]) for c in range(3)), t(FLp),
                                    t(STp), perms=t(perms), **kw)
    ident = tph.reverse_harvest_ref(
        *(t(V[c]) for c in range(3)), t(FL), t(STs),
        perms=t(np.tile(np.arange(n, dtype=np.int32), (outer, 1))), **kw)
    for a, b in zip(plain, ident):
        assert torch.equal(a, b)
    rank = lambda st: np.cumsum(st) - 1          # a start's rank in its row
    nis = np.concatenate([[0], np.cumsum(STs.sum(axis=1))])[:refill_outer]
    acc_u = torch.zeros((int(STs.sum()) + n, 3))
    acc_m = torch.zeros_like(acc_u)
    tph.reverse_harvest_into(acc_u, *(t(V[c]) for c in range(3)), t(FL),
                             t(STs), t(nis.astype(np.int32)), item_base=0,
                             **kw)
    tph.reverse_harvest_into(acc_m, *(t(Vp[c]) for c in range(3)), t(FLp),
                             t(STp), t(nis.astype(np.int32)), item_base=0,
                             perms=t(perms), **kw)
    paths = 0
    for r in range(refill_outer):
        ru, rm = rank(STs[r]), rank(STp[r])
        for k in np.nonzero(STs[r])[0]:
            iu, im = ru[k], rm[pos[r][k]]
            for c in range(3):
                assert plain[c][r, iu].item() == moved[c][r, im].item() \
                    or (np.isnan(plain[c][r, iu].item())
                        and np.isnan(moved[c][r, im].item()))
            assert torch.equal(acc_u[nis[r] + iu], acc_m[nis[r] + im])
            paths += 1
    assert paths == int(STs.sum()) > 50


# ------------------------------------------------- one window against JAX

W, SPP, DEPTH, N, CAD = 32, 16, 50, 4096, 8
NPIX, SQ, TOTAL = W * W, 4, W * W * SPP
REFILL = 4 * (DEPTH + 1)
WINDOW = -(-(REFILL + DEPTH + 1) // CAD) * CAD
OUTER = WINDOW // CAD


def test_queue_window_reorder_matches_jax_window():
    """cornellBox at 32 px, 16 spp, depth 50, 4096 lanes, cadence 8 (the
    window of tests/test_torch_regen_sched.py): one sorted `queue` window
    of the port against the JAX window with `reorder=True` (its XLA
    harvest, the in-kernel queue off), from JAX's initial state and
    per-call seeds. The items consumed and the levels are exact. Item for
    item agreement is not promised: the fused kernels key their random
    numbers on the lane's position, so a rounding that moves one lane into
    another Morton cell shifts the sorted position, and the numbers, of
    every lane between. Found (CPU): segments 47,890 against 47,891, and
    no item outside rtol 1e-3, atol 1e-4; the bounds are the unsorted
    window's (tests/test_torch_regen_sched.py). A difference by design:
    under the sort, JAX's table is in Morton order, so its equal-t ties go
    to the first row in that order; the port keeps the declared winner
    (tests/test_torch_scan_order.py)."""
    js, jc = jreg.cornell_box()
    jc.width, jc.samples_per_pixel, jc.max_depth = W, SPP, DEPTH
    tc = Camera(**{f.name: getattr(jc, f.name)
                   for f in dataclasses.fields(Camera)})
    ts = TT.scene_from_numpy(js)
    targs = (tuple(torch.from_numpy(t) for t in tpb.pack_scene(ts)),
             tpb.scene_statics(ts),
             torch.from_numpy(tpb.pack_camera(tc.derived())),
             torch.from_numpy(np.array(ts.background)))
    key = jax.random.fold_in(jax.random.key(7), 0)
    seeds = torch.tensor(np.asarray(jax.random.randint(
        key, (OUTER,), jnp.iinfo(jnp.int32).min, jnp.iinfo(jnp.int32).max,
        dtype=jnp.int32)))
    jstate = jregen._init_state(N, jnp.float32)
    jacc, _, jcur = jregen._window_impl(
        js, jc.derived(), jnp.zeros((TOTAL + N, 3), jnp.float32), jstate,
        jnp.int32(0), key, jnp.int32(0), jnp.int32(TOTAL), width=W, npix=NPIX,
        sqrt_spp=SQ, window=WINDOW, refill=REFILL, cadence=CAD, n_u=9,
        max_depth=DEPTH, max_contribution=jc.max_contribution,
        use_pallas=True, interpret=True, inkernel=False, harvest="xla",
        reorder=True)
    tacc = torch.zeros((TOTAL + N, 3))
    state = regen.queue_state_from_numpy([np.asarray(x) for x in jstate],
                                         "cpu")
    bounds = tuple(torch.from_numpy(b) for b in tpb.coherence_bounds(ts))
    bufs = regen.SchedBuffers.empty(N, OUTER, CAD, "cpu", -(-REFILL // CAD),
                                    reorder=True)
    _, state, tcur = regen._queue_window(
        *targs, tacc, state, torch.tensor(0), seeds, 0, TOTAL, width=W,
        npix=NPIX, sqrt_spp=SQ, window=WINDOW, refill=REFILL, cadence=CAD,
        max_depth=DEPTH, max_contribution=jc.max_contribution, bufs=bufs,
        reorder=bounds)
    jcur = np.asarray(jcur)
    assert tcur[0].item() == jcur[0] == TOTAL
    assert tcur[2].item() == WINDOW
    # every call sorted: each row's permutation is a bijection, and the
    # window ends with every lane dead
    assert (bufs.perm.sort(dim=1).values
            == torch.arange(N, dtype=torch.int32)).all()
    assert not state[7].any()
    seg_rel = abs(tcur[1].item() - jcur[1]) / jcur[1]
    a, b = np.asarray(jacc)[:TOTAL], tacc[:TOTAL].numpy()
    mean_rel = abs(a.mean() - b.mean()) / a.mean()
    mismatched = (~np.isclose(a, b, rtol=1e-3, atol=1e-4)).any(axis=1).mean()
    print(f"sorted queue window: segments {tcur[1].item()} / {jcur[1]} "
          f"({seg_rel:.2e}), accumulator mean {b.mean():.8f} / "
          f"{a.mean():.8f} ({mean_rel:.2e}), mismatched items "
          f"{mismatched:.2e}")
    assert np.isfinite(b).all()
    assert seg_rel <= 0.001
    assert mismatched <= 2e-3
    assert mean_rel <= 1e-3


# ------------------------------------------------------------------ renders

def test_reorder_exact_accounting_and_depth():
    """tests/test_regen.py's test of the same name: the lane sorts and
    their unwinding keep the per-item accounting exact. The all-miss
    background exactly, one segment a path; the deterministic mirror
    corridor exactly (2, 3, 4), three segments a path."""
    cam = Camera(width=16, aspect_ratio=1.0, samples_per_pixel=9, max_depth=4)
    cam.position((0, 0, 5), (0, 0, 0))
    img, st = regen.render_regen(empty_scene((0.25, 0.5, 0.75)), cam, seed=0,
                                 n_lanes=4096, cadence=2, reorder=True,
                                 device="cpu")
    for c, v in enumerate((0.25, 0.5, 0.75)):
        np.testing.assert_array_equal(img[..., c], np.float32(v))
    assert st["segments"] == st["paths"] == 16 * 16 * 9
    assert st["schedule"] == "queue" and st["reorder"] is True

    cam2 = Camera(width=4, aspect_ratio=1.0, samples_per_pixel=4,
                  max_depth=2, vertical_fov=2.0, focus_distance=1.0)
    cam2.position((0, 0, 0), (0, 0, -1))
    img2, st2 = regen.render_regen(mirror_corridor(), cam2, seed=0,
                                   n_lanes=4096, cadence=2, reorder=True,
                                   device="cpu")
    np.testing.assert_array_equal(
        img2, np.broadcast_to(np.float32([2.0, 3.0, 4.0]), img2.shape))
    assert st2["segments"] == 4 * 4 * 4 * 3


def test_reorder_statistical_agreement_dense_scene():
    """tests/test_regen.py's test of the same name: book1 (389 spheres) at
    48 px, 4 spp, depth 4, sorted, against the port's `backend="xla"`
    render of another seed, within JAX's bounds."""
    scene, cam = registry.book1()
    cam.width, cam.samples_per_pixel, cam.max_depth = 48, 4, 4
    img_p, st = regen.render_regen(scene, cam, seed=0, n_lanes=4096,
                                   cadence=4, reorder=True, device="cpu")
    img_x, _ = regen.render_regen(scene, cam, seed=1, n_lanes=4096,
                                  cadence=4, backend="xla", device="cpu")
    assert st["schedule"] == "queue" and st["reorder"] is True
    assert abs(float(img_p.mean()) - float(img_x.mean())) < 0.02
    assert float(np.abs(img_p - img_x).mean()) < 0.15


def _small():
    cam = Camera(width=8, aspect_ratio=1.0, samples_per_pixel=4, max_depth=3)
    cam.position((0, 2, 6), (0, 1, 0))
    return mirror_corridor(), cam


@pytest.mark.parametrize("schedule", ["auto", "queue"])
def test_reorder_resolves_to_queue(schedule):
    scene, cam = _small()
    _, st = regen.render_regen(scene, cam, n_lanes=256, schedule=schedule,
                               reorder=True, device="cpu")
    assert st["schedule"] == "queue" and st["reorder"] is True


@pytest.mark.parametrize("case", ["queue_ik", "positional", "direct_rec",
                                  "mesh", "xla", "bad_value"])
def test_reorder_refusals(case):
    """Where the JAX package quietly drops the sort, the port raises."""
    scene, cam = _small()
    kw = dict(n_lanes=256, device="cpu", reorder=True)
    if case in ("queue_ik", "positional"):
        kw["schedule"] = case
    elif case == "direct_rec":
        kw["direct_rec"] = True
    elif case == "mesh":
        scene, cam = registry.model_example()
    elif case == "xla":
        kw["backend"] = "xla"
    else:
        kw["reorder"] = "yes"
    with pytest.raises(ValueError):
        regen.render_regen(scene, cam, **kw)


def test_reorder_off_changes_nothing():
    """"auto" and False run the unsorted paths bit for bit, with the same
    launches of the plain kernels (none of them sorts)."""
    scene, cam = _small()
    for schedule in ("queue", "queue_ik"):
        imgs = [regen.render_regen(scene, cam, seed=5, n_lanes=256,
                                   schedule=schedule, device="cpu", **kw)
                for kw in ({}, {"reorder": False}, {"reorder": "auto"})]
        for img, st in imgs[1:]:
            np.testing.assert_array_equal(img, imgs[0][0])
            assert st["segments"] == imgs[0][1]["segments"]
            assert st.get("reorder") is (False if schedule == "queue"
                                         else None)


def test_reorder_checkpoint_resume_bit_exact(tmp_path, monkeypatch):
    """Between windows no path is in flight and every lane is dead, so a
    sorted render resumed from any window's checkpoint reproduces the
    uninterrupted render bit for bit."""
    from go_raytracer_tpu_torch.render import checkpoint as ck

    scene = registry.cornell_box()[0]
    cam = Camera(width=16, aspect_ratio=1.0, samples_per_pixel=9, max_depth=3)
    cam.position((278, 278, -800), (278, 278, 0))
    kw = dict(seed=17, n_lanes=256, refill_len=4, cadence=2, reorder=True,
              device="cpu")
    img_ref, st_ref = regen.render_regen(scene, cam, **kw)
    assert st_ref["windows"] >= 3
    ckpt = str(tmp_path / "r.npz")
    saved = []
    real_save = ck.save

    def capture_save(path, acc, next_item, meta, extra=None):
        real_save(path, acc, next_item, meta, extra)
        snap = str(tmp_path / f"snap{len(saved)}.npz")
        shutil.copy(path, snap)
        saved.append(snap)

    monkeypatch.setattr(ck, "save", capture_save)
    img_full, _ = regen.render_regen(scene, cam, checkpoint_path=ckpt,
                                     checkpoint_every=1, scene_name="c", **kw)
    np.testing.assert_array_equal(img_full, img_ref)
    monkeypatch.setattr(ck, "save", real_save)
    assert len(saved) >= 3
    for snap in (saved[0], saved[1]):
        shutil.copy(snap, ckpt)
        img_res, st_res = regen.render_regen(scene, cam, checkpoint_path=ckpt,
                                             scene_name="c", **kw)
        np.testing.assert_array_equal(img_res, img_ref)
        assert len(st_res["window_s"]) < st_ref["windows"]
