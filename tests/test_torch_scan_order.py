"""The culled closest-hit scan of the CUDA bounce kernels, on the CPU.

`ops/bounce.scan_layout` builds the kernels' scan table once per scene:
spheres in the Morton order of their swept boxes (the JAX package's
`pack_scene(cull=True)` key), quads and boxes in declaration order, in
blocks of 8 rows with their bounds. `closest_culled_ref` is the plain model
of the kernels' scan over it (csrc/bounce_core.cuh): a block of a section
of more than one is skipped where the ray cannot meet its padded bounds in
(T_MIN, t_best], and a row takes the winner's place when nearer, or as
near and declared earlier. Held here, exactly, to the plain version's
brute-force declaration-order scan (`closest_ref`) on book2, book1, the
synthetic scan scene in both of chip_smoke.py's mixes (spheres past the
staging budget, quads past it) and the tie scene, whose later-declared
moving sphere the Morton order puts first; and the sphere order and block
bounds to the JAX package's. The kernels are held to the plain versions on
the card (chip_smoke.py phases 23-25), and the CUDA core's own cull on the
host (tests/test_torch_sphere_scan.py, scripts/check_cull_host.py)."""

import jax
import numpy as np
import pytest
import torch

from go_raytracer_tpu.ops.pallas import bounce as jpb
from go_raytracer_tpu.scenes import registry as jreg
from go_raytracer_tpu_torch.ops import bounce as tpb
from go_raytracer_tpu_torch.scenes import registry
from go_raytracer_tpu_torch.scenes import synthetic as syn

torch.set_num_threads(2)

N = 2048    # lanes (half of them on the scan mixes' 4,096 rows)
# chip_smoke.py phase 23's mixes of the scan scene at MAX_PRIMS rows
MIXES = {"scan_spheres": (3500, 300, 296), "scan_quads": (200, 1800, 2096)}


def _scene(name):
    """(prims, statics, camera row, width, height) of a registry scene, a
    scan mix or the tie scene (40 spheres, the pair's second moving)."""
    if name in ("book1", "book2"):
        scene, cam = getattr(registry, name)()
        prims = tpb.pack_scene(scene)[0]
        st = tpb.scene_statics(scene)
    else:
        cnt = MIXES.get(name, (40, 2, 1))
        scene, cam, tabs, st = syn.build(*cnt, moving_pair=name == "tie")
        prims = tabs[0]
    row = tpb.pack_camera(cam.derived())[0]
    return prims, st, row, cam.width, cam.image_height


def _rays(prims, st, cam, width, height, n, seed, tm=None):
    """n rays, float32 planes: camera rays through random pixels (half),
    and rays leaving the first half's hit points in random directions (a
    miss's from a random point among the rows); ray times uniform in [0,
    1) or `tm`."""
    rs = np.random.default_rng(seed)
    h = n // 2
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    pi = rs.uniform(0, width, h)
    pj = rs.uniform(0, height, h)
    d0 = (cam[0:3][None] + pi[:, None] * cam[3:6][None]
          + pj[:, None] * cam[6:9][None] - cam[9:12][None])
    o0 = np.broadcast_to(cam[9:12], (h, 3))
    times = rs.uniform(0, 1, n) if tm is None else np.full(n, tm)
    ray0 = [f(o0[:, k]) for k in range(3)] + [f(d0[:, k]) for k in range(3)]
    t, *_ = tpb.closest_ref(st, prims.tolist(), *ray0, f(times[:h]))
    t = t.numpy()
    hit = np.isfinite(t)
    p = np.asarray(o0, np.float64) + np.where(hit, t, 0.0)[:, None] * d0
    act = prims[:, 0] >= 0
    pool = prims[act][:, 1:4]
    p[~hit] = pool[rs.integers(0, len(pool), (~hit).sum())] \
        + rs.normal(size=((~hit).sum(), 3))
    d1 = rs.normal(size=(h, 3))
    o = np.concatenate([o0, p])
    d = np.concatenate([d0, d1])
    return [f(o[:, k]) for k in range(3)] + [f(d[:, k]) for k in range(3)] \
        + [f(times)]


def _both(name, seed=0, tm=None):
    prims, st, cam, w, h = _scene(name)
    ray = _rays(prims, st, cam, w, h, N // 2 if name in MIXES else N, seed,
                tm)
    brute = tpb.closest_ref(st, prims.tolist(), *ray)
    stats = {}
    culled = tpb.closest_culled_ref(st, prims, *ray, stats=stats)
    return prims, st, brute, culled, stats


@pytest.mark.parametrize("name", ["book2", "book1", "scan_spheres",
                                  "scan_quads", "tie"])
def test_culled_scan_takes_the_brute_force_winner(name):
    """On every lane the culled scan's winner (row, t and the normal slots)
    equals the declaration-order scan's, bit for bit; it tests fewer rows
    than the brute force on every scene with a culled section."""
    prims, st, brute, culled, stats = _both(name)
    assert torch.equal(culled[2], brute[2])
    assert torch.equal(culled[0], brute[0])
    for a, b in zip(culled[1], brute[1]):
        assert torch.equal(a, b)
    hits = int((brute[2] >= 0).sum())
    assert hits > brute[2].shape[0] // 4
    lay = tpb.scan_layout(prims, st)
    n_rows = sum(lay.counts)
    assert sum(stats["rows"]).float().mean() < 0.6 * n_rows
    assert (tpb.scan_ops(lay, stats) < tpb.brute_ops(lay)).float().mean() \
        > 0.5


def test_tie_goes_to_the_first_declared_row():
    """The tie scene: at ray time 0 the pair's second sphere (row 1,
    moving) lies where the first (row 0) does, and the scan order puts row
    1 first. Every camera ray that meets the pair takes row 0, as the
    declaration-order scan does, and none takes row 1."""
    prims, st, brute, culled, _ = _both("tie", seed=5, tm=0.0)
    order = tpb.scan_layout(prims, st).order[0].tolist()
    assert order.index(1) < order.index(0)
    half = N // 2
    took = culled[2][:half]
    assert int((took == 0).sum()) > 100
    assert not bool((culled[2] == 1).any())
    assert torch.equal(culled[2], brute[2])


@pytest.mark.parametrize("name", ["book2", "book1", "scan_spheres",
                                  "scan_quads", "tie"])
def test_blocks_hold_their_rows(name):
    """Every scanned active row's box lies inside its block's bounds, the
    block pads are SCAN_PAD times the block's size, and the table the
    kernels read carries those bounds and the rows' declaration ids."""
    prims, st, *_ = _scene(name)
    lay = tpb.scan_layout(prims, st)
    at = 0
    for sec in range(3):
        rows = lay.order[sec]
        act = prims[rows, 0] >= 0
        blk = np.arange(len(rows)) // tpb.SCAN_BLOCK
        lo, hi = lay.row_lo[sec], lay.row_hi[sec]
        assert (lo[act] >= lay.lo[sec][blk[act]]).all()
        assert (hi[act] <= lay.hi[sec][blk[act]]).all()
        assert (lo[act] <= hi[act]).all()
        nb = len(lay.pad[sec])
        size = (np.abs(0.5 * (lay.lo[sec] + lay.hi[sec])).sum(1)
                + 0.5 * (lay.hi[sec] - lay.lo[sec]).sum(1))
        np.testing.assert_allclose(lay.pad[sec], tpb.SCAN_PAD * size,
                                   rtol=1e-5)
        bnd = lay.table[at:at + 2 * nb].reshape(nb, 2, 4)
        np.testing.assert_array_equal(bnd[:, 0, :3], lay.lo[sec])
        np.testing.assert_array_equal(bnd[:, 1, :3], lay.hi[sec])
        f4 = tpb.SCAN_F4[sec]
        body = lay.table[at + 2 * nb:at + 2 * nb + f4 * len(rows)]
        body = body.reshape(len(rows), f4, 4)
        if sec != 1:
            np.testing.assert_array_equal(body[:, -1, 3],
                                          rows.astype(np.float32))
            assert act.all()
        at += 2 * nb + f4 * len(rows)
    assert at == lay.table.shape[0]


@pytest.mark.parametrize("name", ["book2", "book1"])
def test_sphere_order_and_bounds_match_jax(name):
    """The sphere section's scan order is the JAX package's
    `pack_scene(cull=True)` order exactly, and its block bounds agree with
    JAX's within float32 rounding."""
    js, _ = getattr(jreg, name)()
    packed = jax.jit(lambda s: jpb.pack_scene(s, cull=True))(js)
    jp, _, _, jblk = (np.asarray(x) for x in packed[:4])
    prims, st, *_ = _scene(name)
    lay = tpb.scan_layout(prims, st)
    n = st["n_sph"]
    key = {prims[r].tobytes(): r for r in range(n)}
    assert len(key) == n
    jorder = [key[jp[k].tobytes()] for k in range(n)]
    np.testing.assert_array_equal(lay.order[0], jorder)
    nb = len(lay.pad[0])
    np.testing.assert_allclose(lay.lo[0], jblk[:nb, 0:3], rtol=3e-7,
                               atol=1e-6)
    np.testing.assert_allclose(lay.hi[0], jblk[:nb, 3:6], rtol=3e-7,
                               atol=1e-6)
