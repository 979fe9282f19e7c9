"""The port's `bounce_fused_q` against the JAX package's Pallas kernel
(interpret mode on the CPU), and its PRNG / item decomposition bit for bit.

Tolerances: take counts and starts are exact at the first level; later
levels may flip a lane whose ray grazes an edge (different rsqrt / sin /
cos rounding), so alive and flag mismatches stay below 1% of the lanes;
float planes use test_pallas_bounce.py's rtol/atol (2e-4 / 2e-3 for
origins, 2e-3 / 2e-3 for the rest) on lanes that agree."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_raytracer_tpu.ops.pallas import bounce as jpb
from go_raytracer_tpu.scenes import registry as jreg
from go_raytracer_tpu_torch.ops import bounce as tpb
from go_raytracer_tpu_torch.render.camera import Camera
from go_raytracer_tpu_torch.scene import types as TT

torch.set_num_threads(2)

MISMATCH_FRAC = 0.01


def test_mix32_and_u01_bitwise():
    """_mix32 and _u01_dyn: bitwise equal over random lanes, seeds
    (negative int32 included) and slots."""
    rs = np.random.default_rng(0)
    lane = rs.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    for seed in (0, 1, -1, -123456789, 2**31 - 1, -(2**31)):
        for slot in (0, 5, 13, 14 * 7 + 3, 2**20 + 1):
            j = jpb._u01_dyn(jnp.asarray(lane),
                             jnp.asarray(np.int32(seed)).astype(jnp.uint32),
                             jnp.uint32(slot))
            t = tpb._u01_dyn(torch.from_numpy(lane.astype(np.int64)), seed,
                             slot)
            np.testing.assert_array_equal(
                np.asarray(j).view(np.uint32), t.numpy().view(np.uint32))
    x = rs.integers(0, 2**32, 8192, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        np.asarray(jpb._mix32(jnp.asarray(x))),
        tpb._mix32(torch.from_numpy(x.astype(np.int64))).numpy()
        .astype(np.uint32))


def test_item_to_coords_exact():
    """Exact for items far beyond 2^24, at the fixup's hard cases (the
    cases of tests/test_ikq.py), and equal to the JAX decomposition."""
    rs = np.random.default_rng(0)
    for npix, width, sqrt_spp in [(360000, 600, 10), (640000, 800, 10),
                                  (90000, 400, 7), (202200, 600, 15),
                                  (127, 127, 3)]:
        total = npix * sqrt_spp * sqrt_spp
        items = np.unique(np.concatenate([
            rs.integers(0, total, 4000), np.arange(64),
            total - 1 - np.arange(min(64, total)),
            (np.arange(1, 40) * npix).clip(0, total - 1),
            (np.arange(1, 40) * npix - 1).clip(0, total - 1)]))
        items = items[(items >= 0) & (items < total)].astype(np.int64)
        pi, pj, si, sj = tpb._item_to_coords(torch.from_numpy(items), npix,
                                             width, sqrt_spp)
        stratum, pixel = items // npix, items % npix
        np.testing.assert_array_equal(pi.numpy(), pixel % width)
        np.testing.assert_array_equal(pj.numpy(), pixel // width)
        np.testing.assert_array_equal(si.numpy(), stratum // sqrt_spp)
        np.testing.assert_array_equal(sj.numpy(), stratum % sqrt_spp)
        jc = jpb._item_to_coords(jnp.asarray(items.astype(np.int32)), npix,
                                 width, sqrt_spp)
        for a, b in zip(jc, (pi, pj, si, sj)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _lane_state(n, seed=0):
    rs = np.random.default_rng(seed)
    o = rs.uniform(50, 500, (n, 3)).astype(np.float32)
    d = (rs.normal(size=(n, 3)) * 300).astype(np.float32)
    return [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
            rs.uniform(0, 1, n).astype(np.float32),
            (rs.uniform(size=n) < 0.6).astype(np.int32),
            rs.integers(0, 50, n).astype(np.int32)]


@pytest.mark.parametrize("scene", ["cornell_box", "book3", "cornell_smoke"])
@pytest.mark.parametrize("n_inner", [1, 3])
def test_bounce_fused_q_ref_matches_pallas(n_inner, scene):
    """cornellBox, book3 (glass sphere, sphere light, rotated box) and
    cornellSmoke (two media: 2 more PRNG slots per level) tables, 4096
    lanes, a mixed alive/depth state, the queue refilling at the first two
    levels: the plain PyTorch version against the JAX kernel in interpret
    mode."""
    js, jc = getattr(jreg, scene)()
    ts = TT.scene_from_numpy(js)
    jc.width, jc.samples_per_pixel = 32, 16
    npix, sqrt_spp, n = 32 * 32, 4, 4096
    state = [np.ascontiguousarray(x) for x in _lane_state(n)]
    seed4 = np.array([-123456789, 2, 100, npix * 16], np.int32)
    kw = dict(has_defocus=False, max_depth=50, n_inner=n_inner, width=32,
              sqrt_spp=sqrt_spp, npix=npix)
    jout = jpb.bounce_fused_q(
        jpb.pack_scene(js), jpb.scene_statics(js), jpb.pack_camera(jc.derived()),
        js.background, jnp.asarray(seed4), *[jnp.asarray(x) for x in state],
        interpret=True, **kw)
    jrec, _, jseg, jtc, *jst = jax.tree.map(np.asarray, jout)
    tables = tuple(torch.from_numpy(t) for t in tpb.pack_scene(ts))
    tc = Camera(**{f.name: getattr(jc, f.name)
                   for f in dataclasses.fields(Camera)})
    tout = tpb.bounce_fused_q(
        tables, tpb.scene_statics(ts),
        torch.from_numpy(tpb.pack_camera(tc.derived())),
        torch.from_numpy(np.array(ts.background)), torch.from_numpy(seed4),
        *[torch.from_numpy(x) for x in state], **kw)
    trec, _, tseg, ttc, *tst = tout
    trec = [x.numpy() for x in trec]
    tst = [x.numpy() for x in tst]

    assert ttc[0].item() == jtc[0] and tseg[0].item() == jseg[0]
    if n_inner == 1:
        np.testing.assert_array_equal(ttc.numpy(), jtc)
    else:
        assert np.all(np.abs(ttc.numpy() - jtc) <= MISMATCH_FRAC * n)
    fl_t = trec[3] & 7
    # level 0 starts exactly, and the rank bits address them in lane order
    np.testing.assert_array_equal(fl_t[0] & 4, jrec[3][0] & 4)
    started = (jrec[3][0] & 4) != 0
    np.testing.assert_array_equal(trec[3][0][started] >> 3,
                                  np.arange(started.sum()))
    assert (fl_t != jrec[3]).mean() <= MISMATCH_FRAC
    assert (tst[7] != jst[7]).mean() <= MISMATCH_FRAC
    agree = fl_t == jrec[3]
    for k in range(3):
        a, b = jrec[k][agree], trec[k][agree]
        assert (np.isnan(a) == np.isnan(b)).all()
        np.testing.assert_allclose(b[~np.isnan(a)], a[~np.isnan(a)],
                                   rtol=2e-3, atol=2e-3)
    both = (tst[7] > 0) & (jst[7] > 0)
    for k, rtol in ((0, 2e-4), (1, 2e-4), (2, 2e-4), (3, 2e-3), (4, 2e-3),
                    (5, 2e-3)):
        bad = ~np.isclose(tst[k][both], jst[k][both], rtol=rtol, atol=2e-3)
        assert bad.mean() <= MISMATCH_FRAC
    np.testing.assert_array_equal(tst[8][both], jst[8][both])
    np.testing.assert_array_equal(tst[6], jst[6])


def test_cpu_wrapper_rejects_unsupported_statics():
    """A scene outside the kernel's subset (simpleLight: noise textures)
    raises instead of running another path."""
    js, _ = jreg.simple_light()
    ts = TT.scene_from_numpy(js)
    assert not tpb.supported(ts)
    z = torch.zeros(256)
    zi = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        tpb.bounce_fused_q(
            tuple(torch.from_numpy(t) for t in tpb.pack_scene(ts)),
            tpb.scene_statics(ts), torch.zeros(1, 20), torch.zeros(3),
            torch.zeros(4, dtype=torch.int32), z, z, z, z, z, z, z, zi, zi,
            has_defocus=False, max_depth=4, width=4, sqrt_spp=1, npix=16)
