"""The port's `bounce_fused` (queue schedule) and `bounce_fused_pos`
(positional schedule) against the JAX package's Pallas kernels in interpret
mode on the CPU, on the same numpy-seeded inputs, and the static-slot PRNG
bit for bit.

No lane depends on another in either kernel, so every comparison is per
lane. A lane whose ray grazes an edge may branch the other way (different
rsqrt / sin / cos rounding) and then carries another path: flag and alive
mismatches stay under 2e-3 of the lanes, and on the lanes that agree the
integer planes are exact and the float planes within rtol 2e-4 / atol 2e-3
(rtol 2e-3 for directions and record values, as tests/test_torch_bounce.py
holds `bounce_fused_q`)."""

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

MISMATCH_FRAC = 2e-3
# book3's glass sphere bends a ray that differs by one rounding into a
# visibly different one after a few refractions: at 3 levels 2.53e-3 of
# the lanes alive in both (5 of 1,977) left the 2e-3 bound on their rays
MISMATCH_FRAC_DIELECTRIC = 5e-3
N = 4096
W, SQRT_SPP = 32, 4
NPIX = W * W


def test_u01_static_slot_bitwise():
    """The static-slot `_u01` equals the JAX package's over random lanes,
    seeds (negative int32 included) and every slot the two kernels use."""
    rs = np.random.default_rng(0)
    lane = rs.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    for seed in (0, 1, -1, -123456789, 2**31 - 1, -(2**31)):
        for slot in (0, 4, 5, 13, 14, 5 + 9 * 7 + 8, 14 * 7 + 13):
            j = jpb._u01(jnp.asarray(lane),
                         jnp.asarray(np.int32(seed)).astype(jnp.uint32), slot)
            t = tpb._u01(torch.from_numpy(lane.astype(np.int64)), seed, slot)
            np.testing.assert_array_equal(
                np.asarray(j).view(np.uint32), t.numpy().view(np.uint32))
            d = tpb._u01_dyn(torch.from_numpy(lane.astype(np.int64)), seed,
                             slot)
            assert torch.equal(t, d)


def _lane_state(n, seed=0):
    rs = np.random.default_rng(seed)
    o = rs.uniform(50, 500, (n, 3)).astype(np.float32)
    d = (rs.normal(size=(n, 3)) * 300).astype(np.float32)
    return [np.ascontiguousarray(x) for x in (
        o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
        rs.uniform(0, 1, n).astype(np.float32),
        (rs.uniform(size=n) < 0.6).astype(np.int32),
        rs.integers(0, 50, n).astype(np.int32))]


def _cornell(scene="cornell_box"):
    js, jc = getattr(jreg, scene)()
    ts = TT.scene_from_numpy(js)
    jc.width, jc.samples_per_pixel = W, SQRT_SPP * SQRT_SPP
    tc = Camera(**{f.name: getattr(jc, f.name)
                   for f in dataclasses.fields(Camera)})
    jargs = (jpb.pack_scene(js), jpb.scene_statics(js),
             jpb.pack_camera(jc.derived()), js.background)
    targs = (tuple(torch.from_numpy(t) for t in tpb.pack_scene(ts)),
             tpb.scene_statics(ts),
             torch.from_numpy(tpb.pack_camera(tc.derived())),
             torch.from_numpy(np.array(ts.background)))
    return jargs, targs


def _compare(jout, tout, frac=MISMATCH_FRAC):
    """Records, segment counts and state of one call, JAX against port,
    with at most `frac` of the lanes beyond the tolerances. Returns the
    mask of lanes that agree on alive."""
    jrec, _, jseg, *jst = jax.tree.map(np.asarray, jout)
    trec, _, tseg, *tst = tout
    trec = [x.numpy() for x in trec]
    tst = [x.numpy() for x in tst]
    tseg = tseg.numpy()
    assert tseg[0] == jseg[0]
    assert np.all(np.abs(tseg - jseg) <= frac * N)
    # integer record planes: the flag words (queue) or CF and ST (positional)
    int_planes = [k for k, x in enumerate(trec) if x.dtype == np.int32]
    agree_rec = np.ones_like(trec[0], dtype=bool)
    for k in int_planes:
        assert trec[k].shape == jrec[k].shape
        assert (trec[k] != jrec[k]).mean() <= frac
        agree_rec &= trec[k] == jrec[k]
        np.testing.assert_array_equal(trec[k][0], jrec[k][0])
    for k in range(len(trec)):
        if k in int_planes:
            continue
        a, b = jrec[k][agree_rec], trec[k][agree_rec]
        assert (np.isnan(a) == np.isnan(b)).all()
        bad = ~np.isclose(b, a, rtol=2e-3, atol=2e-3, equal_nan=True)
        assert bad.mean() <= frac
        np.testing.assert_allclose(trec[k][0], jrec[k][0], rtol=2e-3,
                                   atol=2e-3)
    assert (tst[7] != jst[7]).mean() <= frac
    same = tst[7] == jst[7]
    both = (tst[7] > 0) & (jst[7] > 0)
    for k, rtol in ((0, 2e-4), (1, 2e-4), (2, 2e-4), (3, 2e-3), (4, 2e-3),
                    (5, 2e-3)):
        bad = ~np.isclose(tst[k][both], jst[k][both], rtol=rtol, atol=2e-3)
        assert bad.mean() <= frac
    np.testing.assert_array_equal(tst[8][same], jst[8][same])
    np.testing.assert_array_equal(tst[6], jst[6])
    return same, jst, tst


SCENES = ["cornell_box", "book3", "cornell_smoke"]


def _frac(scene):
    return MISMATCH_FRAC_DIELECTRIC if scene == "book3" else MISMATCH_FRAC


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("n_inner", [1, 3])
def test_bounce_fused_ref_matches_pallas(n_inner, scene):
    """cornellBox, book3 (dielectric, sphere light) and cornellSmoke (two
    media, whose uniforms widen every level's PRNG slots) tables, 4096
    lanes, a mixed alive/depth state and the refill planes of a real queue
    refill (dead lanes take consecutive items by rank, the queue running
    out before the last dead lane)."""
    jargs, targs = _cornell(scene)
    state = _lane_state(N)
    dead = state[7] == 0
    next_item, item_end = 1000, 1000 + int(dead.sum()) - 37
    item = next_item + np.cumsum(dead) - 1
    take = dead & (item < item_end)
    assert 0 < take.sum() < dead.sum()
    stratum, pid = item // NPIX, item % NPIX
    refill = [take.astype(np.int32)] + [x.astype(np.float32) for x in (
        pid % W, pid // W, stratum // SQRT_SPP, stratum % SQRT_SPP)]
    kw = dict(has_defocus=False, max_depth=50, n_inner=n_inner)
    jout = jpb.bounce_fused(
        *jargs, jnp.int32(-123456789), *[jnp.asarray(x) for x in state],
        *[jnp.asarray(x) for x in refill], interpret=True, **kw)
    tout = tpb.bounce_fused(
        *targs, torch.tensor([-123456789], dtype=torch.int32),
        *[torch.from_numpy(x) for x in state],
        *[torch.from_numpy(x) for x in refill], **kw)
    assert len(tout) == 3 + 9 and len(tout[0]) == 4
    _, jst, tst = _compare(jout, tout, _frac(scene))
    # a taken lane starts at depth 0 and every lane alive at a level ages
    assert tout[2][0].item() == int((~dead | take).sum())


@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("n_inner,refill_rem", [(1, 1), (3, 2)])
def test_bounce_fused_pos_ref_matches_pallas(n_inner, refill_rem, scene):
    """The same tables and state with per-lane item pointers near every
    carry (last stratum column, last stratum, last pixel column) and `rem`
    mixed (zero, one, many); seed2[1] cuts the refill before the call's
    last level. pi, pj, si, sj, rem are exact on every lane that agrees on
    alive."""
    jargs, targs = _cornell(scene)
    state = _lane_state(N, seed=1)
    rs = np.random.default_rng(2)
    pi = rs.choice([0, 5, W - 1], N).astype(np.float32)
    pj = rs.integers(0, W - 2, N).astype(np.float32)
    si = rs.choice([0, SQRT_SPP - 1], N).astype(np.float32)
    sj = rs.choice([0, 1, SQRT_SPP - 1], N).astype(np.float32)
    rem = rs.choice([0, 1, 2, 40], N).astype(np.float32)
    ptr = [pi, pj, si, sj, rem]
    seed2 = np.array([987654321, refill_rem], np.int32)
    kw = dict(has_defocus=False, max_depth=50, n_inner=n_inner, width=W,
              sqrt_spp=SQRT_SPP)
    jout = jpb.bounce_fused_pos(
        *jargs, jnp.asarray(seed2), *[jnp.asarray(x) for x in state],
        *[jnp.asarray(x) for x in ptr], interpret=True, **kw)
    tout = tpb.bounce_fused_pos(
        *targs, torch.from_numpy(seed2),
        *[torch.from_numpy(x) for x in state],
        *[torch.from_numpy(x) for x in ptr], **kw)
    assert len(tout) == 3 + 14 and len(tout[0]) == 8
    same, jst, tst = _compare(jout, tout, _frac(scene))
    for k in range(9, 14):
        np.testing.assert_array_equal(tst[k][same], jst[k][same])
        assert (tst[k] != jst[k]).mean() <= _frac(scene)
    st = tout[0][7].numpy()
    # level 0 starts exactly the dead lanes with items left; nothing starts
    # at or after level seed2[1]; the planes stay whole numbers in range
    np.testing.assert_array_equal(st[0] != 0, (state[7] == 0) & (rem > 0))
    assert not st[refill_rem:].any()
    assert (st.sum(axis=0) == rem - tst[13]).all()
    for k, hi in ((9, W), (11, SQRT_SPP), (12, SQRT_SPP)):
        assert (tst[k] == np.round(tst[k])).all()
        assert tst[k].min() >= 0 and tst[k].max() < hi
    # E and W are disjoint, and a carry out of the last column moved a row
    E, Wt = np.stack([x.numpy() for x in tout[0][:3]]), \
        np.stack([x.numpy() for x in tout[0][3:6]])
    assert not ((E != 0).any(0) & (Wt != 0).any(0)).any()
    carried = (st[0] != 0) & (pi == W - 1) & (si == SQRT_SPP - 1) \
        & (sj == SQRT_SPP - 1)
    assert carried.sum() > 10
    if n_inner == 1:
        assert (tst[10][carried] == pj[carried] + 1).all()
        assert (tst[9][carried] == 0).all()


def test_fused_wrappers_reject_unsupported():
    """A scene outside the kernels' subset (simpleLight: noise textures),
    or defocus, raises instead of running another path."""
    js, _ = jreg.simple_light()
    ts = TT.scene_from_numpy(js)
    z = torch.zeros(256)
    zi = torch.zeros(256, dtype=torch.int32)
    tabs = tuple(torch.from_numpy(t) for t in tpb.pack_scene(ts))
    common = (tabs, tpb.scene_statics(ts), torch.zeros(1, 20), torch.zeros(3))
    with pytest.raises(NotImplementedError):
        tpb.bounce_fused(*common, torch.zeros(1, dtype=torch.int32),
                         z, z, z, z, z, z, z, zi, zi, zi, z, z, z, z,
                         has_defocus=False, max_depth=4)
    with pytest.raises(NotImplementedError):
        tpb.bounce_fused_pos(*common, torch.zeros(2, dtype=torch.int32),
                             z, z, z, z, z, z, z, zi, zi, z, z, z, z, z,
                             has_defocus=False, max_depth=4, width=4,
                             sqrt_spp=1)
    _, targs = _cornell()
    with pytest.raises(NotImplementedError, match="defocus"):
        tpb.bounce_fused(*targs, torch.zeros(1, dtype=torch.int32),
                         z, z, z, z, z, z, z, zi, zi, zi, z, z, z, z,
                         has_defocus=True, max_depth=4)
