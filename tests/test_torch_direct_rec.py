"""The direct-record in-kernel queue (K9, ops/bounce.bounce_fused_q_direct)
against the JAX package's `bounce_fused_q_direct` in interpret mode, and
the `--direct-rec` window against the plane window of the port itself.

Tolerances are tests/test_torch_bounce.py's (those of
tests/test_pallas_bounce.py: 2e-3 / 2e-3 on the records); flags and counts
are compared exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_raytracer_tpu.ops.pallas import bounce as jpb
from go_raytracer_tpu.scenes import registry as jreg
from go_raytracer_tpu_torch.integrator import regen
from go_raytracer_tpu_torch.ops import bounce as tpb
from go_raytracer_tpu_torch.render.camera import Camera
from go_raytracer_tpu_torch.scene import types as TT
from go_raytracer_tpu_torch.scenes import registry as treg
from tests.test_torch_bounce import V_FRAC, _lane_state

torch.set_num_threads(2)

N, N_INNER, WINDOW, BASE = 4096, 2, 6, 3
# book1 (glass, fuzzed metal, 389 spheres on a radius-1000 ground sphere
# with its f32 acne) is held to book3's dielectric bound: measured, 10 of
# the 8,192 flag words at the second level (1.2e-3)
FLIP_FRAC = {"book1": 5e-3}


@pytest.mark.parametrize("scene", ["cornell_box", "book3", "cornell_smoke",
                                   "simple_light", "book1"])
def test_direct_ref_matches_pallas_direct(scene):
    """cornellBox, book3, cornellSmoke, simpleLight (marble noise) and
    book1 (checker, 389 spheres, defocus), 4,096 lanes (one tile of the
    JAX kernel), 2 levels written at base 3 of a 6-level buffer: levels
    3-4 within tolerance (on the textured scenes all but `V_FRAC` of the
    lanes, tests/test_torch_bounce.py), flags, take and alive counts
    exact, every other level untouched (it holds a marker value in
    both)."""
    js, jc = getattr(jreg, scene)()
    ts = TT.scene_from_numpy(js)
    jc.width, jc.samples_per_pixel = 32, 16
    npix, sqrt_spp = 32 * 32, 4
    state = [np.ascontiguousarray(x) for x in _lane_state(N, seed=7)]
    seed4 = np.array([987654321, 2, 50, npix * 16], np.int32)
    kw = dict(has_defocus=jc.defocus_angle > 0, max_depth=50,
              n_inner=N_INNER, width=32, sqrt_spp=sqrt_spp, npix=npix)
    marker = [np.full((WINDOW, N), -7.5, np.float32)] * 3 \
        + [np.full((WINDOW, N), -9, np.int32)]
    jbufs = tuple(jnp.asarray(m.reshape(WINDOW, N // 128, 128))
                  for m in marker)
    jout = jpb.bounce_fused_q_direct(
        jpb.pack_scene(js), jpb.scene_statics(js),
        jpb.pack_camera(jc.derived()), js.background, jnp.asarray(seed4),
        jnp.asarray(BASE), jbufs, *[jnp.asarray(x) for x in state],
        interpret=True, **kw)
    *jrec, jseg, jtc = [np.asarray(x) for x in jout[:6]]
    jrec = [r.reshape(WINDOW, N) for r in jrec]
    jst = [np.asarray(x) for x in jout[6:]]

    tables = tuple(torch.from_numpy(t) for t in tpb.pack_scene(ts))
    tc = Camera(**{f.name: getattr(jc, f.name)
                   for f in dataclasses.fields(Camera)})
    tbufs = [torch.from_numpy(m.copy()) for m in marker]
    tout = tpb.bounce_fused_q_direct(
        tables, tpb.scene_statics(ts),
        torch.from_numpy(tpb.pack_camera(tc.derived())),
        torch.from_numpy(np.array(ts.background)), torch.from_numpy(seed4),
        torch.tensor([BASE], dtype=torch.int32), tbufs,
        *[torch.from_numpy(x) for x in state], **kw)
    trec = [x.numpy() for x in tout[:4]]
    assert all(a is b for a, b in zip(tout[:4], tbufs))   # in place
    tseg, ttc = tout[4].numpy(), tout[5].numpy()
    tst = [x.numpy() for x in tout[6:]]

    np.testing.assert_array_equal(ttc, jtc)
    np.testing.assert_array_equal(tseg, jseg)
    lv = slice(BASE, BASE + N_INNER)
    # flag bits 0-2 as the JAX kernel's (book1: at the first level; at the
    # second a lane whose ray left the ground sphere's acne or glass may
    # meet another material, FLIP_FRAC); bits 3.. (the port's addition)
    # rank each level's starts in lane order
    np.testing.assert_array_equal(trec[3][BASE] & 7, jrec[3][BASE])
    flip = (trec[3][lv] & 7) != jrec[3][lv]
    assert flip.mean() <= FLIP_FRAC.get(scene, 0.0)
    for j in range(BASE, BASE + N_INNER):
        started = (trec[3][j] & 4) != 0
        np.testing.assert_array_equal(trec[3][j][started] >> 3,
                                      np.arange(started.sum()))
    for k in range(3):
        a, b = jrec[k][lv], trec[k][lv]
        assert (np.isnan(a) == np.isnan(b)).all()
        bad = ~np.isclose(b, a, rtol=2e-3, atol=2e-3, equal_nan=True)
        assert bad.mean() <= V_FRAC.get(scene, 0.0)
    outside = np.ones(WINDOW, bool)
    outside[lv] = False
    for r, m in zip(trec + jrec, marker + marker):
        np.testing.assert_array_equal(r[outside], m[outside])
    assert ((trec[3][lv] & 4) != 0).sum() == ttc.sum() > 0
    same = ~flip.any(axis=0)
    assert (tst[7] != jst[7]).mean() <= FLIP_FRAC.get(scene, 0.0)
    np.testing.assert_array_equal(tst[7][same], jst[7][same])
    np.testing.assert_array_equal(tst[8][same], jst[8][same])


def test_direct_ref_equals_the_plane_path_and_clips_rows():
    """On the port alone: the direct call's rows equal `bounce_fused_q`'s
    planes bit for bit, its state and counts too; a base whose levels run
    past the buffer writes only the rows that exist."""
    js, jc = jreg.cornell_box()
    ts = TT.scene_from_numpy(js)
    tables = tuple(torch.from_numpy(t) for t in tpb.pack_scene(ts))
    cam = Camera(**{f.name: getattr(jc, f.name)
                    for f in dataclasses.fields(Camera)})
    cam.width, cam.samples_per_pixel = 16, 4
    args = (tables, tpb.scene_statics(ts),
            torch.from_numpy(tpb.pack_camera(cam.derived())),
            torch.from_numpy(np.array(ts.background)),
            torch.tensor([5, 3, 0, 16 * 16 * 4], dtype=torch.int32))
    state = [torch.from_numpy(np.ascontiguousarray(x))
             for x in _lane_state(512, seed=3)]
    kw = dict(has_defocus=False, max_depth=50, n_inner=3, width=16,
              sqrt_spp=2, npix=256)
    plane = tpb.bounce_fused_q(*args, *state, **kw)
    for base, rows in ((1, slice(1, 4)), (3, slice(3, 5))):
        bufs = [torch.zeros((5, 512)) for _ in range(3)] \
            + [torch.zeros((5, 512), dtype=torch.int32)]
        out = tpb.bounce_fused_q_direct(
            *args, torch.tensor([base], dtype=torch.int32), bufs, *state,
            **kw)
        n_rows = rows.stop - rows.start
        for a, b in zip(bufs, plane[0]):
            assert torch.equal(a[rows], b[:n_rows])
            assert not a[:rows.start].any() and not a[rows.stop:].any()
        assert torch.equal(out[4], plane[2]) and torch.equal(out[5], plane[3])
        for a, b in zip(out[6:], plane[4:]):
            assert torch.equal(a, b)
    assert tpb.launches == tpb.launches_direct == 0


def test_direct_rec_render_is_the_plane_render():
    """render_regen(direct_rec=True) on cornellBox (32 px, 16 spp, two
    windows): the same image, segments and windows as the plane path; the
    stats say which ran. Other schedules and image scenes refuse it."""
    scene, cam = treg.cornell_box()
    cam.width, cam.samples_per_pixel, cam.max_depth = 32, 16, 8
    kw = dict(seed=2, n_lanes=4096, refill_len=8, device="cpu")
    img_p, st_p = regen.render_regen(scene, cam, **kw)
    img_d, st_d = regen.render_regen(scene, cam, direct_rec=True, **kw)
    np.testing.assert_array_equal(img_d, img_p)
    assert st_d["segments"] == st_p["segments"] and st_d["windows"] > 1
    assert st_d["direct_rec"] and not st_p["direct_rec"]
    with pytest.raises(ValueError, match="queue_ik"):
        regen.render_regen(scene, cam, direct_rec=True, schedule="queue",
                           **kw)
    quads, qcam = treg.quads_scene()
    with pytest.raises(ValueError, match="image"):
        regen.render_regen(quads, qcam, direct_rec=True, **kw)
