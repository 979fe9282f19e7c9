"""The port's `bounce_fused_q` against the JAX package's Pallas kernel
(interpret mode on the CPU), and its PRNG / item decomposition bit for bit.

Tolerances: take counts and starts are exact at the first level; later
levels may flip a lane whose ray grazes an edge (different rsqrt / sin /
cos rounding), so alive and flag mismatches stay below 1% of the lanes;
float planes use test_pallas_bounce.py's rtol/atol (2e-4 / 2e-3 for
origins, 2e-3 / 2e-3 for the rest) on lanes that agree."""

import dataclasses
import functools

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
from go_raytracer_tpu_torch.scene.builder import SceneBuilder as TSceneBuilder

torch.set_num_threads(2)

MISMATCH_FRAC = 0.01
# Fraction of the lanes that agree on their flags whose records may leave
# rtol = atol = 2e-3 (0: none may). On the textured scenes a hit point
# that differs by a rounding moves the texture: the marble's turbulence
# sums 7 octaves up to frequency 64 and is scaled by 10 inside the sine,
# so simpleLight's radius-1000 ground sphere, whose far hits carry its
# f32 acne (~2.5e-4 in position), moves a marble value by up to ~7e-3;
# book1's checker may flip a cell at a boundary. Measured: simpleLight
# 2.4e-4 (1 lane) at 1 level, 1.2e-3 at 3; book1 2.4e-4 and 6.5e-4.
# book2's marble sphere (scale 0.2, ~900 units from the camera) takes its
# turbulence at up to 64 x ~300, where a float32 resolves ~2e-3: camera
# rays one rounding apart shade it up to ~10% apart. Measured at 1 level:
# 12-13 lanes (2.9e-3-3.2e-3), every one a marble hit.
V_FRAC = {"simple_light": 2e-3, "book1": 5e-3, "book2": 1e-2}
# Fraction of the lanes alive in both whose new ray may leave the
# tolerances. book1's secondary rays leave its radius-1000 ground sphere,
# whose roots carry the f32 acne of docs/PERFORMANCE.md:688-700, and meet
# glass and fuzzed metal among 389 spheres: at 1 level no origin differs,
# at 3 levels 15 of the 987 lanes alive in both (1.52e-2, 3.7e-3 of all
# lanes) carry a ray ~1e-3 apart.
STATE_FRAC = {"book1": 0.02}


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


def image_records(js, jrec, jimg, probe, agree, planes=(0, 1, 2)):
    """The image lanes of a call on a scene with image textures: the JAX
    kernel's weight records (`planes` of `jrec`) patched with the texel
    (`patch_image_weight_planes`, as its windows do) replace `jrec`'s in
    place; returns, per level, the lanes where JAX and the port took a
    texel, those where both did and agree on their flags (`agree`), and the
    JAX and port texel indices (the JAX one from its uv and image-id planes
    through `image_texel_index`, which test_torch_image.py holds to
    `sampling.image_value` bit for bit; the port's from its `probe`)."""
    patched = jpb.patch_image_weight_planes(
        js, *[jnp.asarray(jrec[k]) for k in planes], jimg)
    for k, x in zip(planes, patched):
        jrec[k] = np.asarray(x)
    ratio, uu, vv, img_id = (np.asarray(x) for x in jimg)
    is_img = img_id >= 0
    data = torch.from_numpy(np.asarray(js.images.data))
    wh = torch.from_numpy(np.asarray(js.images.wh))
    j_idx = tpb.image_texel_index(
        wh, data.shape[1], data.shape[2],
        torch.from_numpy(np.where(is_img, img_id, 0).astype(np.int64)),
        torch.from_numpy(np.where(is_img, uu, 0)),
        torch.from_numpy(np.where(is_img, vv, 0))).numpy()
    t_idx = np.stack([p.numpy() for p in probe])
    both = is_img & (t_idx >= 0) & agree
    return is_img, t_idx >= 0, both, j_idx, t_idx


# On the image scenes, of the lanes that agree on their flags and took a
# texel in both, the fraction whose texel index may differ: a hit point one
# rounding apart lands in the next texel. Measured at one level: quads 0
# of 192 lanes; book2 1 of 321 (3.1e-3), a camera ray grazing the top of
# the earth sphere (outward normal y 0.973), whose root the discriminant's
# rounding moves by ~7e-3 units, ~5e-5 in u: the next texel column.
TEXEL_FRAC = {"book2": 1e-2}


@pytest.mark.parametrize("n_inner,scene", [
    (1, s) for s in ["cornell_box", "book3", "cornell_smoke", "simple_light",
                     "book1", "quads_scene", "book2"]]
    + [(3, s) for s in ["cornell_box", "book3", "cornell_smoke",
                        "simple_light", "book1", "quads_scene"]])
def test_bounce_fused_q_ref_matches_pallas(n_inner, scene):
    """cornellBox, book3 (glass sphere, sphere light, rotated box),
    cornellSmoke (two media: 2 more PRNG slots per level), simpleLight
    (marble noise), book1 (389 spheres, moving ones among them, a
    checker ground, metal, glass, defocus), quads (the earth image on a
    quad) and book2 (every feature, the earth image on a sphere; one level:
    ~20 s in interpret mode) tables, 4096 lanes, a mixed alive/depth state,
    the queue refilling at the first two levels: the plain PyTorch version
    against the JAX kernel in interpret mode, its records on image lanes
    patched with the texel as the JAX windows patch them."""
    js, jc = getattr(jreg, scene)()
    ts = TT.scene_from_numpy(js)
    jc.width, jc.samples_per_pixel = 32, 16
    npix, sqrt_spp, n = 32 * 32, 4, 4096
    state = [np.ascontiguousarray(x) for x in _lane_state(n)]
    seed4 = np.array([-123456789, 2, 100, npix * 16], np.int32)
    kw = dict(has_defocus=jc.defocus_angle > 0, max_depth=50,
              n_inner=n_inner, width=32, sqrt_spp=sqrt_spp, npix=npix)
    jout = jpb.bounce_fused_q(
        jpb.pack_scene(js), jpb.scene_statics(js), jpb.pack_camera(jc.derived()),
        js.background, jnp.asarray(seed4), *[jnp.asarray(x) for x in state],
        interpret=True, **kw)
    jrec, jimg, jseg, jtc, *jst = jax.tree.map(np.asarray, jout)
    jrec = list(jrec)
    tables = tuple(torch.from_numpy(t) for t in tpb.pack_scene(ts))
    tc = Camera(**{f.name: getattr(jc, f.name)
                   for f in dataclasses.fields(Camera)})
    probe = []
    fn = tpb.bounce_fused_q if jimg is None else functools.partial(
        tpb.bounce_fused_q_ref, probe=probe)
    tout = fn(
        tables, tpb.scene_statics(ts),
        torch.from_numpy(tpb.pack_camera(tc.derived())),
        torch.from_numpy(np.array(ts.background)), torch.from_numpy(seed4),
        *[torch.from_numpy(x) for x in state], **kw)
    trec, _, tseg, ttc, *tst = tout
    trec = [x.numpy() for x in trec]
    if jimg is not None:
        j_img, t_img, both_img, j_idx, t_idx = image_records(
            js, jrec, jimg, probe, (trec[3] & 7) == jrec[3])
        moved = (j_idx != t_idx)[both_img].mean()
        print(f"{scene}: image lanes per level JAX {j_img.sum(axis=1)} port "
              f"{t_img.sum(axis=1)}; texel moved on {moved:.2e} of "
              f"{both_img.sum()}")
        assert j_img[0].sum() >= 100 and t_img[0].sum() >= 100
        assert moved <= TEXEL_FRAC.get(scene, 0.0)
        same_texel = both_img & (j_idx == t_idx)
        for k in range(3):
            a, b = jrec[k][same_texel], trec[k][same_texel]
            assert np.allclose(b, a, rtol=2e-3, atol=2e-3)
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
        bad = ~np.isclose(b, a, rtol=2e-3, atol=2e-3, equal_nan=True)
        print(f"{scene}: V[{k}] beyond tolerance on {bad.mean():.2e}")
        assert bad.mean() <= V_FRAC.get(scene, 0.0)
    both = (tst[7] > 0) & (jst[7] > 0)
    for k, rtol in ((0, 2e-4), (1, 2e-4), (2, 2e-4), (3, 2e-3), (4, 2e-3),
                    (5, 2e-3)):
        bad = ~np.isclose(tst[k][both], jst[k][both], rtol=rtol, atol=2e-3)
        assert bad.mean() <= STATE_FRAC.get(scene, MISMATCH_FRAC)
    np.testing.assert_array_equal(tst[8][both], jst[8][both])
    np.testing.assert_array_equal(tst[6], jst[6])


def nine_media_scene():
    """A scene outside the fused kernels' subset: a quad light and nine
    constant-density spheres, one more medium than MAX_MEDIA."""
    b = TSceneBuilder(background=(0.1, 0.1, 0.1))
    b.add_light(b.quad((-1, 3, -1), (2, 0, 0), (0, 0, 2),
                       b.diffuse_light((4, 4, 4))))
    for m in range(tpb.MAX_MEDIA + 1):
        b.constant_medium_sphere((3.0 * m, 0, 0), 1.0, 0.5,
                                 albedo=(0.5, 0.5, 0.5))
    return b.build()


def test_cpu_wrapper_rejects_unsupported_statics():
    """A scene outside the kernel's subset (nine media) raises instead of
    running another path, and so does K9 on a scene with image textures
    (quads), as the JAX package's direct-record path refuses it."""
    ts = nine_media_scene()
    assert tpb.refused_features(ts) == [f"more than {tpb.MAX_MEDIA} media"]
    z = torch.zeros(256)
    zi = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        tpb.bounce_fused_q(
            tuple(torch.from_numpy(t) for t in tpb.pack_scene(ts)),
            tpb.scene_statics(ts), torch.zeros(1, 20), torch.zeros(3),
            torch.zeros(4, dtype=torch.int32), z, z, z, z, z, z, z, zi, zi,
            has_defocus=False, max_depth=4, width=4, sqrt_spp=1, npix=16)
    qs = TT.scene_from_numpy(jreg.quads_scene()[0])
    assert tpb.supported(qs)
    rec = [torch.zeros(2, 256)] * 3 + [torch.zeros(2, 256, dtype=torch.int32)]
    with pytest.raises(NotImplementedError, match="image textures"):
        tpb.bounce_fused_q_direct(
            tuple(torch.from_numpy(t) for t in tpb.pack_scene(qs)),
            tpb.scene_statics(qs), torch.zeros(1, 20), torch.zeros(3),
            torch.zeros(4, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
            rec, z, z, z, z, z, z, z, zi, zi, has_defocus=False, max_depth=4,
            width=4, sqrt_spp=1, npix=16)


def test_defocus_starts_match_pallas():
    """book1's camera (defocus 0.6, focus 10) over a scene that every
    camera ray misses (one sphere and the light far behind the camera), so
    a started lane's new origin is its camera ray's origin, the point of
    the defocus disk, and a light-sampled lane's new direction is the
    light sample minus origin + direction: both planes of every start
    from `bounce_fused_q_ref` against JAX's `bounce_fused_q` in interpret
    mode, and the origins inside the disk and spread over it."""
    from go_raytracer_tpu.scene.builder import SceneBuilder as JBuilder

    _, jc = jreg.book1()
    jc.width, jc.samples_per_pixel = 32, 16
    b = JBuilder(background=(0.5, 0.7, 1.0))
    b.sphere((130, 20, 30), 1.0, b.lambertian((0.5, 0.5, 0.5)))
    b.add_light(b.quad((120, 40, 20), (4, 0, 0), (0, 0, 4),
                       b.diffuse_light((4, 4, 4))))
    js = b.build()
    ts = TT.scene_from_numpy(js)
    npix, n = 32 * 18, 4096
    z = np.zeros(n, np.float32)
    state = [z, z, z, z, z, z, z, np.zeros(n, np.int32),
             np.zeros(n, np.int32)]
    seed4 = np.array([24681357, 1, 0, npix * 16], np.int32)
    kw = dict(has_defocus=True, max_depth=50, n_inner=1, width=32,
              sqrt_spp=4, npix=npix)
    jout = jpb.bounce_fused_q(
        jpb.pack_scene(js), jpb.scene_statics(js),
        jpb.pack_camera(jc.derived()), js.background, jnp.asarray(seed4),
        *[jnp.asarray(x) for x in state], interpret=True, **kw)
    jrec, _, _, jtc, *jst = jax.tree.map(np.asarray, jout)
    tc = Camera(**{f.name: getattr(jc, f.name)
                   for f in dataclasses.fields(Camera)})
    row = tpb.pack_camera(tc.derived())
    targs = (tuple(torch.from_numpy(t) for t in tpb.pack_scene(ts)),
             tpb.scene_statics(ts), torch.from_numpy(row),
             torch.from_numpy(np.array(ts.background)),
             torch.from_numpy(seed4), *[torch.from_numpy(x) for x in state])
    trec, _, _, ttc, *tst = tpb.bounce_fused_q(*targs, **kw)
    assert ttc[0].item() == jtc[0] == n
    started = (jrec[3][0] & 4) != 0
    assert started.all() and ((trec[3][0].numpy() & 4) != 0).all()
    # every ray missed: the records are the background, nothing goes on
    assert (jrec[3][0] & 2).all() and not tst[7].numpy().any()
    for k in range(3):
        np.testing.assert_allclose(tst[k].numpy(), jst[k], rtol=1e-5,
                                   atol=1e-5)
    # the other half's direction is the cosine sample about a missed hit's
    # zero normal, a don't-care: JAX's normalisation flushes its 1e-38
    # (subnormal) guard to zero and makes it NaN, this package's keeps it
    light = np.isfinite(np.stack(jst[3:6])).all(axis=0)
    assert 0.4 < light.mean() < 0.6
    for k in range(3, 6):
        np.testing.assert_allclose(tst[k].numpy()[light], jst[k][light],
                                   rtol=1e-5, atol=1e-5)
    centre, radius = row[0, 9:12], float(np.linalg.norm(row[0, 12:15]))
    dist = np.linalg.norm(np.stack([tst[k].numpy() for k in range(3)], 1)
                          - centre, axis=1)
    assert radius > 0.05 and dist.max() <= radius * 1.0001
    assert dist.std() > 0.15 * radius
    # without defocus every start leaves from the centre, exactly
    t0 = tpb.bounce_fused_q(*targs, **dict(kw, has_defocus=False))
    for k in range(3):
        assert (t0[4 + k].numpy() == centre[k]).all()
