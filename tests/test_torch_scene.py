"""The port's host side against the JAX package: scene compiler tables,
camera, kernel packing and statics must be identical (exact equality, same
dtypes and shapes) for every dense reference scene."""

import dataclasses

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest
import torch

from go_raytracer_tpu.ops.pallas import bounce as jpb
from go_raytracer_tpu.scenes import registry as jreg
from go_raytracer_tpu_torch.ops import bounce as tpb
from go_raytracer_tpu_torch.render import camera as tcam
from go_raytracer_tpu_torch.scene import types as TT
from go_raytracer_tpu_torch.scenes import registry as treg

torch.set_num_threads(2)


def _assert_tables_equal(js, ts):
    for f in dataclasses.fields(TT.Scene):
        a, b = getattr(js, f.name), getattr(ts, f.name)
        if dataclasses.is_dataclass(b):
            for g in dataclasses.fields(b):
                x = np.asarray(getattr(a, g.name))
                y = np.asarray(getattr(b, g.name))
                assert x.dtype == y.dtype and x.shape == y.shape, \
                    (f.name, g.name, x.dtype, y.dtype, x.shape, y.shape)
                np.testing.assert_array_equal(x, y, err_msg=f"{f.name}.{g.name}")
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f.name)


def _port_camera(jc):
    fields = [f.name for f in dataclasses.fields(tcam.Camera)]
    return tcam.Camera(**{k: getattr(jc, k) for k in fields})


@pytest.mark.parametrize("num", range(1, 8))
def test_scene_tables_and_packing_identical(num):
    """build() tables, scene_statics, pack_scene and pack_camera: exact."""
    js, jc = jreg.SCENES[num][1]()
    ts, tc = treg.SCENES[num][1]()
    assert jreg.SCENES[num][0] == treg.SCENES[num][0]
    _assert_tables_equal(js, ts)
    assert tpb.scene_statics(ts) == jpb.scene_statics(js)
    for x, y in zip(jpb.pack_scene(js), tpb.pack_scene(ts)):
        x = np.asarray(x)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(np.asarray(jpb.pack_camera(jc.derived())),
                                  tpb.pack_camera(tc.derived()))
    assert dataclasses.asdict(tc) == dataclasses.asdict(_port_camera(jc))


def test_camera_derived_identical():
    """Camera.derived at odd settings (defocus, non-square, tilted vup)."""
    _, jc = jreg.book1()
    jc.width, jc.aspect_ratio = 123, 1.7
    jc.position((3.0, -2.0, 7.5), (0.5, 1.0, -2.0), (0.1, 1.0, 0.2))
    tc = _port_camera(jc)
    ja, ta = jc.derived(), tc.derived()
    for name in ("center", "pixel00", "du", "dv", "defocus_u", "defocus_v"):
        x, y = np.asarray(getattr(ja, name)), getattr(ta, name)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert ta.defocus_angle == ja.defocus_angle
    assert ta.recip_spp_sqrt == ja.recip_spp_sqrt
    assert (tc.image_height, tc.spp_sqrt) == (jc.image_height, jc.spp_sqrt)


def test_scene_from_numpy_carries_jax_scene():
    """The JAX package's Scene, carried across, packs to the same tables
    as the port's own build."""
    js, _ = jreg.cornell_box()
    cs = TT.scene_from_numpy(js)
    ts, _ = treg.cornell_box()
    _assert_tables_equal(js, cs)
    assert cs.lights.n == ts.lights.n and cs.has_rot_boxes
    for x, y in zip(tpb.pack_scene(cs), tpb.pack_scene(ts)):
        np.testing.assert_array_equal(x, y)


def test_supported_is_the_cornell_subset():
    """Every dense reference scene is inside the fused kernels' subset
    (cornellBox, book3 with its glass sphere and sphere light, cornellSmoke
    with its media, simpleLight with its marble noise, book1 with its
    checker, 389 spheres and defocus, book2 and quads with their image
    textures); scene 8 (a mesh) is outside it and inside the ext-mode
    kernel's, which takes what the JAX package's `supported_ext` takes."""
    ok = {treg.SCENES[k][0]: tpb.supported(treg.SCENES[k][1]()[0])
          for k in range(1, 8)}
    assert ok == {"book1": True, "book2": True, "book3": True,
                  "simpleLight": True, "quads": True, "cornellBox": True,
                  "cornellSmoke": True}
    for k in (2, 5):
        sc = treg.SCENES[k][1]()[0]
        assert tpb.refused_features(sc) == [] and sc.has_image
        assert tpb.supported_ext_statics(tpb.scene_statics(sc, ext=True))
    mesh, _ = treg.model_example()
    assert not tpb.supported(mesh) and tpb.supported_ext(mesh)
    assert mesh.has_tri_bvh and tpb.supported_ext(treg.book3()[0]) \
        == jpb.supported_ext(jreg.book3()[0])


@pytest.mark.parametrize("name", ["simple_light", "book1"])
def test_noise_seeds_and_texture_columns_identical(name):
    """The noise is only as equal as its seeds: the port's registry builds
    simpleLight's and book1's tables as JAX's do, read through the packed
    prim table the kernels take: the Perlin seeds' bits in `seed_img`
    (simpleLight), book1's 389 sphere rows with their `center_delta` (its
    moving spheres) and the checker's `inv_scale` in `scale`."""
    js, _ = getattr(jreg, name)()
    ts, _ = getattr(treg, name)()
    np.testing.assert_array_equal(np.asarray(js.perlin.seed), ts.perlin.seed)
    jp, tp_ = np.asarray(jpb.pack_scene(js)[0]), tpb.pack_scene(ts)[0]
    np.testing.assert_array_equal(jp.view(np.uint32), tp_.view(np.uint32))
    st = tpb.scene_statics(ts)
    lay = tpb._mat_layout(st)
    col = lambda c: tpb.MAT_BASE + lay.index(c)
    live = tp_[:, 0] >= 0
    if name == "simple_light":
        noise = live & (tp_[:, col("texk")] == TT.TEX_MARBLE)
        assert noise.sum() == 2
        seeds = tp_[noise, col("seed_img")].view(np.uint32)
        assert set(seeds.tolist()) <= set(ts.perlin.seed.tolist())
        np.testing.assert_array_equal(tp_[noise, col("scale")], 4.0)
    else:
        assert st["n_sph"] == 389
        moving = live[:389] & (np.abs(tp_[:389, 4:7]).sum(axis=1) > 0)
        assert moving.sum() > 0
        np.testing.assert_array_equal(tp_[:389, 4:7],
                                      np.asarray(js.spheres.center_delta))
        ground = tp_[0]
        assert ground[7] == 1000.0
        np.testing.assert_allclose(ground[col("scale")], 1 / 0.32,
                                   rtol=1e-6)


@pytest.mark.parametrize("name", ["quads_scene", "book2"])
def test_image_scenes_carry_their_image_table(name):
    """quads and book2 carried across by `scene_from_numpy` (and built by
    the port's own registry) give the JAX image table, texture ids and
    packed columns exactly: `pack_scene` returns JAX's four tables bit for
    bit and then the texels and each image's (w, h), and the image row's
    `seed_img` column holds its image id."""
    js, _ = getattr(jreg, name)()
    cs = TT.scene_from_numpy(js)
    ts, _ = getattr(treg, name)()
    for sc in (cs, ts):
        _assert_tables_equal(js, sc)
        assert sc.has_image
        np.testing.assert_array_equal(sc.textures.image_id,
                                      np.asarray(js.textures.image_id))
        packed = tpb.pack_scene(sc)
        assert len(packed) == 6
        for x, y in zip(jpb.pack_scene(js), packed[:4]):
            x = np.asarray(x)
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x.view(np.uint32),
                                          y.view(np.uint32))
        data, wh = packed[4:]
        assert data.dtype == np.float32 and wh.dtype == np.int32
        assert data.flags.c_contiguous and wh.flags.c_contiguous
        np.testing.assert_array_equal(data, np.asarray(js.images.data))
        np.testing.assert_array_equal(wh, np.asarray(js.images.wh))
        assert tuple(wh[0]) == (1024, 512) and data.shape == (1, 512, 1024, 3)
    st = tpb.scene_statics(cs)
    lay = tpb._mat_layout(st)
    prims = packed[0]
    col = lambda c: tpb.MAT_BASE + lay.index(c)
    img_rows = (prims[:, 0] >= 0) & (prims[:, col("texk")] == TT.TEX_IMAGE)
    assert img_rows.sum() == 1
    np.testing.assert_array_equal(prims[img_rows, col("seed_img")], 0.0)
    assert tpb.fused_features(st) & tpb.FEAT_IMG \
        and tpb.fused_features(st) & 8
