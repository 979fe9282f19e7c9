"""K3 in full: the port's `bounce_ref` (the plain version the CUDA kernel
is held to, ops/bounce.py) against the JAX package's kernel
`pb.bounce(..., interpret=True)` in both modes, on the same rays, uniforms
and ext planes.

Dense mode, one case per feature set of the core (ops/bounce.
fused_features): cornellBox (no spheres, no fr column, no media, no
textures), book3 (spheres and glass), cornellSmoke (media), simpleLight
(noise), book1 (checker, 389 spheres, metal and glass), quads (images and
noise) and book2 (every feature). JAX's weight is taken after its
`patch_image_weight`, the texel the port reads inside the bounce.
Ext mode: scene 8 with a glass sphere and a fog medium beside the statue
(`scenes/synthetic.glass_fog_statue`) and an image-textured mesh
(`synthetic.image_mesh`, whose uv rides the two ext planes after the
normal).

Tolerances: the integer outputs (alive', the clamp flag) are equal on
every lane but a flip fraction FLIP (a rounding that sends a grazing ray
or a glass choice the other way); E, W and the continuing rays within
RTOL relative and ATOL absolute (tests/test_pallas_bounce.py's bound) on
at least 1 - FLIP of the agreeing lanes (0.995 for the ext meshes, the W
bound of tests/test_mesh_ext.py)."""

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_raytracer_tpu.ops import intersect as jix
from go_raytracer_tpu.ops.pallas import bounce as jpb
from go_raytracer_tpu.scene import builder as jbuilder, obj_loader as jol
from go_raytracer_tpu.scenes import registry as jreg
from go_raytracer_tpu_torch.ops import bounce as tpb
from go_raytracer_tpu_torch.ops import trace as ttrace
from go_raytracer_tpu_torch.render import camera as tcam
from go_raytracer_tpu_torch.scene import types as TT
from go_raytracer_tpu_torch.scenes import registry as treg
from go_raytracer_tpu_torch.scenes import synthetic as syn
from tests.test_torch_bounce_ext import mesh_planes

torch.set_num_threads(2)

RTOL = ATOL = 2e-3
# flips per feature set (book3's glass: tests/test_torch_fused.py's
# 2.5e-3; book2's far marble and glass orb: chip_smoke's IMG_MISMATCH_FRAC)
FLIP = {"cornell_box": 0.0, "quads_scene": 0.0, "cornell_smoke": 0.0,
        "book3": 5e-3, "simple_light": 2e-3, "book1": 5e-3, "book2": 2e-2}
EXT_AGREE = 0.995
# lanes per case (one level at 512 or fewer, else two): the JAX kernel's
# interpret mode is slow on large tables and on the noise's octaves
LANES = {"book1": 512, "book2": 256, "quads_scene": 512, "simple_light": 512}


def compare(jout, tout, alive, frac):
    jE, jW, jcf, jno, jnd, jna = (np.asarray(x) for x in jout)
    tE, tW, tcf, tno, tnd, tna = (x.numpy() for x in tout[:6])
    flags = (jna == tna) & (jcf == tcf)
    assert flags.mean() >= 1 - frac, flags.mean()
    ok = flags & np.isclose(jE, tE, rtol=RTOL, atol=ATOL).all(-1) \
        & np.isclose(jW, tW, rtol=RTOL, atol=ATOL).all(-1)
    go = flags & tna
    ok[go] &= np.isclose(jno[go], tno[go], rtol=RTOL, atol=ATOL).all(-1) \
        & np.isclose(jnd[go], tnd[go], rtol=RTOL, atol=ATOL).all(-1)
    assert ok.mean() >= 1 - frac, ok.mean()
    assert not tna[~alive].any() and not tE[~alive].any() \
        and not tW[~alive].any()
    assert tout[6] is None
    return tna


# the texture feature sets (noise, images) are the slow ones under JAX's
# interpret mode: they run in tests/test_torch_bounce_textures.py
TEXTURED = ("simple_light", "quads_scene", "book2")


@pytest.mark.parametrize("name", [k for k in FLIP if k not in TEXTURED])
def test_dense_mode_every_feature_set(name):
    dense_case(name)


def dense_case(name):
    js, _ = getattr(jreg, name)()
    _, cam = getattr(treg, name)()
    ts = TT.scene_from_numpy(js)
    st = tpb.scene_statics(ts)
    assert tpb.supported(ts) and not st["ext_hit"]
    n = LANES.get(name, 1024)
    rs = np.random.default_rng(13)
    pid = torch.from_numpy(rs.integers(0, cam.width * cam.image_height, n))
    s = torch.zeros(n)
    o, d, t = (x.contiguous() for x in tcam.generate_rays(
        cam.derived(), cam.width, pid, s, s,
        torch.from_numpy(rs.uniform(0, 1, (n, 5)).astype(np.float32))))
    alive = torch.from_numpy(rs.uniform(size=n) > 0.1)
    tabs = tuple(torch.from_numpy(x) for x in tpb.pack_scene(ts))
    bg = torch.from_numpy(np.array(ts.background, np.float32))
    jtabs = jpb.pack_scene(js)
    jst = jpb.scene_statics(js)
    for level in range(2 if n > 512 else 1):
        u = rs.uniform(0, 1, (n, tpb.N_U + st["n_media"])).astype(np.float32)
        out = jpb.bounce(jtabs, jst, *(jnp.asarray(x.numpy()) for x in
                                       (o, d, t, alive)), jnp.asarray(u),
                         js.background, interpret=True)
        jW = jpb.patch_image_weight(js, out[1], out[6])
        tout = tpb.bounce(tabs, st, o, d, t, alive, torch.from_numpy(u), bg)
        tna = compare((out[0], jW) + tuple(out[2:6]), tout, alive.numpy(),
                      FLIP[name])
        o, d = tout[3], tout[4]
        alive = torch.from_numpy(tna.copy())


def ext_case(jscene, lanes, look):
    ts = TT.scene_from_numpy(jscene)
    assert tpb.supported_ext(ts) and jpb.supported_ext(jscene)
    st = tpb.scene_statics(ts, ext=True)
    ms = ttrace.to_device(ts, "cpu")
    rs = np.random.default_rng(17)
    o = (np.asarray(look[0], np.float32)
         + rs.normal(size=(lanes, 3)).astype(np.float32))
    d = (np.asarray(look[1], np.float32) - o
         + 3 * rs.normal(size=(lanes, 3))).astype(np.float32)
    t = np.zeros(lanes, np.float32)
    alive = rs.uniform(size=lanes) > 0.1
    u = rs.uniform(0, 1, (lanes, tpb.N_U + st["n_media"])).astype(np.float32)
    tt = torch.from_numpy
    cap = torch.full((lanes,), float("inf"))
    if ms.has_spheres:
        cap = torch.minimum(cap, tpb_sph(ms, tt(o), tt(d), tt(t)))
    if ms.has_quads:
        cap = torch.minimum(cap, tpb_quad(ms, tt(o), tt(d)))
    ext = mesh_planes(ms, st, tt(tpb.tri_mat_table(ts, st)), tt(o), tt(d),
                      cap, tt(alive))
    assert len(ext) == tpb.n_ext_planes(st)
    jst = jpb.scene_statics(jscene, ext=True)
    jst["cull"] = False
    jcap = jix.sphere_ts(jscene.spheres, jnp.asarray(o), jnp.asarray(d),
                         jnp.asarray(t), 1e-3, jnp.inf).min(axis=1)
    if jscene.has_quads:
        jcap = jnp.minimum(jcap, jix.quad_ts(jscene.quads, jnp.asarray(o),
                                             jnp.asarray(d), 1e-3,
                                             jnp.inf).min(axis=1))
    jext = jpb.mesh_ext_planes(jscene, jst, jnp.asarray(o), jnp.asarray(d),
                               jcap, jnp.asarray(alive), interpret=True)
    assert len(jext) == len(ext)
    # the planes themselves on the live lanes (the port's walk skips the
    # dead ones): t, normal, uv and the material columns
    for a, b in zip(jext, ext):
        a, b = np.asarray(a)[alive], b.numpy()[alive]
        fin = np.isfinite(a) & np.isfinite(b)
        assert (np.isfinite(a) == np.isfinite(b)).mean() >= EXT_AGREE
        assert np.isclose(a[fin], b[fin], rtol=RTOL, atol=ATOL).mean() \
            >= EXT_AGREE
    out = jpb.bounce(jpb.pack_scene(jscene), jst, jnp.asarray(o),
                     jnp.asarray(d), jnp.asarray(t), jnp.asarray(alive),
                     jnp.asarray(u), jscene.background, interpret=True,
                     ext=jext)
    jW = jpb.patch_image_weight(jscene, out[1], out[6])
    tout = tpb.bounce(tuple(tt(x) for x in tpb.pack_scene(ts)), st, tt(o),
                      tt(d), tt(t), tt(alive), tt(u),
                      tt(np.array(ts.background, np.float32)), ext=ext)
    tna = compare((out[0], jW) + tuple(out[2:6]), tout, alive,
                  1 - EXT_AGREE)
    return st, tna, ext


def tpb_sph(ms, o, d, t):
    from go_raytracer_tpu_torch.ops import intersect as tix
    return tix.sphere_ts(ms.spheres, o, d, t, 1e-3, float("inf")).amin(1)


def tpb_quad(ms, o, d):
    from go_raytracer_tpu_torch.ops import intersect as tix
    return tix.quad_ts(ms.quads, o, d, 1e-3, float("inf")).amin(1)


def test_ext_mode_glass_and_fog_beside_the_statue():
    b = jbuilder.SceneBuilder()
    look = syn.glass_fog_statue(b, jol, jbuilder.Transform)
    st, tna, ext = ext_case(b.build(), 1024, look)
    assert st["has_dielectric"] and st["n_media"] == 1
    assert tpb.fused_features(st) & 6 == 6        # the glass and media bits
    assert np.isfinite(ext[0].numpy()).mean() > 0.05   # the statue is hit
    assert 0.1 < tna.mean() < 0.99


def test_ext_mode_image_textured_mesh():
    b = jbuilder.SceneBuilder(background=(0.1, 0.1, 0.1))
    syn.image_mesh(b)
    st, tna, ext = ext_case(b.build(bvh_threshold=1), 1024,
                            ((0.0, 0.0, 9.0), (0.0, 0.0, 0.0)))
    assert st["has_image"] and tpb.fused_features(st) & tpb.FEAT_IMG
    hit = np.isfinite(ext[0].numpy())
    assert hit.mean() > 0.05
    # the uv planes (4, 5) hold the interpolated vertex uv of the hits
    uu, vv = ext[4].numpy()[hit], ext[5].numpy()[hit]
    assert (uu >= -1e-5).all() and (vv >= -1e-5).all() \
        and (uu + vv <= 1 + 1e-5).all()
