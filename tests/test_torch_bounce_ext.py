"""The mesh path's bounce of the port against the JAX package on scene 8:
the external mesh-hit planes, and the plain version of the `bounce` kernel
against the Pallas kernel in interpret mode with the same uniforms; also
the dense-only mode on spheres, metal, a box, and sphere and quad lights."""

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_raytracer_tpu.ops import intersect as jix
from go_raytracer_tpu.ops.pallas import bounce as jpb
from go_raytracer_tpu.scene.builder import SceneBuilder as JBuilder
from go_raytracer_tpu.scenes import registry as jreg
from go_raytracer_tpu_torch.ops import bounce as tpb
from go_raytracer_tpu_torch.ops import intersect as tix
from go_raytracer_tpu_torch.ops import trace as ttrace
from go_raytracer_tpu_torch.scene import types as TT

torch.set_num_threads(2)
INF = float("inf")
N = 4096
# the repo's Pallas-vs-XLA bound (tests/test_pallas_bounce.py)
RTOL = ATOL = 2e-3


@pytest.fixture(scope="module")
def scene8():
    js, _ = jreg.model_example()
    ts = TT.scene_from_numpy(js)
    st = tpb.scene_statics(ts, ext=True)
    ms = ttrace.to_device(ts, "cpu")
    tables = tuple(torch.from_numpy(t) for t in tpb.pack_scene(ts))
    tri_mat = torch.from_numpy(tpb.tri_mat_table(ts, st))
    return js, ts, st, ms, tables, tri_mat


def mesh_planes(ms, st, tri_mat, o, d, t_cap, alive, **route):
    """The ext planes the JAX package's `mesh_ext_planes` gives: the
    port's mesh closest hit pruned by `t_cap` (`ops/trace.mesh_closest` on
    `route`), then the plain gather on its winner
    (`ops/bounce.ext_planes_from_hit`)."""
    hit = tpb.MeshHit(*ttrace.mesh_closest(ms, o, d, t_cap=t_cap,
                                           alive=alive, **route))
    return tpb.ext_planes_from_hit(st, tpb.TriTable(ms.triangles, tri_mat),
                                   o, d, hit, t_cap=t_cap)


def bundle(seed, lo=-6.0, hi=8.0, dead_frac=0.1):
    rs = np.random.default_rng(seed)
    o = rs.uniform(lo, hi, (N, 3)).astype(np.float32)
    d = rs.normal(size=(N, 3)).astype(np.float32)
    alive = rs.uniform(size=N) >= dead_frac
    u = rs.random((N, 9)).astype(np.float32)
    return o, d, np.zeros(N, np.float32), alive, u


def test_dense_caps_match_jax(scene8):
    """sphere_ts, quad_ts and box_ts (the t_cap pass): the same hit set
    on > 0.999 of the pairs, t within rtol 1e-4 on > 0.995 of the hits and
    within 1e-2 on all (the radius-1000 ground sphere's quadratic cancels
    several digits in float32, and the two matmuls sum in different
    orders)."""
    js, ts, st, ms, _, _ = scene8
    o, d, tm, _, _ = bundle(1)
    tt = torch.from_numpy
    j = np.asarray(jix.sphere_ts(js.spheres, jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(tm), 1e-3, jnp.inf))
    p = tix.sphere_ts(ms.spheres, tt(o), tt(d), tt(tm), 1e-3, INF).numpy()
    assert (np.isfinite(j) == np.isfinite(p)).mean() > 0.999
    both = np.isfinite(j) & np.isfinite(p)
    assert np.isclose(p[both], j[both], rtol=1e-4).mean() > 0.995
    np.testing.assert_allclose(p[both], j[both], rtol=1e-2)
    cs, _ = jreg.cornell_box()
    mc = ttrace.to_device(TT.scene_from_numpy(cs), "cpu")
    o2 = (o * 30 + 250).astype(np.float32)
    for jf, tf, jt, tt_ in ((jix.quad_ts, tix.quad_ts, cs.quads, mc.quads),
                            (jix.box_ts, tix.box_ts, cs.boxes, mc.boxes)):
        j = np.asarray(jf(jt, jnp.asarray(o2), jnp.asarray(d), 1e-3, jnp.inf))
        p = tf(tt_, tt(o2), tt(d), 1e-3, INF).numpy()
        assert (np.isfinite(j) == np.isfinite(p)).mean() > 0.999
        both = np.isfinite(j) & np.isfinite(p)
        assert both.sum() > 1000
        assert np.isclose(p[both], j[both], rtol=1e-4).mean() > 0.995
        np.testing.assert_allclose(p[both], j[both], rtol=1e-2)


def test_mesh_ext_planes_match_jax(scene8):
    """Same o, d, t_cap, alive. The JAX package's CPU route is its plain
    skip-link walk, the port's the binned intersector: the hit set agrees
    on > 0.999 of the lanes, and where both hit, t within rtol 1e-5,
    normals within 1e-5 and the material columns exactly."""
    js, ts, st, ms, _, tri_mat = scene8
    o, d, tm, alive, _ = bundle(3)
    jcap = jix.sphere_ts(js.spheres, jnp.asarray(o), jnp.asarray(d),
                         jnp.asarray(tm), 1e-3, jnp.inf).min(axis=1)
    jst = jpb.scene_statics(js, ext=True)
    jext = jpb.mesh_ext_planes(js, jst, jnp.asarray(o), jnp.asarray(d), jcap,
                               jnp.asarray(alive), interpret=True)
    tt = torch.from_numpy
    cap = tt(np.array(jcap))
    for route in ("binned", "walk"):
        pext = mesh_planes(ms, st, tri_mat, tt(o), tt(d), cap, tt(alive),
                           mesh=route)
        assert len(pext) == len(jext) == 12
        jhit = np.isfinite(np.asarray(jext[0])) & alive
        phit = np.isfinite(pext[0].numpy())
        assert not phit[~alive].any()
        assert (jhit == phit).mean() > 0.999 and phit.sum() > 300
        bothh = jhit & phit
        np.testing.assert_allclose(pext[0].numpy()[bothh],
                                   np.asarray(jext[0])[bothh], rtol=1e-5)
        for k in (1, 2, 3):
            np.testing.assert_allclose(pext[k].numpy()[bothh],
                                       np.asarray(jext[k])[bothh], atol=1e-5)
        for k in range(4, 12):
            np.testing.assert_array_equal(pext[k].numpy()[bothh],
                                          np.asarray(jext[k])[bothh])


def compare_bounce(jout, pout, alive):
    jE, jW, jcf, jno, jnd, jna = (np.asarray(x) for x in jout[:6])
    pE, pW, pcf, pno, pnd, pna = (x.numpy() for x in pout[:6])
    assert (jna == pna).mean() > 0.999
    agree = jna == pna
    assert np.isclose(pE[agree], jE[agree], rtol=RTOL, atol=ATOL).all()
    w_ok = np.isclose(pW[agree], jW[agree], rtol=RTOL, atol=ATOL,
                      equal_nan=True).all(axis=-1)
    assert w_ok.mean() > 0.999
    assert (pcf == jcf)[agree].mean() > 0.999
    go_on = agree & pna
    assert np.isclose(pno[go_on], jno[go_on], rtol=RTOL, atol=ATOL).mean() > 0.999
    assert np.isclose(pnd[go_on], jnd[go_on], rtol=RTOL, atol=ATOL).mean() > 0.999
    assert not pna[~alive].any() and not pE[~alive].any() and not pW[~alive].any()
    return pE, pW, pna


def test_bounce_ref_matches_pallas_kernel_on_scene8(scene8):
    """`bounce_ref` against `pb.bounce(interpret=True, ext=ext)` with the
    same u and the same ext planes: alive equal on > 0.999 of the lanes,
    E within rtol = atol = 2e-3 and W, cf, new origin and direction
    within it on > 0.999 of the agreeing lanes (a lane grazing the ground
    sphere may take the other root). Mesh hits, ground, sun and sky all
    occur."""
    js, ts, st, ms, tables, tri_mat = scene8
    o, d, tm, alive, u = bundle(3)
    tt = torch.from_numpy
    cap = tix.sphere_ts(ms.spheres, tt(o), tt(d), tt(tm), 1e-3, INF).amin(dim=1)
    ext = mesh_planes(ms, st, tri_mat, tt(o), tt(d), cap, tt(alive))
    jst = jpb.scene_statics(js, ext=True)
    jout = jpb.bounce(jpb.pack_scene(js), jst, jnp.asarray(o), jnp.asarray(d),
                      jnp.asarray(tm), jnp.asarray(alive), jnp.asarray(u),
                      js.background, interpret=True,
                      ext=tuple(jnp.asarray(e.numpy()) for e in ext))
    pout = tpb.bounce(tables, st, tt(o), tt(d), tt(tm), tt(alive), tt(u),
                      tt(np.asarray(ts.background)), ext=ext)
    pE, pW, pna = compare_bounce(jout, pout, alive)
    mesh_won = np.isfinite(ext[0].numpy()) & alive
    assert mesh_won.sum() > 300                      # the gold statue
    assert (pW[mesh_won] > 0).any(axis=-1).mean() > 0.9   # metal reflects
    assert (pE > 0).any(axis=-1).sum() > 10          # the sun
    assert 0.3 < pna.mean() < 0.95
    assert tpb.launches_bounce == 0                  # CPU tensors never launch
    # given output buffers are written in place, with the same values
    out = tpb.bounce_out(o.shape[0], "cpu")
    pout2 = tpb.bounce(tables, st, tt(o), tt(d), tt(tm), tt(alive), tt(u),
                       tt(np.asarray(ts.background)), ext=ext, out=out)
    assert all(a is b for a, b in zip(pout2[:6], out)) and pout2[6] is None
    assert all(torch.equal(a, b) for a, b in zip(pout2[:6], pout[:6]))


def test_bounce_ref_matches_pallas_kernel_dense_only():
    """ext off: two spheres (one metal), a rotated fused box, a sphere
    light and a quad light, against the Pallas kernel on the same u."""
    from go_raytracer_tpu.scene.builder import Transform

    b = JBuilder(background=(0.1, 0.2, 0.3))
    b.sphere((0, -1000, 0), 1000, b.lambertian((0.4, 0.4, 0.4)))
    b.sphere((0, 1.5, 0), 1.5, b.metal((0.9, 0.8, 0.1), 0.3))
    b.box((-4, 0, -1), (-2, 2, 1), b.lambertian((0.7, 0.2, 0.2)),
          transform=Transform(rotate_y_deg=20))
    b.add_light(b.sphere((5, 8, 5), 2, b.diffuse_light((4, 4, 4))))
    b.add_light(b.quad((-2, 6, -2), (2, 0, 0), (0, 0, 2),
                       b.diffuse_light((3, 3, 3))))
    js = b.build()
    ts = TT.scene_from_numpy(js)
    st = tpb.scene_statics(ts)
    assert st == jpb.scene_statics(js) and tpb.supported_ext_statics(st)
    assert st["n_sph"] == 3 and st["n_box"] == 1 and st["has_metal"]
    o, d, tm, alive, u = bundle(8, lo=-7.0, hi=7.0)
    o[:, 1] = np.abs(o[:, 1]) + 0.05
    tt = torch.from_numpy
    jout = jpb.bounce(jpb.pack_scene(js), jpb.scene_statics(js),
                      jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                      jnp.asarray(alive), jnp.asarray(u), js.background,
                      interpret=True)
    pout = tpb.bounce(tuple(tt(t) for t in tpb.pack_scene(ts)), st, tt(o),
                      tt(d), tt(tm), tt(alive), tt(u),
                      tt(np.asarray(ts.background)))
    pE, pW, pna = compare_bounce(jout, pout, alive)
    assert 0.2 < pna.mean() < 0.95
    with pytest.raises(ValueError, match="ext"):
        tpb.bounce_ref(None, dict(st, ext_hit=True), None, None, None, None,
                       None, None)


def test_unsupported_scenes_raise(scene8):
    """Outside `supported_ext` nothing falls back: statics over the media
    or light caps raise (dielectric, media and image-textured meshes are
    inside it now, as in the JAX package's `supported_ext`)."""
    js, ts, st, ms, tables, tri_mat = scene8
    assert tpb.supported_ext_statics(dict(st, has_dielectric=True))
    with pytest.raises(NotImplementedError, match="subset"):
        tpb.bounce_ref(tables, dict(st, n_media=tpb.MAX_MEDIA + 1), None,
                       None, None, None, None, None)
    with pytest.raises(NotImplementedError, match="subset"):
        tpb.bounce_ref(tables, dict(st, n_lights_live=0), None, None, None,
                       None, None, None)
