"""The port's plain bounce core (`ops/bounce._bounce_core_ref`, what the
fused kernels' plain versions run) against the JAX package's Pallas
`bounce` in interpret mode, with the same uniforms, on the features the
fused kernels gained with book3 and cornellSmoke: constant-density media
(a rotated box and a sphere) with isotropic scattering, a hollow glass
bubble (negative radius: the deferred normal divides by the signed radius),
and metal beside glass and a sphere light. These mirror the JAX package's
tests/test_pallas_bounce.py cases of the same names.

Tolerances are tests/test_torch_bounce_ext.py's (`compare_bounce`): alive
equal on > 0.999 of the lanes, and on the agreeing lanes E within rtol =
atol = 2e-3 everywhere, W, the clamp flag and the new ray on > 0.999 of
them (a ray grazing an edge, or a free-flight distance at a medium's far
boundary, may take the other branch under other rounding)."""

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import jax.numpy as jnp
import numpy as np
import torch

from go_raytracer_tpu.ops.pallas import bounce as jpb
from go_raytracer_tpu.scene.builder import SceneBuilder as JBuilder
from go_raytracer_tpu_torch.ops import bounce as tpb
from go_raytracer_tpu_torch.scene import types as TT
from tests.test_torch_bounce_ext import compare_bounce

torch.set_num_threads(2)
N = 4096


def _core_vs_pallas(js, seed, origin_rng=(50, 500), dir_scale=300):
    """One bounce of N alive-or-dead lanes through both; returns the
    port's (E, W, alive') as numpy after `compare_bounce`."""
    ts = TT.scene_from_numpy(js)
    st = tpb.scene_statics(ts)
    assert st == jpb.scene_statics(js) and tpb.supported_statics(st)
    rs = np.random.default_rng(seed)
    o = rs.uniform(*origin_rng, (N, 3)).astype(np.float32)
    d = (rs.normal(size=(N, 3)) * dir_scale).astype(np.float32)
    tm = rs.uniform(0, 1, N).astype(np.float32)
    alive = rs.uniform(size=N) >= 0.1
    u = rs.random((N, tpb.N_U + st["n_media"])).astype(np.float32)
    jout = jpb.bounce(jpb.pack_scene(js), jpb.scene_statics(js),
                      jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                      jnp.asarray(alive), jnp.asarray(u), js.background,
                      interpret=True)
    tables = tuple(torch.from_numpy(t) for t in tpb.pack_scene(ts))
    tt = torch.from_numpy
    (vr, vg, vb, emit, cf, nox, noy, noz, ndx, ndy, ndz, na) = \
        tpb._bounce_core_ref(st, tables[0], tables[1],
                             list(map(float, ts.background)), tt(o[:, 0]),
                             tt(o[:, 1]), tt(o[:, 2]), tt(d[:, 0]),
                             tt(d[:, 1]), tt(d[:, 2]), tt(alive),
                             [tt(np.ascontiguousarray(u[:, k]))
                              for k in range(u.shape[1])],
                             tm=tt(tm), med=tables[2])
    V = torch.stack([vr, vg, vb], dim=-1)
    zero = torch.zeros_like(V)
    pout = (torch.where(emit[:, None], V, zero),
            torch.where(emit[:, None], zero, V), cf,
            torch.stack([nox, noy, noz], dim=-1),
            torch.stack([ndx, ndy, ndz], dim=-1), na & tt(alive))
    return compare_bounce(jout, pout, alive)


def test_core_media_matches_pallas():
    """A rotated box medium and a sphere medium in a Cornell-like room
    (the JAX package's media case): free flights, isotropic scattering
    and the forced front face."""
    b = JBuilder(background=(0, 0, 0))
    white = b.lambertian((0.73, 0.73, 0.73))
    b.quad((555, 0, 0), (0, 555, 0), (0, 0, 555),
           b.lambertian((0.12, 0.45, 0.15)))
    b.quad((0, 0, 0), (555, 0, 0), (0, 0, 555), white)
    b.add_light(b.quad((343, 550, 332), (-130, 0, 0), (0, 0, -105),
                       b.diffuse_light((7, 7, 7))))
    b.constant_medium_box((0, 0, 0), (165, 330, 165), 0.01, albedo=(0, 0, 0),
                          rotate_y_deg=15, translate=(265, 0, 295))
    b.constant_medium_sphere((130, 150, 130), 100, 0.02,
                             albedo=(0.8, 0.4, 0.2))
    js = b.build()
    pE, pW, pna = _core_vs_pallas(js, seed=5)
    # some lanes scatter inside a medium: an isotropic weight is the
    # albedo times the pdf ratio, so the sphere's (0.8, 0.4, 0.2) shows
    iso = pna & np.isclose(pW[:, 0], 2.0 * pW[:, 1], rtol=1e-5) \
        & np.isclose(pW[:, 1], 2.0 * pW[:, 2], rtol=1e-5) & (pW[:, 2] > 0)
    assert iso.sum() > 20


def test_core_hollow_bubble_matches_pallas():
    """A glass sphere with a negative-radius bubble inside (hollow glass):
    the deferred sphere normal divides by the signed radius, so the
    bubble's normal points inward and its front face flips."""
    b = JBuilder(background=(0.3, 0.4, 0.5))
    glass = b.dielectric(1.5)
    b.sphere((0, 0, -3), 1.0, glass)
    b.sphere((0, 0, -3), -0.85, glass)
    b.sphere((0, -101, 0), 100.0, b.lambertian((0.7, 0.7, 0.7)))
    b.add_light(b.quad((-1, 4, -4), (2, 0, 0), (0, 0, 2),
                       b.diffuse_light((6, 6, 6))))
    js = b.build()
    _, pW, pna = _core_vs_pallas(js, seed=2, origin_rng=(-4, 4), dir_scale=3)
    glass_w = pna & (pW == 1.0).all(axis=-1)
    assert glass_w.sum() > 50


def test_core_metal_glass_sphere_light_matches_pallas():
    """Metal (fuzzed) and glass spheres, a moving sphere (the ray time
    moves its centre), a rotated box, a quad light and a sphere light in
    one room: the fr column carries the fuzz and the index side by side."""
    from go_raytracer_tpu.scene.builder import Transform

    b = JBuilder(background=(0.05, 0.1, 0.15))
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    light = b.diffuse_light((15, 15, 15))
    b.quad((555, 0, 0), (0, 555, 0), (0, 0, 555), red)
    b.quad((0, 0, 0), (555, 0, 0), (0, 0, 555), white)
    b.add_light(b.quad((343, 550, 332), (-130, 0, 0), (0, 0, -105), light))
    b.sphere((190, 90, 190), 90, b.dielectric(1.5))
    b.sphere((400, 90, 120), 90, b.metal((0.8, 0.85, 0.9), 0.2),
             center2=(400, 120, 120))
    b.box((0, 0, 0), (100, 200, 100), white,
          transform=Transform(rotate_y_deg=-18, translate=(300, 0, 350)))
    b.add_light(b.sphere((130, 500, 130), 40, light))
    js = b.build()
    ts = TT.scene_from_numpy(js)
    st = tpb.scene_statics(ts)
    assert st["has_metal"] and st["has_dielectric"] and st["n_sph"] == 3
    assert tpb.fused_features(st) == 3
    _, pW, pna = _core_vs_pallas(js, seed=0)
    assert (pna & (pW == 1.0).all(axis=-1)).sum() > 50


def test_core_textures_match_pallas():
    """One primitive of each texture kind the fused kernels gained: a
    checker ground sphere (negative coordinates: the parity is a floor-mod)
    and a checker quad, and perlin, marble and turbulent noise spheres,
    beside a quad light. Only marble is in a registry scene, so this is
    where perlin and turbulent are held. The W planes of the lanes each
    texture shades must agree (`compare_bounce`: all but 1e-3 of the
    lanes; a checker cell boundary or a noise value carried by a rounding
    of the hit point may differ on a few)."""
    b = JBuilder(background=(0.2, 0.3, 0.4))
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(
        tex=b.checker(0.32, (0.2, 0.3, 0.1), (0.9, 0.9, 0.9))))
    b.quad((-8, 0.01, -8.8), (16, 0, 0), (0, 6, 0), b.lambertian(
        tex=b.checker(0.5, (0.8, 0.1, 0.1), (0.1, 0.1, 0.8))))
    kinds = ("perlin", "marble", "turbulent")
    centres = [(-4.0, 1.5, 0.0), (0.0, 1.5, 0.0), (4.0, 1.5, 0.0)]
    for k, c in zip(kinds, centres):
        b.sphere(c, 1.5, b.lambertian(tex=b.noise_texture(4, k)))
    b.add_light(b.quad((-3, 7, -3), (6, 0, 0), (0, 0, 6),
                       b.diffuse_light((6, 6, 6))))
    js = b.build()
    st = tpb.scene_statics(TT.scene_from_numpy(js))
    assert st["has_noise"] and st["has_checker"]
    assert tpb.fused_features(st) == 1 | 8
    pE, pW, pna = _core_vs_pallas(js, seed=11, origin_rng=(-7, 7),
                                  dir_scale=3)
    # every texture was met: noise spheres shade gray (r == g == b, not a
    # solid albedo), checker lanes their two colours
    gray = pna & (pW[:, 0] == pW[:, 1]) & (pW[:, 1] == pW[:, 2]) \
        & (pW[:, 0] > 0)
    assert gray.sum() > 100
    ratio = lambda c: np.isclose(pW[:, 0] / np.maximum(pW[:, 1], 1e-30), c,
                                 rtol=1e-4)
    assert (pna & ratio(0.2 / 0.3)).sum() > 20      # ground, even cells
    assert (pna & ratio(8.0)).sum() > 20            # quad, even cells
