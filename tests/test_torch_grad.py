"""The port's gradients (autograd over `integrator/wavefront.radiance`,
mode "scan", backend "xla") against `jax.grad` of the JAX package's
`radiance`, on the same rays and JAX's own per-level uniforms (fed to the
port through `radiance(uniforms=...)`), for every `extract_params` leaf
the scene reads and for the camera's origin.

Tolerances, per leaf, on the largest difference relative to the largest
entry of JAX's gradient of that leaf:
- pathwise leaves (texture colours, background, fuzz, the camera),
  PATHWISE_RTOL: the two packages run the same float32 arithmetic in
  another order, so the gradients differ by float32 roundings of the
  per-lane terms summed over the lanes (at most 4e-6 on these scenes);
- score-function leaves (ref_idx through the Schlick choice, the media
  density through the transit likelihood), SCORE_RTOL: each lane adds
  L * dlog p, and a lane whose reflect/refract choice or free flight one
  package's rounding flipped would carry the whole of another path's
  value; on these inputs no lane flips (1e-6 measured), and the bound
  leaves room for a few flips in thousands of lanes;
- modelExample, MESH_RTOL: the triangle hit comes from each package's own
  BVH walk (JAX's skip-link walk on the CPU, the port's walk), whose hit
  sets agree on more than 0.999 of lanes (ROADMAP §3; 9e-7 measured)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from go_raytracer_tpu.integrator import wavefront as jwf
from go_raytracer_tpu.parallel import mesh as jmesh
from go_raytracer_tpu.render import camera as jcam
from go_raytracer_tpu.scene import types as JT
from go_raytracer_tpu.scene.builder import SceneBuilder
from go_raytracer_tpu.scenes import registry as jreg
from go_raytracer_tpu_torch.integrator import wavefront as twf
from go_raytracer_tpu_torch.ops import trace as ttrace
from go_raytracer_tpu_torch.parallel import mesh as tmesh
from go_raytracer_tpu_torch.render import camera as tcam
from go_raytracer_tpu_torch.scene import types as TT
from tests.test_torch_wavefront import jax_uniforms

torch.set_num_threads(2)

PATHWISE_RTOL = 1e-4
SCORE_RTOL = 1e-3
MESH_RTOL = 2e-3
SCORE_LEAVES = ("ref_idx", "med_neg_inv_density")


def _loss_jax(js, o, d, t, key, depth, max_c):
    params = jmesh.extract_params(js)

    def f(p):
        L, _ = jwf.radiance(jmesh.apply_params(js, dict(params, **p)),
                            jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
                            key, depth, max_c, mode="scan")
        return jnp.nan_to_num(L).mean()
    return f, params


def grads_both(js, o, d, t, key, depth, max_c, leaves=None):
    """{leaf: (JAX's gradient, the port's)} of nan_to_num(L).mean() over
    the rays (o, d, t) (numpy), the port fed JAX's uniforms."""
    f, params = _loss_jax(js, o, d, t, key, depth, max_c)
    wrt = list(leaves or params)
    gj = jax.jit(jax.grad(f))({k: params[k] for k in wrt})
    ds = ttrace.to_device(TT.scene_from_numpy(js), "cpu")
    tp = tmesh.params_from_numpy({k: np.asarray(params[k]) for k in wrt})
    for v in tp.values():
        v.requires_grad_(True)
    us = jax_uniforms(key, depth + 1, o.shape[0], 9 + js.media.count)
    L, _ = twf.radiance(tmesh.apply_params(ds, tp),
                        *(torch.from_numpy(np.asarray(x)) for x in (o, d, t)),
                        None, depth, max_c, mode="scan",
                        uniforms=torch.from_numpy(us))
    torch.nan_to_num(L).mean().backward()
    return {k: (np.asarray(gj[k]),
                np.zeros_like(np.asarray(gj[k])) if tp[k].grad is None
                else tp[k].grad.numpy()) for k in wrt}


def assert_leaves_agree(gs, rtol=None, must_move=()):
    for k, (gj, gt) in gs.items():
        tol = rtol or (SCORE_RTOL if k in SCORE_LEAVES else PATHWISE_RTOL)
        scale = float(np.abs(gj).max())
        assert np.isfinite(gt).all(), k
        err = float(np.abs(gt - gj).max())
        assert err <= tol * scale + 1e-9, (k, err, scale, gj, gt)
    for k in must_move:
        assert np.abs(gs[k][0]).max() > 0, f"JAX's {k} gradient is zero"


def _quad_light():
    b = SceneBuilder(background=(0.0, 0.0, 0.0))
    b.quad((-5, 0, -5), (10, 0, 0), (0, 0, 10), b.lambertian((0.6, 0.5, 0.4)))
    q = b.quad((-1, 4, -1), (2, 0, 0), (0, 0, 2), b.diffuse_light((3, 3, 3)))
    b.add_light(q)
    return b.build()


def _fan(n, o, d, seed, jitter):
    """n rays from o toward d, the directions jittered by a seeded normal."""
    rs = np.random.default_rng(seed)
    oo = np.tile(np.asarray([o], np.float32), (n, 1))
    dd = np.tile(np.asarray([d], np.float32), (n, 1))
    dd = (dd + rs.normal(0, 1, (n, 3)) * jitter).astype(np.float32)
    return oo, dd, np.zeros(n, np.float32)


def test_quad_light_leaves_match_jax_grad():
    """test_grad.py's quad/light scene: the ground albedo, the light's
    emission and the background (pathwise)."""
    o, d, t = _fan(512, (0.0, 2.0, 3.0), (0.05, -0.6, -1.0), 0, 0.0)
    gs = grads_both(_quad_light(), o, d, t, jax.random.key(11), 4, 1.5)
    assert_leaves_agree(gs, must_move=("tex_color",))


def test_metal_pane_fuzz_matches_jax_grad():
    b = SceneBuilder(background=(0.0, 0.0, 0.0))
    b.quad((-20, 0, -20), (40, 0, 0), (0, 0, 40),
           b.metal((0.9, 0.9, 0.9), 0.3))
    b.quad((-20, -20, -8), (40, 0, 0), (0, 40, 0),
           b.lambertian((0.7, 0.7, 0.7)))
    q = b.quad((-1, 7, -5), (2, 0, 0), (0, 0, 2), b.diffuse_light((8, 8, 8)))
    b.add_light(q)
    o, d, t = _fan(4096, (0.0, 3.0, 4.0), (0.0, -0.55, -1.0), 0, 0.0)
    gs = grads_both(b.build(), o, d, t, jax.random.key(7), 3, 10.0)
    assert_leaves_agree(gs, must_move=("fuzz", "tex_color"))


def test_glass_pane_ref_idx_matches_jax_grad():
    """The Schlick choice's score-function channel (SCORE_RTOL)."""
    b = SceneBuilder(background=(0.0, 0.0, 0.0))
    b.quad((-200, 0, -200), (400, 0, 0), (0, 0, 400),
           b.diffuse_light((1, 1, 1)))
    b.quad((-100, 2.5, -100), (0, 0, 200), (200, 0, 0), b.dielectric(1.5))
    q = b.quad((-200, 9, 200), (0, 0, -400), (400, 0, 0),
               b.diffuse_light((3, 3, 3)))
    b.add_light(q)
    o, d, t = _fan(8192, (0.0, 5.0, 6.0), (0.0, -0.6, -1.0), 1, 0.1)
    gs = grads_both(b.build(), o, d, t, jax.random.key(200), 3, 10.0)
    assert_leaves_agree(gs, must_move=("ref_idx",))


def test_fog_density_matches_jax_grad():
    """The media transit's score-function channel (SCORE_RTOL)."""
    b = SceneBuilder(background=(0.0, 0.0, 0.0))
    b.constant_medium_box((-2, -2, -2), (2, 2, 2), 0.4, albedo=(0.8, 0.8, 0.8))
    q = b.quad((-3, -3, -6), (6, 0, 0), (0, 6, 0), b.diffuse_light((4, 4, 4)))
    b.add_light(q)
    o, d, t = _fan(8192, (0.0, 0.0, 5.0), (0.0, 0.0, -1.0), 2, 0.1)
    gs = grads_both(b.build(), o, d, t, jax.random.key(5), 6, 1.5)
    assert_leaves_agree(gs, must_move=("med_neg_inv_density", "tex_color"))


def test_camera_origin_matches_jax_grad():
    """The camera-origin gradient (test_grad.py's camera translation):
    the port's CameraArrays carry tensors for center and pixel00, and
    generate_rays keeps them in the graph."""
    js = _quad_light()
    jc = jcam.Camera(width=16, aspect_ratio=1.0, samples_per_pixel=1,
                     max_depth=3, vertical_fov=60)
    jc.position((0, 2.5, 4), (0, 0, 0))
    ja = jc.derived()
    n = 16 * 16
    k_cam, k_path = jax.random.key(6), jax.random.key(8)

    def f(delta):
        arr = ja.replace(center=ja.center + delta,
                         pixel00=ja.pixel00 + delta)
        o, d, t = jcam.generate_rays(arr, 16, jnp.arange(n, dtype=jnp.int32),
                                     jnp.zeros(()), jnp.zeros(()), k_cam)
        L, _ = jwf.radiance(js, o, d, t, k_path, 3, 1.5, mode="scan")
        return jnp.nan_to_num(L).mean()

    gj = np.asarray(jax.jit(jax.grad(f))(jnp.zeros(3)))
    tc = tcam.Camera(width=16, aspect_ratio=1.0, samples_per_pixel=1,
                     max_depth=3, vertical_fov=60)
    tc.position((0, 2.5, 4), (0, 0, 0))
    ta = tc.derived()
    delta = torch.zeros(3, requires_grad=True)
    arr = dataclasses.replace(ta, center=torch.from_numpy(ta.center) + delta,
                              pixel00=torch.from_numpy(ta.pixel00) + delta)
    u_cam = torch.from_numpy(np.array(jax.random.uniform(k_cam, (n, 5))))
    zero = torch.zeros(())
    o, d, t = tcam.generate_rays(arr, 16, torch.arange(n), zero, zero, u_cam)
    ds = ttrace.to_device(TT.scene_from_numpy(js), "cpu")
    us = jax_uniforms(k_path, 4, n, 9 + js.media.count)
    L, _ = twf.radiance(ds, o, d, t, None, 3, 1.5,
                        uniforms=torch.from_numpy(us))
    torch.nan_to_num(L).mean().backward()
    gt = delta.grad.numpy()
    assert np.abs(gj).max() > 1e-4
    np.testing.assert_allclose(gt, gj, rtol=0,
                               atol=PATHWISE_RTOL * np.abs(gj).max())


def _registry_rays(js, jc, width, spp, key):
    """test_grad.py's scale layout: every pixel at every stratum, the rays
    from JAX's generate_rays."""
    jc.width, jc.aspect_ratio, jc.samples_per_pixel = width, 1.0, spp
    arrays = jc.derived()
    npix = width * jc.image_height
    sq = jc.spp_sqrt
    ids = jnp.tile(jnp.arange(npix, dtype=jnp.int32), sq * sq)
    st = jnp.repeat(jnp.arange(sq * sq, dtype=jnp.int32), npix)
    s_i = (st // sq).astype(jnp.float32)
    s_j = (st % sq).astype(jnp.float32)
    k_rays, k_path = jax.random.split(key)
    o, d, t = jcam.generate_rays(arrays, width, ids, s_i, s_j, k_rays)
    return np.asarray(o), np.asarray(d), np.asarray(t), k_path


def test_cornell_box_every_leaf_matches_jax_grad():
    """cornellBox at 32x32 @ 4 spp, depth 6, every leaf (the ones the
    scene does not read are zero in both)."""
    js, jc = jreg.cornell_box()
    o, d, t, k_path = _registry_rays(js, jc, 32, 4, jax.random.key(5))
    gs = grads_both(js, o, d, t, k_path, 6, jc.max_contribution)
    assert_leaves_agree(gs, must_move=("tex_color", "background"))
    for k in ("fuzz", "ref_idx", "med_neg_inv_density", "tex_even"):
        assert not np.any(gs[k][1]), k


def test_model_example_albedo_and_emission_match_jax_grad():
    """modelExample at 48x27, 1 spp, depth 4: the ground's albedo, the
    statue's colour and the sun's emission, the triangle hit from each
    package's BVH walk (no gradient through its t; MESH_RTOL)."""
    js, jc = jreg.model_example()
    jc.width, jc.samples_per_pixel = 48, 1
    arrays = jc.derived()
    npix = 48 * jc.image_height
    k_rays, k_path = jax.random.split(jax.random.key(3))
    o, d, t = jcam.generate_rays(arrays, 48, jnp.arange(npix, dtype=jnp.int32),
                                 jnp.zeros(()), jnp.zeros(()), k_rays)
    gs = grads_both(js, np.asarray(o), np.asarray(d), np.asarray(t), k_path,
                    4, jc.max_contribution, leaves=("tex_color",))
    gj, gt = gs["tex_color"]
    kinds = np.asarray(js.materials.kind)
    tex = np.asarray(js.materials.tex_id)
    for row in (tex[kinds == JT.MAT_LAMBERTIAN][0],
                tex[kinds == JT.MAT_METAL][0],
                tex[kinds == JT.MAT_DIFFUSE_LIGHT][0]):
        assert np.abs(gj[row]).max() > 0, row
    np.testing.assert_allclose(gt, gj, rtol=0,
                               atol=MESH_RTOL * np.abs(gj).max())


def test_sphere_light_pdf_backward_is_finite_on_the_light():
    """Where the solid angle is 0 (an origin so far from a sphere light
    that 1 - r^2 / dist^2 rounds to 1) or NaN (an origin on or inside
    the light), a lane gets the reference's inf or NaN pdf as a constant:
    the forward equals the JAX package's (NaN for NaN), and the backward
    of a loss that leaves those lanes out is finite in the port, where
    the JAX package's unguarded reciprocal gives NaN (0 times the
    reciprocal's infinite derivative; modelExample's fuzz gradient on the
    card)."""
    from go_raytracer_tpu.integrator import sampling as jsamp
    from go_raytracer_tpu_torch.integrator import sampling as tsamp

    b = SceneBuilder(background=(0.0, 0.0, 0.0))
    b.quad((-5, 0, -5), (10, 0, 0), (0, 0, 10), b.lambertian((0.5, 0.5, 0.5)))
    sun = b.sphere((0.0, 3.0, 0.0), 1.0, b.diffuse_light((4, 4, 4)))
    b.add_light(sun)
    js = b.build()
    ds = ttrace.to_device(TT.scene_from_numpy(js), "cpu")
    rs = np.random.default_rng(0)
    n = 4096
    # origins around the light's surface (radius 1 +- 1e-6), inside it,
    # near it, and 1e5 away (the solid angle rounds to 0)
    dirs = rs.normal(0, 1, (n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    radius = np.where(rs.uniform(size=n) < 0.5,
                      1.0 + rs.uniform(-1e-6, 1e-6, n),
                      rs.choice([0.5, 3.0, 1e5], n))
    o = (np.asarray([0.0, 3.0, 0.0]) + dirs * radius[:, None]).astype(
        np.float32)
    d = rs.normal(0, 1, (n, 3))
    aim = (radius > 10) & (rs.uniform(size=n) < 0.5)   # far, toward it
    d[aim] = -dirs[aim]
    d = d.astype(np.float32)
    pid = np.asarray(js.lights.prim_id)
    jp = np.asarray(jsamp._sphere_light_pdf(js, jnp.asarray(pid),
                                            jnp.asarray(o), jnp.asarray(d)))
    to = torch.from_numpy(o).requires_grad_(True)
    tp = tsamp._sphere_light_pdf(ds, torch.from_numpy(pid), to,
                                 torch.from_numpy(d))
    np.testing.assert_array_equal(tp.detach().numpy(), jp)
    bad = ~np.isfinite(jp)
    assert np.isnan(jp).any() and np.isinf(jp).any() and (~bad).any()
    good = torch.from_numpy(np.isfinite(jp))
    torch.where(good, tp, 0.0).sum().backward()
    assert torch.isfinite(to.grad).all()

    def jloss(oo):
        pdf = jsamp._sphere_light_pdf(js, jnp.asarray(pid), oo,
                                      jnp.asarray(d))
        return jnp.where(jnp.asarray(np.isfinite(jp)), pdf, 0.0).sum()
    assert not np.isfinite(np.asarray(jax.grad(jloss)(jnp.asarray(o)))).all()


def test_length_backward_is_finite_at_zero():
    """`core/vecmath.length` and `normalize`: the values are the unguarded
    formulas' bit for bit (0 at 0, NaN at NaN), and a masked-out zero
    vector gives a zero gradient, where the JAX package's unguarded sqrt
    gives NaN."""
    from go_raytracer_tpu.core import vecmath as jvm
    from go_raytracer_tpu_torch.core import vecmath as tvm

    rs = np.random.default_rng(1)
    v = rs.normal(0, 1, (64, 3)).astype(np.float32)
    v[:8] = 0.0
    v[8] = np.nan
    t = torch.from_numpy(v).requires_grad_(True)
    plain = torch.sqrt(torch.sum(t * t, dim=-1))
    np.testing.assert_array_equal(tvm.length(t).detach().numpy(),
                                  plain.detach().numpy())
    tiny = torch.finfo(torch.float32).tiny
    np.testing.assert_array_equal(
        tvm.normalize(t).detach().numpy(),
        (t / torch.clamp(plain[:, None], min=tiny)).detach().numpy())
    keep = torch.from_numpy(np.abs(v).sum(-1) > 0)
    torch.where(keep[:, None], tvm.normalize(t), 0.0).sum().backward()
    assert torch.isfinite(t.grad[:8]).all() and not t.grad[:8].any()
    assert torch.isfinite(t.grad[9:]).all()

    def jloss(x):
        return jnp.where(jnp.asarray(keep.numpy())[:, None],
                         jvm.normalize(x), 0.0).sum()
    assert np.isnan(np.asarray(jax.grad(jloss)(jnp.asarray(v)))[:8]).all()
