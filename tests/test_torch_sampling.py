"""The port's vector math, orthonormal basis, samplers and light/texture
sampling (core/vecmath.py, core/onb.py, core/rng.py,
integrator/sampling.py) against the JAX package's, on inputs made from a
numpy seed. Both run float32 op for op, so they agree within 1e-5
relative and 1e-6 absolute (RTOL, ATOL): a few roundings of the same
expressions."""

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_raytracer_tpu.core import onb as jonb, rng as jrng, vecmath as jvm
from go_raytracer_tpu.integrator import sampling as jsamp
from go_raytracer_tpu.scenes import registry as jreg
from go_raytracer_tpu_torch.core import onb as tonb, rng as trng, \
    vecmath as tvm
from go_raytracer_tpu_torch.integrator import sampling as tsamp
from go_raytracer_tpu_torch.ops import trace as ttrace
from go_raytracer_tpu_torch.scene import types as TT

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
N = 2048


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(b.detach()), np.asarray(a),
                               rtol=rtol, atol=atol, equal_nan=True)


def rand(*shape, seed=0, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


def both(x):
    return jnp.asarray(x), torch.from_numpy(x)


def test_vecmath():
    (ja, ta), (jb, tb) = both(rand(N, 3, seed=1)), both(rand(N, 3, seed=2))
    close(jvm.dot(ja, jb), tvm.dot(ta, tb))
    close(jvm.length(ja), tvm.length(ta))
    close(jvm.cross(ja, jb), tvm.cross(ta, tb))
    close(jvm.normalize(ja), tvm.normalize(ta))
    close(jvm.reflect(ja, jvm.normalize(jb)), tvm.reflect(ta, tvm.normalize(tb)))
    eta = rand(N, 1, seed=3, lo=0.6, hi=1.6)
    close(jvm.refract(jvm.normalize(ja), jvm.normalize(jb), jnp.asarray(eta)),
          tvm.refract(tvm.normalize(ta), tvm.normalize(tb),
                      torch.from_numpy(eta)), rtol=1e-4, atol=1e-5)
    tiny = rand(N, 3, seed=4, lo=-2e-8, hi=2e-8)
    np.testing.assert_array_equal(np.asarray(jvm.near_zero(jnp.asarray(tiny))),
                                  tvm.near_zero(torch.from_numpy(tiny)).numpy())


def test_onb():
    jn, tn = both(rand(N, 3, seed=5))
    jbasis, tbasis = jonb.build(jn), tonb.build(tn)
    for a, b in zip(jbasis, tbasis):
        close(a, b)
    jl, tl = both(rand(N, 3, seed=6))
    close(jonb.transform(jbasis, jl), tonb.transform(tbasis, tl))


def test_samplers_and_sqrt0_guard():
    (ju1, tu1), (ju2, tu2) = both(rand(N, seed=7, lo=0, hi=1)), \
        both(rand(N, seed=8, lo=0, hi=1))
    close(jrng.unit_disk(ju1, ju2), trng.unit_disk(tu1, tu2))
    close(jrng.unit_vector(ju1, ju2), trng.unit_vector(tu1, tu2))
    close(jrng.cosine_direction(ju1, ju2), trng.cosine_direction(tu1, tu2))
    r = rand(N, seed=9, lo=0.1, hi=2.0)
    dsq = rand(N, seed=10, lo=0.05, hi=30.0)   # some points inside
    close(jrng.to_sphere(jnp.asarray(r), jnp.asarray(dsq), ju1, ju2),
          trng.to_sphere(torch.from_numpy(r), torch.from_numpy(dsq), tu1,
                         tu2))
    # the guard: value 0 and a finite derivative at and below 0
    x = torch.tensor([-1.0, 0.0, 0.25], requires_grad=True)
    y = trng._sqrt0(x)
    y.sum().backward()
    assert y.tolist() == [0.0, 0.0, 0.5]
    assert torch.isfinite(x.grad).all() and x.grad[:2].tolist() == [0.0, 0.0]


def scene_pair(name):
    if name == "lanternhouse":
        js, _ = jreg.model_example(obj_path="assets/lanternhouse.obj")
    else:
        js, _ = getattr(jreg, name)()
    return js, ttrace.to_device(TT.scene_from_numpy(js), "cpu")


@pytest.mark.parametrize("name", ["book1", "book2", "simple_light",
                                  "quads_scene"])
def test_texture_value(name):
    """Solid, checker (book1), image (book2, quads) and perlin, marble and
    turbulent noise (simple_light, quads) for every texture of the
    scene, at points and uv spread over the scene."""
    js, ds = scene_pair(name)
    rs = np.random.default_rng(11)
    tex = rs.integers(0, js.textures.count, N).astype(np.int32)
    uv = rs.uniform(-2, 2, (2, N)).astype(np.float32)
    p = rs.uniform(-20, 20, (N, 3)).astype(np.float32)
    a = jsamp.texture_value(js, jnp.asarray(tex), jnp.asarray(uv[0]),
                            jnp.asarray(uv[1]), jnp.asarray(p))
    b = tsamp.texture_value(ds, torch.from_numpy(tex).long(),
                            torch.from_numpy(uv[0]), torch.from_numpy(uv[1]),
                            torch.from_numpy(p))
    # the marble's sin(scale z + 10 turb), arguments up to ~60 rad: PyTorch's
    # and XLA's float32 sin reduce such arguments one ulp apart, 2.2e-6 at
    # most here (3 of 6,144 values above ATOL)
    close(a, b, atol=5e-6 if js.has_noise else ATOL)


@pytest.mark.parametrize("name", ["cornell_box", "book3", "lanternhouse",
                                  "model_example"])
def test_lights_sample_and_pdf(name):
    """The light pick and sample and the mean light pdf: quad lights
    (cornellBox), a sphere light (book3, origins inside it included: NaN
    both), triangle lights and a sphere (lanternhouse), the sun of scene
    8."""
    js, ds = scene_pair(name)
    rs = np.random.default_rng(12)
    o = rs.uniform(-8, 8, (N, 3)).astype(np.float32)
    if name == "cornell_box":
        o = rs.uniform(5, 550, (N, 3)).astype(np.float32)
    u = rs.uniform(0, 1, (3, N)).astype(np.float32)
    jd = jsamp.lights_sample(js, jnp.asarray(o), *map(jnp.asarray, u))
    td = tsamp.lights_sample(ds, torch.from_numpy(o),
                             *map(torch.from_numpy, u))
    close(jd, td)
    # the pdf of the sampled directions and of random ones
    d = np.concatenate([np.asarray(jd)[: N // 2],
                        rs.normal(size=(N // 2, 3)).astype(np.float32)])
    jp = jsamp.lights_pdf_value(js, jnp.asarray(o), jnp.asarray(d))
    tp = tsamp.lights_pdf_value(ds, torch.from_numpy(o), torch.from_numpy(d))
    close(jp, tp)
    if name == "lanternhouse":
        assert js.has_tri_lights and (np.asarray(jp) > 0).mean() > 0.1
