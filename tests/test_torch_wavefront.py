"""The reference engine's bounce and radiance (integrator/wavefront.py)
against the JAX package's `_bounce` and `radiance`, fed the same rays and
the same uniforms (made from a numpy seed, or JAX's own threefry stream).

Tolerances (tests/test_pallas_bounce.py's, and tests/test_mesh_ext.py's
for the meshes): the continuing flag alive' and the clamp flag are equal
on every lane of cornellBox and quads (no glass, no large sphere), on at
least 1 - 5e-3 of book3's lanes (a rounding flips its glass sphere's
reflect/refract choice) and on at least 0.995 of the others' (a far hit on
a radius-1000 sphere carries float32 acne that one package's rounding
re-meets); where they agree, E, W and the continuing directions agree
within RTOL relative and ATOL absolute on at least the same fraction."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_raytracer_tpu.integrator import wavefront as jwf
from go_raytracer_tpu_torch.integrator import wavefront as twf
from tests.test_torch_trace_dense import scene_rays

torch.set_num_threads(2)

RTOL = ATOL = 2e-3
FLAG_AGREE = {"cornell_box": 1.0, "quads_scene": 1.0, "book3": 1 - 5e-3}
N = 1024


@pytest.mark.parametrize("name", ["book1", "book2", "book3", "simple_light",
                                  "quads_scene", "cornell_box",
                                  "cornell_smoke", "model_example",
                                  "lanternhouse"])
def test_bounce_matches_jax(name):
    js, ds, o, d, t = scene_rays(name, n=N, seed=2)
    frac = FLAG_AGREE.get(name, 0.995)
    rs = np.random.default_rng(3)
    alive = rs.uniform(size=N) > 0.05
    for level in range(2):
        u = rs.uniform(0, 1, (N, 9 + js.media.count)).astype(np.float32)
        jo = jwf._bounce(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
                         jnp.asarray(alive), jnp.asarray(u))
        to = twf._bounce(ds, *(torch.from_numpy(x) for x in (o, d, t, alive,
                                                             u)))
        jo = [np.asarray(x) for x in jo]
        to = [x.numpy() for x in to]
        flags = (jo[2] == to[2]) & (jo[5] == to[5])
        assert flags.mean() >= frac, (name, level, flags.mean())
        ok = flags.copy()
        for k in (0, 1):                     # E, W
            ok &= np.isclose(jo[k], to[k], rtol=RTOL, atol=ATOL).all(-1)
        go = flags & jo[5]
        ok[go] &= np.isclose(jo[4][go], to[4][go], rtol=RTOL,
                             atol=ATOL).all(-1)
        assert ok.mean() >= frac, (name, level, ok.mean())
        assert not to[5][~alive].any()
        o = np.where(jo[5][:, None], jo[3], o).astype(np.float32)
        d = np.where(jo[5][:, None], jo[4], d).astype(np.float32)
        alive = jo[5].copy()


def test_clamp_contribution():
    rs = np.random.default_rng(4)
    c = (rs.uniform(0, 5, (N, 3)) ** 3).astype(np.float32)
    c[:4] = np.nan
    a = np.asarray(jwf.clamp_contribution(jnp.asarray(c), 10.0))
    b = twf.clamp_contribution(torch.from_numpy(c), 10.0).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-6, equal_nan=True)
    assert np.isnan(b[:4]).all() and (np.nansum(b[4:], -1) <= 10.0001).all()


def jax_uniforms(key, steps, n, n_u):
    """The per-level uniforms JAX's `radiance` draws from `key`."""
    return np.stack([np.asarray(jax.random.uniform(k, (n, n_u),
                                                   dtype=jnp.float32))
                     for k in jax.random.split(key, steps)])


@pytest.mark.parametrize("name,mode", [("cornell_box", "scan"),
                                       ("cornell_smoke", "while"),
                                       ("book3", "while")])
def test_radiance_matches_jax_on_its_uniforms(name, mode):
    """Fed JAX's uniforms, the port's radiance follows JAX's paths: L
    within RTOL/ATOL on all but the flag fraction of the lanes, the same
    segments within that fraction; the reverse combine and the firefly
    clamp run per level."""
    js, ds, o, d, t = scene_rays(name, n=1024, seed=5)
    depth, max_c = 8, 10.0
    key = jax.random.key(7)
    jl, jst = jwf.radiance(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
                           key, depth, max_c, mode=mode)
    us = jax_uniforms(key, depth + 1, 1024, 9 + js.media.count)
    tl, tst = twf.radiance(ds, *(torch.from_numpy(x) for x in (o, d, t)),
                           None, depth, max_c, mode=mode,
                           uniforms=torch.from_numpy(us))
    frac = FLAG_AGREE.get(name, 0.995)
    ok = np.isclose(np.asarray(jl), tl.numpy(), rtol=RTOL, atol=ATOL).all(-1)
    assert ok.mean() >= frac, ok.mean()
    js_seg = int(jst["segments"])
    assert abs(tst["segments"] - js_seg) <= (1 - frac) * js_seg * depth
    assert np.isfinite(tl.numpy()).all() and tl.numpy().max() > 0


def test_radiance_kernel_backend_matches_the_tensor_bounce():
    """backend "pallas" (K3's plain version on the CPU) and "xla" (the
    tensor-code bounce) on one generator stream: the same paths but for
    the flips of grazing rays."""
    _, ds, o, d, t = scene_rays("book3", n=1024, seed=6)
    args = [torch.from_numpy(x) for x in (o, d, t)]
    out = {}
    for be in ("pallas", "xla"):
        g = torch.Generator().manual_seed(9)
        out[be] = twf.radiance(ds, *args, g, 8, 10.0, backend=be)
    assert twf.use_kernel(ds, 1024, "auto")
    assert not twf.use_kernel(ds, 1000, "auto")
    ok = torch.isclose(out["pallas"][0], out["xla"][0], rtol=RTOL,
                       atol=ATOL).all(-1)
    assert ok.float().mean() >= 1 - 5e-3
    seg = out["xla"][1]["segments"]
    assert abs(out["pallas"][1]["segments"] - seg) <= 5e-3 * seg
