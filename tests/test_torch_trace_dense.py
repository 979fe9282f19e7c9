"""The reference engine's closest hit (`ops/trace.trace`) against the JAX
package's `trace`, on camera rays of each scene and on the rays one
bounce later (origins on surfaces, where float32 acne lives), with the
media uniforms made from a numpy seed.

Tolerances: the hit flag, the medium flag and the material agree on at
least AGREE of the lanes (a ray grazing an edge or re-meeting its own
surface may resolve the other way in either package; ROADMAP §3's route
ties), and where they agree t, p, the normal and uv agree within RTOL
relative and ATOL absolute on at least AGREE of them (a sphere's u wraps
at its seam, where one rounding moves it by 1)."""

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_raytracer_tpu.integrator import wavefront as jwf
from go_raytracer_tpu.ops import trace as jtrace
from go_raytracer_tpu.scenes import registry as jreg
from go_raytracer_tpu_torch.ops import trace as ttrace
from go_raytracer_tpu_torch.render import camera as tcam
from go_raytracer_tpu_torch.scene import types as TT
from go_raytracer_tpu_torch.scenes import registry as treg

torch.set_num_threads(2)

AGREE = 0.999
RTOL, ATOL = 2e-4, 2e-3
N = 2048


def scene_rays(name, n=N, seed=0):
    """(JAX scene, device scene, camera rays as numpy: o, d, time)."""
    if name == "lanternhouse":
        js, _ = jreg.model_example(obj_path="assets/lanternhouse.obj")
        _, cam = treg.model_example(obj_path="assets/lanternhouse.obj")
    else:
        js, _ = getattr(jreg, name)()
        _, cam = getattr(treg, name)()
    ds = ttrace.to_device(TT.scene_from_numpy(js), "cpu")
    rs = np.random.default_rng(seed)
    npix = cam.width * cam.image_height
    pid = torch.from_numpy(rs.integers(0, npix, n))
    s = torch.zeros(n)
    u = torch.from_numpy(rs.uniform(0, 1, (n, 5)).astype(np.float32))
    o, d, t = tcam.generate_rays(cam.derived(), cam.width, pid, s, s, u)
    return js, ds, o.numpy().copy(), d.numpy().copy(), t.numpy().copy()


def compare(jh, th):
    hit, thit = np.asarray(jh.hit), th.hit.numpy()
    same = (hit == thit) & (np.asarray(jh.is_medium) == th.is_medium.numpy()) \
        & (np.asarray(jh.mat_id) == th.mat_id.numpy())
    assert same.mean() >= AGREE, same.mean()
    both = same & hit
    for name in ("t", "p", "normal", "u", "v"):
        a = np.asarray(getattr(jh, name))[both]
        b = getattr(th, name).numpy()[both]
        ok = np.isclose(a, b, rtol=RTOL, atol=ATOL)
        ok = ok.all(axis=-1) if ok.ndim == 2 else ok
        assert ok.mean() >= AGREE, (name, ok.mean())
    np.testing.assert_array_equal(np.asarray(jh.front_face)[both],
                                  th.front_face.numpy()[both])
    ok = np.isclose(np.asarray(jh.med_logp), th.med_logp.numpy(), rtol=RTOL,
                    atol=ATOL)
    assert ok[same].mean() >= AGREE
    return both.mean()


@pytest.mark.parametrize("name", ["cornell_box", "book3", "cornell_smoke",
                                  "book2", "simple_light", "quads_scene",
                                  "model_example", "lanternhouse"])
def test_trace_matches_jax(name):
    js, ds, o, d, t = scene_rays(name)
    rs = np.random.default_rng(1)
    n_med = js.media.count
    for level in range(2):
        u = rs.uniform(0, 1, (N, 9 + n_med)).astype(np.float32)
        jh = jtrace.trace(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
                          jnp.asarray(u[:, 9:]))
        th = ttrace.trace(ds, torch.from_numpy(o), torch.from_numpy(d),
                          torch.from_numpy(t), torch.from_numpy(u[:, 9:]))
        frac = compare(jh, th)
        assert frac > 0.05, (name, level, frac)  # the rays meet the scene
        # the next level's rays: JAX's bounce of these (shared by both)
        _, _, _, no, nd, na = jwf._bounce(
            js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
            jnp.ones(N, bool), jnp.asarray(u))
        keep = np.asarray(na)
        o = np.where(keep[:, None], np.asarray(no), o).astype(np.float32)
        d = np.where(keep[:, None], np.asarray(nd), d).astype(np.float32)


def test_dense_triangles_below_the_bvh_threshold():
    """lanternhouse's 1,748 triangles have no BVH: the dense factored
    Moller-Trumbore class of JAX's `trace` (`tri_ts_factored`), against
    the local form of the port's oracle `tri_ts`."""
    from go_raytracer_tpu_torch.ops import intersect as tix

    js, ds, o, d, _ = scene_rays("lanternhouse", n=512)
    assert js.has_triangles and not js.has_tri_bvh
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    a = tix.tri_ts_factored(ds.triangles, to, td, 1e-3, float("inf"))
    b = tix.tri_ts(ds.triangles, to, td, 1e-3, float("inf"))
    ta, ia = a.min(dim=1)
    tb, ib = b.min(dim=1)
    assert (torch.isfinite(ta) == torch.isfinite(tb)).float().mean() >= AGREE
    fin = torch.isfinite(ta) & torch.isfinite(tb)
    assert fin.float().mean() > 0.1
    assert torch.isclose(ta[fin], tb[fin], rtol=RTOL, atol=ATOL) \
        .float().mean() >= AGREE
