"""`render/camera.generate_rays` and `core/rng.unit_disk` of the port
against the JAX package, fed the same five uniforms per ray."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_raytracer_tpu.core import rng as jrng
from go_raytracer_tpu.render import camera as jcam
from go_raytracer_tpu.scenes import registry as jreg
from go_raytracer_tpu_torch.core import rng as trng
from go_raytracer_tpu_torch.render import camera as tcam
from go_raytracer_tpu_torch.scenes import registry as treg

torch.set_num_threads(2)


@pytest.mark.parametrize("scene", ["modelExample", "cornellBox"])
def test_generate_rays_matches_jax(scene, monkeypatch):
    """With defocus (scene 8) and without (cornellBox): origins, directions
    and times within rtol 1e-6 / atol 1e-5 (cos and sin of the lens sample
    are evaluated by two libraries; directions are ~10 long)."""
    n = 4096
    rs = np.random.default_rng(5)
    u = rs.random((n, 5)).astype(np.float32)
    _, jc = jreg.get_scene(scene)[1]()
    _, tc = treg.get_scene(scene)[1]()
    npix = tc.width * tc.image_height
    pid = rs.integers(0, npix, n).astype(np.int32)
    s_i = rs.integers(0, tc.spp_sqrt, n).astype(np.float32)
    s_j = rs.integers(0, tc.spp_sqrt, n).astype(np.float32)
    # the JAX function draws its uniforms from a key: hand it ours
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, dtype=None: jnp.asarray(u))
    jo, jd, jt = jcam.generate_rays(jc.derived(), jc.width, jnp.asarray(pid),
                                    jnp.asarray(s_i), jnp.asarray(s_j),
                                    jax.random.key(0))
    to, td, tt = tcam.generate_rays(
        tc.derived(), tc.width, torch.from_numpy(pid).to(torch.int64),
        torch.from_numpy(s_i), torch.from_numpy(s_j), torch.from_numpy(u))
    assert (tc.defocus_angle > 0) == (scene == "modelExample")
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    if tc.defocus_angle > 0:
        assert np.ptp(to.numpy(), axis=0).max() > 0     # the lens is sampled


def test_unit_disk_matches_jax():
    rs = np.random.default_rng(6)
    u1 = rs.random(1000).astype(np.float32)
    u2 = rs.random(1000).astype(np.float32)
    t = trng.unit_disk(torch.from_numpy(u1), torch.from_numpy(u2)).numpy()
    j = np.asarray(jrng.unit_disk(jnp.asarray(u1), jnp.asarray(u2)))
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)
    assert (np.hypot(t[:, 0], t[:, 1]) <= 1.0 + 1e-6).all()
