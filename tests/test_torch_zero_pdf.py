"""The bounce core's 0 / 0 rule: a diffuse lane whose light sample has no
scattering pdf (cos 0) and misses every light (light pdf 0) weighs 0.

This is where the port departs from the JAX package on purpose: the JAX
kernel (and the reference) divides 0 by 0 there and returns a NaN weight,
a pixel the reference's PrintColor blacks out. The lane is planted
exactly: a ray straight down onto a floor at y = 0 hits it at y = 0, and a
quad light lying in the same plane gives it light samples with dy = 0,
parallel to both the floor (cos 0) and the light (no hit). Every other
lane must be the JAX package's, within the repo's tolerances
(tests/test_pallas_bounce.py's bound), and a lane that picked the cosine
sample or the light above keeps its nonzero weight. The scene and lanes
are tests/test_torch_k3_cuda.py's, whose `gpu` cases hold K3 and K1
(`bounce_fused_q`) to the same rule on the card."""

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import jax.numpy as jnp
import numpy as np
import torch

from go_raytracer_tpu.ops.pallas import bounce as jpb
from go_raytracer_tpu.scene.builder import SceneBuilder as JBuilder
from go_raytracer_tpu_torch.ops import bounce as tpb
from go_raytracer_tpu_torch.scene import types as TT
from tests.test_torch_bounce_ext import compare_bounce
from tests.test_torch_k3_cuda import (PLANTED, ZZ_N as N, floor_scene,
                                      planted_lanes as lanes,
                                      zero_zero_lanes)

torch.set_num_threads(2)


def test_zero_zero_weight_is_zero_and_nothing_else_moves():
    js = floor_scene(JBuilder)
    ts = TT.scene_from_numpy(js)
    st = tpb.scene_statics(ts)
    assert st["n_lights_live"] == 2 and st == jpb.scene_statics(js)
    o, d, tm, alive, u = lanes(5, tpb.N_U + st["n_media"])
    tt = torch.from_numpy
    pout = tpb.bounce_ref(tuple(tt(t) for t in tpb.pack_scene(ts)), st,
                          tt(o), tt(d), tt(tm), tt(alive), tt(u),
                          torch.tensor(ts.background, dtype=torch.float32))
    jout = jpb.bounce(jpb.pack_scene(js), jpb.scene_statics(js),
                      jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm),
                      jnp.asarray(alive), jnp.asarray(u), js.background,
                      interpret=True)
    pW, jW = pout[1].numpy(), np.asarray(jout[1])
    zz = zero_zero_lanes(u)
    assert zz.sum() > 50
    # the planted lanes: a light sample parallel to the floor (dy = 0)
    assert (pout[4].numpy()[zz, 1] == 0).all()
    # the divergence: JAX's 0 / 0 is NaN, the port's weight 0
    assert np.isnan(jW[zz]).all()
    assert (pW[zz] == 0).all() and not pout[0].numpy()[zz].any()
    # the other planted lanes (cosine sample, or the light above) keep
    # their nonzero weight, as JAX computes it
    other = np.zeros(N, bool)
    other[:PLANTED] = ~zz[:PLANTED]
    assert other.sum() > 50 and (pW[other] > 0).any(axis=-1).all()
    np.testing.assert_allclose(pW[other], jW[other], rtol=2e-3, atol=2e-3)
    # everything else equals JAX's bounce as the other tests hold it
    keep = ~zz
    assert np.isfinite(pW).all()
    compare_bounce(tuple(x[keep] for x in jout[:6]),
                   tuple(x[keep] for x in pout[:6]), alive[keep])
