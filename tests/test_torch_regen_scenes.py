"""One `queue_ik` window of the port on book3, cornellSmoke, simpleLight,
book1 and quads against the JAX package's `_window_impl` (Pallas kernels
in interpret mode, its records patched with the image texel), fed the
same per-call seeds: the scenes the fused kernels gained with the
dielectric, the sphere light and the constant-density media, then with
the noise, the checker and defocus, then with the image texture read in
the kernel.

Both trace the same paths up to float rounding. A lane that branches the
other way (a reflect/refract choice, a free flight at a medium's far
boundary) changes its path and, through the queue ranks, later
assignments, so a small fraction of items may differ: at most 1%, with the
cursor exact, the segment totals within 1e-3 (book3 and book1: 5e-3, see
SEGMENTS_RTOL) and the channel means within 1e-3 relative (book1: 5e-3, see
MEANS_RTOL)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_raytracer_tpu.integrator import regen as jregen
from go_raytracer_tpu.scenes import registry as jreg
from go_raytracer_tpu_torch.integrator import regen
from go_raytracer_tpu_torch.ops import bounce as tpb
from go_raytracer_tpu_torch.render.camera import Camera
from go_raytracer_tpu_torch.scene import types as TT

torch.set_num_threads(2)

# Segment totals: within 1e-3 on cornellSmoke (measured: equal). book3's
# glass sphere is chaotic: carried through a call of 8 levels, a rounding
# grows into a reflect/refract flip, and a path caught by total internal
# reflection then runs tens of levels longer or shorter. Measured here: 3
# of the 4,096 items differ and the totals by 36 segments of 22,297
# (1.6e-3).
# simpleLight and quads measured equal; book1 (389 spheres, glass and fuzzed metal on
# a radius-1000 ground sphere with its f32 acne, depth 50) 28 of 6,176
# (4.5e-3), 16 of its 2,304 items differing.
SEGMENTS_RTOL = {"book3": 5e-3, "cornell_smoke": 1e-3, "simple_light": 1e-3,
                 "book1": 5e-3, "quads_scene": 1e-3}
# Channel means within 1e-3, but book1's: each of its 16 differing items
# carries a whole path's radiance (a sky of ~0.7), so its means part by
# 2.0e-3, 3.5e-3 and 6.6e-4 at 2,304 paths.
MEANS_RTOL = {"book1": 5e-3}


@pytest.mark.parametrize("scene", ["book3", "cornell_smoke", "simple_light",
                                   "book1", "quads_scene"])
def test_window_matches_jax_window(scene):
    """32 px, 4 spp, depth 50, 4096 lanes (every item starts at the first
    level, so a flipped lane changes only its own path), the registry's
    cadence and mean path length."""
    js, jc = getattr(jreg, scene)()
    W, SPP, DEPTH, n = 32, 4, 50, 4096
    cad = jc.regen_cadence
    jc.width, jc.samples_per_pixel, jc.max_depth = W, SPP, DEPTH
    tc = Camera(**{f.name: getattr(jc, f.name)
                   for f in dataclasses.fields(Camera)})
    ts = TT.scene_from_numpy(js)
    st = tpb.scene_statics(ts)
    npix, sq = W * jc.image_height, 2
    total = npix * SPP
    refill = jregen._auto_refill(total, n, DEPTH + 1, cad, jc)
    window = -(-(refill + DEPTH + 1) // cad) * cad
    outer = window // cad
    key = jax.random.fold_in(jax.random.key(11), 0)
    seeds = np.asarray(jax.random.randint(
        key, (outer,), jnp.iinfo(jnp.int32).min, jnp.iinfo(jnp.int32).max,
        dtype=jnp.int32))
    jacc, _, jcur = jregen._window_impl(
        js, jc.derived(), jnp.zeros((total + n, 3), jnp.float32),
        jregen._init_state(n, jnp.float32), jnp.int32(0), key, jnp.int32(0),
        jnp.int32(total), width=W, npix=npix, sqrt_spp=sq, window=window,
        refill=refill, cadence=cad, n_u=tpb.N_U + st["n_media"],
        max_depth=DEPTH, max_contribution=jc.max_contribution,
        use_pallas=True, interpret=True, inkernel=True, harvest="fused")
    tacc = torch.zeros((total + n, 3))
    _, _, tcur = regen._window_impl(
        tuple(torch.from_numpy(t) for t in tpb.pack_scene(ts)), st,
        torch.from_numpy(tpb.pack_camera(tc.derived())),
        torch.from_numpy(np.array(ts.background)), tacc,
        regen._init_state(n, "cpu"), torch.zeros(1, dtype=torch.int32),
        torch.tensor(seeds), 0, total, width=W, npix=npix, sqrt_spp=sq,
        window=window, refill=refill, cadence=cad, max_depth=DEPTH,
        max_contribution=jc.max_contribution,
        has_defocus=jc.defocus_angle > 0)
    jcur = np.asarray(jcur)
    assert tcur[0].item() == jcur[0] == total
    assert abs(tcur[1].item() - jcur[1]) <= SEGMENTS_RTOL[scene] * jcur[1]
    # the registry's mean path length, within the spread of 4,096 paths
    assert abs(tcur[1].item() / total - jc.regen_len) <= 0.1 * jc.regen_len
    a, b = np.asarray(jacc)[:total], tacc[:total].numpy()
    assert np.isfinite(b).all()
    mismatched = (~np.isclose(a, b, rtol=1e-3, atol=1e-4)).any(axis=1).mean()
    print(f"{scene}: mismatched items {mismatched:.2e}, segments "
          f"{tcur[1].item()} / {jcur[1]}")
    assert mismatched <= 0.01
    np.testing.assert_allclose(b.mean(axis=0), a.mean(axis=0),
                               rtol=MEANS_RTOL.get(scene, 1e-3))
