"""The image texture's host-side arithmetic against the JAX package, bit
for bit: the nearest-texel lookup (`image_value`, `image_texel_index`)
against `sampling.image_value`, and the sphere uv's atan2/acos polynomial
against the JAX kernel's `_atan2`/`_acos`. The fused kernels read the
texel with the same operations (csrc/bounce_core.cuh: `image_texel`,
`atan2_poly`, their roundings written out), so these fix the texel a hit
at a given uv takes."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_raytracer_tpu.integrator import sampling
from go_raytracer_tpu.ops.pallas import bounce as jpb
from go_raytracer_tpu.scene.builder import SceneBuilder
from go_raytracer_tpu.scenes import registry as jreg
from go_raytracer_tpu_torch.ops import bounce as tpb
from go_raytracer_tpu_torch.scene import types as TT

torch.set_num_threads(2)


def _two_image_scene():
    """Two images of different sizes (7 x 5 and 1024 x 512, the earth map),
    so the table is padded and each image clamps to its own (w, h)."""
    rs = np.random.default_rng(3)
    b = SceneBuilder(background=(0, 0, 0))
    small = b.lambertian(tex=b.image_texture(
        rs.uniform(0, 1, (5, 7, 3)).astype(np.float32)))
    earth_scene, _ = jreg.quads_scene()
    earth = b.lambertian(tex=b.image_texture(
        np.asarray(earth_scene.images.data[0])))
    b.quad((0, 0, 0), (1, 0, 0), (0, 1, 0), small)
    b.quad((0, 0, 1), (1, 0, 0), (0, 1, 0), earth)
    b.add_light(b.quad((0, 2, 0), (1, 0, 0), (0, 0, 1),
                       b.diffuse_light((1, 1, 1))))
    return b.build()


def _uv_cases(rs, w, h):
    """u and v that are negative, above 1, exact integers, at and one ulp
    either side of every texel boundary k / (n - 1) of an n-texel axis,
    and random."""
    edge = lambda n: (np.arange(n, dtype=np.float64) / (n - 1)).astype(
        np.float32)
    parts = []
    for n in (w, h):
        e = edge(n)
        parts += [e, np.nextafter(e, np.float32(-2)),
                  np.nextafter(e, np.float32(2)), e + 1.0, e - 1.0, -e]
    parts += [np.arange(-3, 4, dtype=np.float32),
              np.array([-0.0, 0.5, -0.5, 1.5, -1.5, 2.999999, 1e-8, -1e-8],
                       np.float32),
              rs.uniform(-5, 5, 20000).astype(np.float32)]
    x = np.concatenate(parts).astype(np.float32)
    return x, rs.permutation(x)


@pytest.mark.parametrize("scene", ["quads", "two_images"])
def test_image_value_bitwise(scene):
    """`image_value` on the packed image table equals the JAX package's
    `sampling.image_value` bit for bit, image ids mixed, and
    `image_texel_index` addresses that texel."""
    js = jreg.quads_scene()[0] if scene == "quads" else _two_image_scene()
    ts = TT.scene_from_numpy(js)
    data, wh = (torch.from_numpy(t) for t in tpb.pack_scene(ts)[4:])
    rs = np.random.default_rng(0)
    u, v = _uv_cases(rs, int(wh[:, 0].max()), int(wh[:, 1].max()))
    img = rs.integers(0, wh.shape[0], u.shape[0]).astype(np.int32)
    j = np.asarray(sampling.image_value(js, jnp.asarray(img), jnp.asarray(u),
                                        jnp.asarray(v)))
    t = tpb.image_value(data, wh, torch.from_numpy(img).long(),
                        torch.from_numpy(u), torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(j.view(np.uint32), t.view(np.uint32))
    idx = tpb.image_texel_index(wh, data.shape[1], data.shape[2],
                                torch.from_numpy(img).long(),
                                torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_array_equal(data.reshape(-1, 3)[idx].numpy(), t)
    # each image's own texels only, its corner rows and columns reached
    # (|fmod(u, 1)| < 1, so u reaches the last column only by rounding;
    # v = 0 flips to the last row)
    for k in range(wh.shape[0]):
        sel = torch.from_numpy(img == k)
        w_k, h_k = int(wh[k, 0]), int(wh[k, 1])
        cell = idx[sel] - k * data.shape[1] * data.shape[2]
        cols, rows = cell % data.shape[2], cell // data.shape[2]
        assert cols.min() == 0 and w_k - 2 <= cols.max() <= w_k - 1
        assert rows.min() == 0 and rows.max() == h_k - 1


def test_atan2_acos_match_jax_bitwise():
    """The port's `_atan2` and `_acos` equal the JAX kernel's bit for bit
    over a grid that holds both axes, both diagonals, signed zeros and
    tiny values, and over the unit normals' range of acos. (No subnormal
    input: XLA on the CPU flushes them to zero, PyTorch and the card keep
    them; no unit normal's component is one.)"""
    g = np.concatenate([np.linspace(-3, 3, 241), [0.0, -0.0, 1e-30, -1e-30,
                                                  1.0, -1.0]])
    y, x = (a.astype(np.float32).reshape(-1) for a in np.meshgrid(g, g))
    rs = np.random.default_rng(1)
    y = np.concatenate([y, rs.normal(size=20000).astype(np.float32)])
    x = np.concatenate([x, rs.normal(size=20000).astype(np.float32)])
    j = np.asarray(jpb._atan2(jnp.asarray(y), jnp.asarray(x)))
    t = tpb._atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(j.view(np.uint32), t.view(np.uint32))
    err = np.abs(t - np.arctan2(y, x))[(x != 0) | (y != 0)]  # not at 0/0
    assert np.minimum(err, 2 * np.pi - err).max() < 2e-5  # -pi == pi
    c = np.concatenate([np.linspace(-1, 1, 4001), [-0.0, 1e-30, -1e-30],
                        rs.uniform(-1, 1, 20000)]).astype(np.float32)
    j = np.asarray(jpb._acos(jnp.asarray(c)))
    t = tpb._acos(torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(j.view(np.uint32), t.view(np.uint32))
    assert np.abs(t - np.arccos(c)).max() < 2e-5
    assert abs(float(tpb._acos(torch.tensor([-1.0]))) - math.pi) < 1e-6
