"""The port's hash-gradient noise (`scene/perlin.py`) against the JAX
package's: the corner hash bit for bit, the noise and the 7-octave
turbulence within atol 1e-5 (measured: 1.2e-7; both are float32 op for op,
and `rsqrt` may round differently in the last place)."""

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_raytracer_tpu.scene import perlin as jp
from go_raytracer_tpu_torch.scene import perlin as tp

torch.set_num_threads(2)

SEEDS = (0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 1234567891)


def _points(n=10_000, seed=0):
    """n float32 points spanning +-1000 per axis; the first tenth on
    lattice points (integers), the next tenth a rounding off them."""
    rs = np.random.default_rng(seed)
    p = rs.uniform(-1000.0, 1000.0, (n, 3)).astype(np.float32)
    k = n // 10
    p[:k] = np.round(p[:k])
    p[k:2 * k] = np.nextafter(np.round(p[k:2 * k]), np.float32(np.inf))
    return [np.ascontiguousarray(p[:, c]) for c in range(3)]


@pytest.mark.parametrize("seed", SEEDS)
def test_hash_corner_bitwise(seed):
    """Over random int32 lattice corners, negative ones and the extremes
    included."""
    rs = np.random.default_rng(seed & 0xFFFF)
    ijk = [rs.integers(-2**31, 2**31, 8192).astype(np.int32)
           for _ in range(3)]
    for a in ijk:
        a[:4] = (-2**31, -1, 0, 2**31 - 1)
    j = np.asarray(jp._hash_corner(*(jnp.asarray(a) for a in ijk),
                                   np.uint32(seed)))
    t = tp._hash_corner(*(torch.from_numpy(a.astype(np.int64)) for a in ijk),
                        seed)
    np.testing.assert_array_equal(j, t.numpy().astype(np.uint32))


def test_gradient_is_unit_and_equal():
    ijk = [np.arange(-500, 500, dtype=np.int32) * k for k in (1, 7, -13)]
    j = jp._gradient(*(jnp.asarray(a) for a in ijk), np.uint32(99),
                     jnp.float32)
    t = tp._gradient(*(torch.from_numpy(a.astype(np.int64)) for a in ijk), 99)
    for a, b in zip(j, t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)
    norm = sum(b.double() ** 2 for b in t)
    assert torch.allclose(norm, torch.ones_like(norm), atol=1e-5)


@pytest.mark.parametrize("fn", ["noise_planes", "turbulence_planes"])
def test_noise_and_turbulence_match_jax(fn):
    """Per-point seeds (as the bounce core passes them) over 10^4 points
    spanning +-1000, lattice boundaries included."""
    x, y, z = _points()
    seeds = np.random.default_rng(5).integers(
        0, 2**32, x.shape[0], dtype=np.uint64).astype(np.uint32)
    j = np.asarray(getattr(jp, fn)(jnp.asarray(seeds), jnp.asarray(x),
                                   jnp.asarray(y), jnp.asarray(z)))
    t = getattr(tp, fn)(torch.from_numpy(seeds.astype(np.int64)),
                        torch.from_numpy(x), torch.from_numpy(y),
                        torch.from_numpy(z)).numpy()
    assert np.isfinite(t).all()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)
    if fn == "noise_planes":
        assert np.abs(t).max() <= 1.0
        # on a lattice point every corner dot but its own vanishes, and
        # its own is zero: the noise is 0 there
        np.testing.assert_allclose(t[:1000], 0.0, atol=1e-6)
    else:
        assert t.min() >= 0.0


def test_make_seed_matches_jax():
    a = [jp.make_seed(np.random.default_rng(7)) for _ in range(3)]
    b = [tp.make_seed(np.random.default_rng(7)) for _ in range(3)]
    assert a == b and all(isinstance(s, np.uint32) for s in b)
