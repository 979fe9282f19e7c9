"""Perlin noise: the seeds (host part) and the gather-free hash-gradient
lattice noise on torch tensors.

The reference addresses 256 random unit gradients through three XORed
permutation tables (hittable/perlin.go:20-31, 34-54); the port, as the JAX
package, derives each lattice corner's gradient arithmetically from
(i, j, k, texture seed) with a uint32 hash, so the noise needs no table
and runs inside the bounce kernel (csrc/bounce_core.cuh computes the same
function). Trilinear Hermite-smoothed interpolation (perlin.go:93-111) and
7-octave turbulence (perlin.go:57-69).

torch has no uint32 arithmetic: hash values live in int64 tensors masked
to 32 bits (`core/rng.mul32`), and a seed is an int64 tensor (or int)
holding a uint32. Every float op is the JAX package's, in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from go_raytracer_tpu_torch.core.rng import M32, mix32, mul32

# Weyl-sequence per-axis multipliers of the corner hash; the finalizer is
# lowbias32 (`core/rng.mix32`)
_MX = 0x9E3779B1
_MY = 0x85EBCA77
_MZ = 0xC2B2AE3D


def make_seed(rng: np.random.Generator) -> np.uint32:
    """Per-texture seed, replacing NewPerlin's fresh tables
    (texture.go:104-109 -> perlin.go:20-31)."""
    return np.uint32(rng.integers(0, 2**32, dtype=np.uint32))


def _hash_corner(i, j, k, seed):
    """uint32 hash of lattice corners (int64 tensors holding int32 values,
    negative ones included, taken mod 2^32); plays the role of
    perm_x[i&255] ^ perm_y[j&255] ^ perm_z[k&255] (perlin.go:45-49)."""
    h = mul32(i & M32, _MX) ^ mul32(j & M32, _MY) ^ mul32(k & M32, _MZ) \
        ^ (torch.as_tensor(seed) & M32)
    return mix32(h)


def _gradient(i, j, k, seed):
    """Unit gradient at lattice corners: three 10-bit hash fields mapped to
    [-1, 1)^3, then normalised (perlin.go:27's vec.Random(-1, 1) +
    UnitVector, hash-indexed)."""
    h = _hash_corner(i, j, k, seed)
    f = lambda b: (b & 0x3FF).to(torch.float32) * (2.0 / 1024.0) - 1.0
    gx, gy, gz = f(h), f(h >> 10), f(h >> 20)
    inv = torch.rsqrt(gx * gx + gy * gy + gz * gz + 1e-12)
    return gx * inv, gy * inv, gz * inv


def noise_planes(seed, x, y, z):
    """Gradient noise in [-1, 1] at float32 points (x, y, z)
    (perlin.go:34-54): Hermite-smoothed trilinear interpolation of the
    eight corner-gradient dots. `seed` is an int or a per-point int64
    tensor of uint32 values."""
    flx, fly, flz = torch.floor(x), torch.floor(y), torch.floor(z)
    ux, uy, uz = x - flx, y - fly, z - flz
    i0, j0, k0 = (f.to(torch.int32).to(torch.int64) for f in (flx, fly, flz))
    # Hermite smoothing (perlin.go:96-98)
    smx = ux * ux * (3.0 - 2.0 * ux)
    smy = uy * uy * (3.0 - 2.0 * uy)
    smz = uz * uz * (3.0 - 2.0 * uz)
    acc = torch.zeros_like(x)
    for di in range(2):
        for dj in range(2):
            for dk in range(2):
                gx, gy, gz = _gradient(i0 + di, j0 + dj, k0 + dk, seed)
                w = ((smx if di else 1.0 - smx) * (smy if dj else 1.0 - smy)
                     * (smz if dk else 1.0 - smz))
                acc = acc + w * (gx * (ux - di) + gy * (uy - dj)
                                 + gz * (uz - dk))
    return acc


def turbulence_planes(seed, x, y, z, depth: int = 7):
    """`depth`-octave turbulence (perlin.go:57-69): |sum of noise at
    doubling frequency and halving weight|."""
    acc = torch.zeros_like(x)
    weight = 1.0
    for _ in range(depth):
        acc = acc + weight * noise_planes(seed, x, y, z)
        weight *= 0.5
        x, y, z = x * 2.0, y * 2.0, z * 2.0
    return torch.abs(acc)
