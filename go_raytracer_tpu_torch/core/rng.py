"""Maps from uniform variates to sampling domains (torch tensors), and the
uint32 hash arithmetic of the kernels' counter-based PRNG and noise.

Every sampling function takes its uniforms as arguments, so the caller
owns the random stream: an explicit `torch.Generator` in the renderer,
numpy-made tensors in the tests. torch has no uint32 arithmetic, so the
hash values live in int64 tensors masked to 32 bits.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi
M32 = 0xFFFFFFFF


def mul32(x, c: int):
    """(x * c) mod 2^32 for int64 tensors holding uint32 values, without
    leaving int64 range: split x into 16-bit halves."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & M32


def mix32(x):
    """lowbias32 finalizer (public-domain integer hash, Wellons)."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def bits_to_u01(bits):
    """23 hash bits -> the mantissa of a float in [1, 2) -> minus 1: a
    float32 uniform in [0, 1)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def keyed_u01(counter, key: int):
    """Uniforms in [0, 1) from a counter-based hash: counter (an int64
    tensor of non-negative counts) under a 32-bit key. mix32 is a
    bijection of 32-bit words, so distinct counters below 2^32 hash to
    distinct words (the uniform keeps the top 23 bits of its word)."""
    return bits_to_u01(mix32(mix32(counter & M32) ^ key ^ (counter >> 32)))


def unit_disk(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform point on the unit disk, (..., 2). Distributionally equal to
    the rejection sampler vec/vec.go:149-156: radius = sqrt(U) gives the
    uniform-area density."""
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def _sqrt0(x: torch.Tensor) -> torch.Tensor:
    """sqrt clamped to 0 for x <= 0, with a finite derivative everywhere.

    sqrt(max(0, x)) has the right value but an infinite derivative where
    the clamp bites, and inf times a zero cotangent is NaN: cone-sampling a
    sphere light from inside it NaN'd every parameter gradient in the JAX
    package (GRAD.md). The double where keeps the value and zeroes the
    backward on the clamped branch."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def unit_vector(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform direction on the sphere, (..., 3): z ~ U[-1, 1], phi ~
    U[0, 2 pi) (Archimedes), distributionally the rejection sampler of
    vec/vec.go:159-167."""
    z = 1.0 - 2.0 * u1
    r = _sqrt0(1.0 - z * z)
    phi = TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def cosine_direction(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted hemisphere direction about +z, (..., 3)
    (vec/vec.go:177-186)."""
    phi = TWO_PI * u1
    sq = torch.sqrt(u2)
    return torch.stack([torch.cos(phi) * sq, torch.sin(phi) * sq,
                        _sqrt0(1.0 - u2)], dim=-1)


def to_sphere(radius: torch.Tensor, dist_squared: torch.Tensor,
              u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Cone sample toward a sphere of `radius` at squared distance
    `dist_squared`, in the frame whose +z points at its centre
    (hittable/objects.go:70-80)."""
    cos_theta_max = _sqrt0(1.0 - radius * radius / dist_squared)
    z = 1.0 + u2 * (cos_theta_max - 1.0)
    phi = TWO_PI * u1
    t = _sqrt0(1.0 - z * z)
    return torch.stack([torch.cos(phi) * t, torch.sin(phi) * t, z], dim=-1)
