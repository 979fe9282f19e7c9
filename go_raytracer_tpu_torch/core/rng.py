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


def unit_disk(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform point on the unit disk, (..., 2). Distributionally equal to
    the rejection sampler vec/vec.go:149-156: radius = sqrt(U) gives the
    uniform-area density."""
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)
