"""Maps from uniform variates to sampling domains (torch tensors).

Every function takes its uniforms as arguments, so the caller owns the
random stream: an explicit `torch.Generator` in the renderer, numpy-made
tensors in the tests.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def unit_disk(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Uniform point on the unit disk, (..., 2). Distributionally equal to
    the rejection sampler vec/vec.go:149-156: radius = sqrt(U) gives the
    uniform-area density."""
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)
