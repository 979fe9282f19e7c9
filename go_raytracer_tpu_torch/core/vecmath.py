"""Batched 3-vector math over tensors of shape (..., 3).

Counterpart of the JAX package's `core/vecmath.py` (the reference's Vec3,
internal/vec/vec.go:12-195): pure, out-of-place functions over a leading
ray or primitive axis, so autograd can run through them.
"""

from __future__ import annotations

import torch

EPS_NEAR_ZERO = 1e-8


def dot(a: torch.Tensor, b: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Dot product over the trailing axis (vec.go:111-113)."""
    return torch.sum(a * b, dim=-1, keepdim=keepdim)


def length_squared(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sum(v * v, dim=-1, keepdim=keepdim)


def length(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """|v|. The square root takes a double where: where |v|^2 is 0 (or
    NaN) its value, sqrt's own, enters as a constant, so the derivative
    there is 0 where sqrt's is infinite. A lane whose vector is 0 and
    whose result is masked out (a triangle's interpolated normal at a ray
    parallel to the dummy row it gathered: u and v near 1e30, w + u + v
    cancelling to 0) would otherwise give 0 * inf = NaN to every gradient
    upstream of it (modelExample's fuzz on the card, PERF.md); the JAX
    package's `length` is unguarded."""
    lsq = length_squared(v, keepdim=keepdim)
    pos = lsq > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, lsq, 1.0)),
                       torch.sqrt(lsq).detach())


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product (vec.go:116-122), broadcasting leading axes."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def normalize(v: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Unit vector (vec.go:125-127). `eps` guards a zero-length input on
    branchless paths whose result is masked out anyway."""
    floor = eps if eps else torch.finfo(v.dtype).tiny
    return v / torch.clamp(length(v, keepdim=True), min=floor)


def near_zero(v: torch.Tensor) -> torch.Tensor:
    """True where every component is below 1e-8 in magnitude (vec.go:130-133)."""
    return torch.all(torch.abs(v) < EPS_NEAR_ZERO, dim=-1)


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection about the normal n (vec.go:136-138)."""
    return v - 2.0 * dot(v, n, keepdim=True) * n


def refract(v: torch.Tensor, n: torch.Tensor, eta_ratio) -> torch.Tensor:
    """Snell refraction of the unit vector v about n (vec.go:141-146);
    `eta_ratio` = eta_incident / eta_transmitted, (..., 1) or a scalar."""
    cos_theta = torch.clamp(dot(-v, n, keepdim=True), max=1.0)
    r_perp = eta_ratio * (v + cos_theta * n)
    # the max() keeps sqrt's derivative finite at the exact TIR boundary
    # (the value moves by < 4e-4 in the vanishing parallel component)
    r_par = -torch.sqrt(torch.clamp(
        torch.abs(1.0 - length_squared(r_perp, keepdim=True)), min=1e-7)) * n
    return r_perp + r_par
