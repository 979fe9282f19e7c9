"""Orthonormal basis about a normal, branch-free (the reference's
hittable/onb.go:9-43; the JAX package's `core/onb.py`).

The reference takes the helper axis a = (0, 1, 0) when |n.x| > 0.9, else
(1, 0, 0), then v = unit(n x a), u = unit(n x v), w = unit(n); the branch
is a select here, so it runs over a whole batch.
"""

from __future__ import annotations

import torch

from go_raytracer_tpu_torch.core import vecmath as vm


def build(n: torch.Tensor):
    """(u, v, w), each (..., 3), for normals n (..., 3)."""
    w = vm.normalize(n)
    # the helper axis as a select of 0 and 1 on the device (no host
    # constant to copy, so a CUDA graph can capture it)
    use_y = (torch.abs(n[..., 0]) > 0.9)[..., None].to(n.dtype)
    a = torch.cat([1.0 - use_y, use_y, torch.zeros_like(use_y)], dim=-1)
    v = vm.normalize(vm.cross(n, a))
    u = vm.normalize(vm.cross(n, v))
    return u, v, w


def transform(basis, local: torch.Tensor) -> torch.Tensor:
    """Local (x, y, z) to world: x u + y v + z w (onb.go:38-43)."""
    u, v, w = basis
    return local[..., 0:1] * u + local[..., 1:2] * v + local[..., 2:3] * w
