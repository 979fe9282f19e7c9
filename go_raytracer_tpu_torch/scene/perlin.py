"""Perlin noise seeds (host part).

The noise itself is a gather-free hash-gradient lattice noise evaluated
inside the bounce kernel from a per-texture uint32 seed, replacing the
reference's permutation tables (hittable/perlin.go:20-31). The host only
draws those seeds; the in-kernel noise comes with the first scene that
needs it.
"""

from __future__ import annotations

import numpy as np


def make_seed(rng: np.random.Generator) -> np.uint32:
    """Per-texture seed, replacing NewPerlin's fresh tables
    (texture.go:104-109 -> perlin.go:20-31)."""
    return np.uint32(rng.integers(0, 2**32, dtype=np.uint32))
