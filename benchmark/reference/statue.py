"""The procedural statue that stands in for modelExample's `dragon.obj`:
a displaced (2, 3) torus knot, 256 x 128 x 2 = 65,536 triangles by
default. A frozen copy of the formula, so that the benchmark makes the
same triangles whatever the program under test does; the harness hands
them to the program and to the plain reference alike.

Plain numpy, float64. `statue_triangles` returns the triangles in object
space after the loader's scale, centring and placement (the OBJ path's
`scale_factor`, `center`, `position`); the instance transform (a turn
about y) is applied by whoever builds the scene.
"""

from __future__ import annotations

import numpy as np


def statue_triangles(major_segments: int = 256, minor_segments: int = 128,
                     scale_factor: float = 5.0, center: bool = True,
                     position=(0.0, 0.0, 0.0)) -> np.ndarray:
    """(T, 3, 3) float64 vertices of the displaced torus knot."""
    p, q = 2, 3
    t = np.linspace(0, 2 * np.pi, major_segments, endpoint=False)
    r = 2.0 + np.cos(q * t)
    cx = np.stack([r * np.cos(p * t), r * np.sin(p * t), -np.sin(q * t)], -1)
    # the tube's frame along the knot
    d = np.roll(cx, -1, 0) - cx
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    up = np.array([0.0, 0.0, 1.0])
    side = np.cross(d, up)
    side /= np.linalg.norm(side, axis=-1, keepdims=True)
    upv = np.cross(side, d)
    phi = np.linspace(0, 2 * np.pi, minor_segments, endpoint=False)
    tube_r = 0.55 + 0.08 * np.sin(7 * t)[:, None]
    ring = (cx[:, None, :]
            + tube_r[..., None] * (np.cos(phi)[None, :, None] * side[:, None, :]
                                   + np.sin(phi)[None, :, None] * upv[:, None, :]))
    verts = ring.reshape(-1, 3) * scale_factor
    if center:
        verts = verts - (verts.min(0) + verts.max(0)) / 2.0 \
            + np.asarray(position, dtype=np.float64)
    idx = np.arange(major_segments * minor_segments).reshape(
        major_segments, minor_segments)
    i1 = np.roll(idx, -1, axis=0)
    i2 = np.roll(idx, -1, axis=1)
    i3 = np.roll(i1, -1, axis=1)
    tris = np.concatenate([
        np.stack([idx.ravel(), i1.ravel(), i3.ravel()], -1),
        np.stack([idx.ravel(), i3.ravel(), i2.ravel()], -1)])
    return verts[tris]


def rotate_y(points: np.ndarray, degrees: float) -> np.ndarray:
    """Object-to-world turn about y of (..., 3) points: (c x + s z, y,
    -s x + c z)."""
    th = np.radians(degrees)
    c, s = np.cos(th), np.sin(th)
    out = np.empty_like(points)
    out[..., 0] = c * points[..., 0] + s * points[..., 2]
    out[..., 1] = points[..., 1]
    out[..., 2] = -s * points[..., 0] + c * points[..., 2]
    return out
