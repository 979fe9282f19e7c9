"""Film: tonemap + image writers.

Tonemap semantics match PrintColor (internal/vec/color.go:23-46) exactly:
per-component NaN -> 0, gamma-2 via sqrt (non-positive -> 0), clamp to
[0, 0.99999], scale by 256 and truncate to int.
"""

from __future__ import annotations

import numpy as np
import torch


def tonemap(linear: torch.Tensor) -> torch.Tensor:
    """Linear radiance (..., 3) float32 -> uint8-valued int32 in [0, 255]."""
    c = torch.nan_to_num(linear, nan=0.0, posinf=float("inf"),
                         neginf=float("-inf"))
    c = torch.where(c > 0, torch.sqrt(torch.clamp(c, min=0.0)),
                    torch.zeros_like(c))                       # color.go:14-19
    c = torch.clamp(c, 0.0, 0.99999)                           # color.go:11,41-43
    return (c * 256.0).to(torch.int32)


def write_ppm(path: str, rgb: np.ndarray):
    """P3 PPM matching the reference output layout (camera.go:160,
    color.go:45): header then one 'r g b' line per pixel."""
    rgb = np.asarray(rgb)
    h, w, _ = rgb.shape
    with open(path, "w") as fh:
        fh.write(f"P3\n{w} {h}\n255\n")
        flat = rgb.reshape(-1, 3)
        fh.write("\n".join(f"{r} {g} {b}" for r, g, b in flat))
        fh.write("\n")


def write_png(path: str, rgb: np.ndarray):
    from PIL import Image

    Image.fromarray(np.asarray(rgb, dtype=np.uint8)).save(path)


def write_image(path: str, rgb: np.ndarray):
    if path.endswith(".ppm"):
        write_ppm(path, rgb)
    else:
        write_png(path, rgb)
