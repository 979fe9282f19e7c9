"""Asset loading: images for textures.

Mirrors internal/imageloader/imageLoader.go:29-88 — decode PNG/JPEG to an
RGB grid — using PIL on the host, normalized to float [0, 1] (the reference
scales by 1/255 at sample time, texture.go:84-85)."""

from __future__ import annotations

import os

import numpy as np

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "assets")


def find_asset(name: str) -> str:
    """Resolve an asset by absolute path, cwd, or the bundled assets/ dir."""
    for cand in (name, os.path.join(os.getcwd(), name),
                 os.path.join(_ASSET_DIR, name)):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f"asset not found: {name}")


def load_image(name: str) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1]."""
    from PIL import Image

    with Image.open(find_asset(name)) as im:
        rgb = np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0
    return rgb
