"""Render checkpoint/resume.

The reference has no checkpointing — a render runs to completion or dies,
with the whole image buffered in memory until the final write
(main.go:442-446, 479; SURVEY.md §5). Long TPU renders (1000+ spp
full-res) get sample-batch accumulation checkpoints instead: the
accumulator plus the (stratum, chunk) cursor are written to an .npz after
every stratum, and `render_resumable` picks up where it left off after a
crash or preemption.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np


def save(path: str, acc: np.ndarray, next_stratum: int, meta: dict,
         extra: Optional[dict] = None):
    """Atomic checkpoint write (tmp + rename). `extra` holds additional
    named arrays (e.g. the positional scheduler's per-lane start counts)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    # the suffix must be .npz or np.savez silently appends one and the
    # rename would move an empty file
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, acc=acc, next_stratum=np.int64(next_stratum),
                 **{f"meta_{k}": np.asarray(v) for k, v in meta.items()},
                 **{f"x_{k}": np.asarray(v) for k, v in (extra or {}).items()})
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(path: str):
    """Returns (acc, next_stratum, meta[, extra available via load_extra])
    or None if absent/corrupt."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            acc = z["acc"]
            next_stratum = int(z["next_stratum"])
            meta = {k[5:]: z[k] for k in z.files if k.startswith("meta_")}
        return acc, next_stratum, meta
    except Exception:
        return None


def load_extra(path: str) -> dict:
    """The `extra` arrays of a checkpoint ({} if absent/none)."""
    try:
        with np.load(path) as z:
            return {k[2:]: z[k] for k in z.files if k.startswith("x_")}
    except Exception:
        return {}


def meta_for(scene_name: str, cam) -> dict:
    return {
        "scene": np.bytes_(scene_name.encode()),
        "width": cam.width,
        "height": cam.image_height,
        "spp": cam.spp_effective,
        "max_depth": cam.max_depth,
    }


def compatible(meta_a: dict, meta_b: dict) -> bool:
    return all(np.array_equal(meta_a[k], meta_b[k])
               for k in ("scene", "width", "height", "spp", "max_depth")
               if k in meta_a and k in meta_b)
