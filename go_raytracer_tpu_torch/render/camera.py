"""Thin-lens camera: configuration surface and viewport math.

Reproduces the reference camera's public fields (camera/camera.go:24-62)
and `initialize` (camera.go:179-253) as a host computation in float64,
cast to float32 last. Effective spp is floor(sqrt(spp))^2 exactly as in the
reference (camera.go:211-212). On the in-kernel-queue path ray generation
happens inside the bounce kernel (ops/bounce.py) from the packed camera
row; the mesh path's window calls `generate_rays` here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from go_raytracer_tpu_torch.core import rng

Vec = Tuple[float, float, float]


@dataclasses.dataclass
class CameraArrays:
    """Derived camera vectors (float32 numpy, or float32 tensors: a
    tensor that requires a gradient, e.g. `center` and `pixel00` moved by
    a camera offset, keeps its graph through `generate_rays`);
    `defocus_angle` gates the thin-lens branch and `recip_spp_sqrt` scales
    the stratum jitter."""

    center: np.ndarray
    pixel00: np.ndarray
    du: np.ndarray
    dv: np.ndarray
    defocus_u: np.ndarray
    defocus_v: np.ndarray
    defocus_angle: float = 0.0
    recip_spp_sqrt: float = 0.1

    def to(self, device) -> "CameraArrays":
        """The same arrays with every vector a float32 tensor on `device`,
        so that `generate_rays` there copies nothing."""
        vec = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
        return dataclasses.replace(
            self, center=vec(self.center), pixel00=vec(self.pixel00),
            du=vec(self.du), dv=vec(self.dv), defocus_u=vec(self.defocus_u),
            defocus_v=vec(self.defocus_v))


@dataclasses.dataclass
class Camera:
    """Public configuration mirrors camera.go:24-36; `regen_cadence` and
    `regen_len` are the per-scene window hints of integrator/regen.py."""

    aspect_ratio: float = 1.0
    width: int = 100
    samples_per_pixel: int = 100
    max_depth: int = 10
    vertical_fov: float = 90.0
    defocus_angle: float = 0.0
    focus_distance: float = 10.0
    background: Vec = (0.0, 0.0, 0.0)
    max_contribution: float = 1.5
    # bounce levels per kernel call (0 = renderer default)
    regen_cadence: int = 0
    # mean path length (traced segments per path) of the scene's reference
    # config; sizes the window so one window covers the render
    regen_len: float = 0.0

    look_from: Vec = (0.0, 0.0, 0.0)
    look_at: Vec = (0.0, 0.0, -1.0)
    vup: Vec = (0.0, 1.0, 0.0)

    def position(self, look_from: Vec, look_at: Vec, vup: Vec = (0, 1, 0)):
        """PositionCamera (camera.go:65-81)."""
        self.look_from = tuple(look_from)
        self.look_at = tuple(look_at)
        self.vup = tuple(vup)
        return self

    @property
    def image_height(self) -> int:
        return max(1, int(self.width / self.aspect_ratio))  # camera.go:209

    @property
    def spp_sqrt(self) -> int:
        return int(math.sqrt(self.samples_per_pixel))  # camera.go:211

    @property
    def spp_effective(self) -> int:
        return self.spp_sqrt * self.spp_sqrt

    def derived(self) -> CameraArrays:
        """Viewport math (camera.go:215-246) in float64, cast last."""
        lf = np.asarray(self.look_from, dtype=np.float64)
        la = np.asarray(self.look_at, dtype=np.float64)
        vup = np.asarray(self.vup, dtype=np.float64)

        h = math.tan(math.radians(self.vertical_fov) / 2.0)
        vp_h = 2.0 * h * self.focus_distance
        vp_w = vp_h * (self.width / self.image_height)

        w = lf - la
        w /= np.linalg.norm(w)
        u = np.cross(vup, w)
        u /= np.linalg.norm(u)
        v = np.cross(w, u)

        viewport_u = u * vp_w
        viewport_v = -v * vp_h
        du = viewport_u / self.width
        dv = viewport_v / self.image_height
        top_left = lf - w * self.focus_distance - viewport_u / 2 - viewport_v / 2
        pixel00 = top_left + 0.5 * (du + dv)

        defocus_radius = self.focus_distance * math.tan(
            math.radians(self.defocus_angle / 2.0))
        f = lambda x: np.asarray(x, dtype=np.float32)
        return CameraArrays(
            center=f(lf), pixel00=f(pixel00), du=f(du), dv=f(dv),
            defocus_u=f(u * defocus_radius), defocus_v=f(v * defocus_radius),
            defocus_angle=self.defocus_angle,
            recip_spp_sqrt=1.0 / self.spp_sqrt)


N_U_RAYGEN = 5   # jitter x/y, defocus a/b, time


def generate_rays(arrays: CameraArrays, width: int, pixel_ids: torch.Tensor,
                  s_i: torch.Tensor, s_j: torch.Tensor, u: torch.Tensor):
    """Rays for flat pixel ids (row-major j*width+i) at stratum (s_i, s_j),
    from `u`, an (n, 5) float32 tensor of uniforms on the ids' device.
    Returns (origin (n, 3), direction (n, 3), time (n,)); where the
    camera's vectors are tensors, the rays are differentiable in them.

    getRay (camera.go:256-270): stratified jitter in the pixel footprint,
    optional defocus-disk origin, uniform ray time for motion blur."""
    dev = pixel_ids.device
    vec = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    i = (pixel_ids % width).to(torch.float32)
    j = torch.div(pixel_ids, width, rounding_mode="floor").to(torch.float32)
    # sampleSquareStratified (camera.go:277-282)
    off_x = (s_i + u[:, 0]) * arrays.recip_spp_sqrt - 0.5
    off_y = (s_j + u[:, 1]) * arrays.recip_spp_sqrt - 0.5
    pixel_sample = (vec(arrays.pixel00)[None, :]
                    + (i + off_x)[:, None] * vec(arrays.du)[None, :]
                    + (j + off_y)[:, None] * vec(arrays.dv)[None, :])
    if arrays.defocus_angle > 0:
        disk = rng.unit_disk(u[:, 2], u[:, 3])   # camera.go:285-290
        origin = (vec(arrays.center)[None, :]
                  + disk[:, 0:1] * vec(arrays.defocus_u)[None, :]
                  + disk[:, 1:2] * vec(arrays.defocus_v)[None, :])
    else:
        origin = vec(arrays.center)[None, :].expand(pixel_ids.shape[0], 3)
    return origin, pixel_sample - origin, u[:, 4]
