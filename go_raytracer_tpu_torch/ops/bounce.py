"""The bounce kernels of the regen paths, and their host packing.

Counterpart of the JAX package's `ops/pallas/bounce.py`. Three parts:

* Host packing in numpy (`pack_scene`, `scene_statics`, `pack_camera`):
  primitives joined with their material/texture columns into one dense
  row table, lights and media into row tables, the camera into one row.
  Shapes and values are those of the JAX packing, for every dense scene.
* `bounce_fused_q`: `n_inner` bounce levels of the in-kernel-queue
  schedule. Each level refills dead lanes from the item queue in flat
  lane order, generates camera rays for them from a counter-based hash
  PRNG, runs one bounce (closest hit, emission, mixture light/cosine
  sampling), and writes the merged V plane and flag bits per lane.
  On a CUDA tensor it launches the hand-written kernel in
  `csrc/bounce_fused_q.cu`; on a CPU tensor it runs the plain PyTorch
  version `bounce_fused_q_ref` — the same function, op for op as the JAX
  kernel, which the tests hold against the JAX package.
  `bounce_fused_q_direct` is the same levels writing their records in
  place into whole-window buffers at a level base held on the device
  (the `grt_bounce_fused_q_direct` entry of the same source;
  `bounce_fused_q_direct_ref` on the CPU).

* `bounce_fused`: `n_inner` levels of the `queue` schedule, whose refill
  (which lanes start, and on which pixel and stratum) the caller computes
  and hands in as planes; it happens at the first level only.
  `csrc/bounce_fused.cu` on the card, `bounce_fused_ref` on the CPU.
* `bounce_fused_pos`: `n_inner` levels of the `positional` schedule: each
  lane carries its own next-item pointer as exact small-integer float32
  planes and restarts at any level. `csrc/bounce_fused_pos.cu` on the
  card, `bounce_fused_pos_ref` on the CPU.
* `bounce`: one bounce level from given uniforms, in the dense mode of
  the reference engine (`integrator/wavefront.radiance`) or with the
  mesh walk's closest hit (t, triangle) folded in, the mesh path's. CUDA tensors launch `csrc/bounce.cu`, CPU tensors run
  `bounce_ref`.

The four fused kernels cover the scenes `supported()` accepts: spheres
(moving ones too), quads and (rotated) fused boxes; lambertian, metal,
dielectric, diffuse-light and isotropic materials; constant-density
media; solid, checker, noise (perlin, marble, turbulent) and image
textures (K9, `bounce_fused_q_direct`, refuses images, as the JAX
package's direct-record path does); quad and sphere lights; camera rays
with or without defocus. `bounce` covers the same features in its dense
mode, and with the external mesh hit (`supported_ext`) a mesh beside
them, image-textured ones included. Everything else (triangle lights,
tables over the caps) raises; nothing falls back. All share one bounce
core (`_bounce_core_ref`
here, `csrc/bounce_core.cuh` on the card, compiled once per feature set),
and the fused ones one PRNG and one camera ray generation
(`_camera_rays_ref`, `csrc/fused_common.cuh`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from go_raytracer_tpu_torch.core import rng
from go_raytracer_tpu_torch.ops import _cuda
from go_raytracer_tpu_torch.scene import perlin
from go_raytracer_tpu_torch.scene import types as T

INV_PI = 1.0 / math.pi
INV_4PI = 1.0 / (4.0 * math.pi)
T_MIN = 1e-3  # rayColor's interval.New(0.001, inf) (camera.go:300)

# primitive row layout — kind-homogeneous sections share the material block
# sphere: 0 kind, 1-3 c0, 4-6 cd, 7 r, 8 r^2
# quad:   0 kind, 1-3 normal, 4 D, 5-7 cvw, 8-10 cwu, 11 qcvw, 12 qcwu
# box:    0 kind, 1-3 lo, 4-6 hi, 7 cos, 8 sin, 9-11 offset
# material block from col MAT_BASE, scene-specialized (_mat_layout)
MAT_BASE = 13
P_BLOCK = 8        # sections are padded to a multiple of this many rows

# light row: 0 kind (0 quad, 1 sphere); quad: 1-3 q, 4-6 u, 7-9 v,
# 10-12 normal, 13 D, 14-16 cvw, 17-19 cwu, 20 qcvw, 21 qcwu, 22 area;
# sphere: 1-3 c0, 4 r
L_COLS = 23
M_COLS = 20

N_U = 9          # uniforms per bounce (+1 per medium)
N_U_RAYGEN = 5   # camera ray generation: jitter x/y, defocus a/b, time

# the CUDA kernel's block size; the lane count must be a multiple of it
BLOCK = 256
# feature bit of the fused kernels' image variant (csrc/fused_common.cuh)
FEAT_IMG = 32

# Launches of the CUDA kernel through `bounce_fused_q` and
# `bounce_fused_q_direct` (one per call each).
launches = 0
launches_direct = 0
# Launches of the CUDA kernel through `bounce` (one per call) and of the
# mesh path's dense cap (`K3Launch.cap`, one per call).
launches_bounce = 0
launches_cap = 0
# Launches of the CUDA kernels through `bounce_fused` and
# `bounce_fused_pos` (one per call each).
launches_fused = 0
launches_fused_pos = 0


def _mat_layout(st: dict):
    """Ordered logical material columns for this scene's prim table."""
    cols = ["kind", "ev_r", "ev_g", "ev_b", "od_r", "od_g", "od_b"]
    if st["has_noise"] or st["has_image"]:
        cols.append("texk")      # TEX_* discriminator
    if st["has_metal"] or st["has_dielectric"]:
        cols.append("fr")        # metal fuzz | dielectric ref_idx (disjoint)
    if st["has_checker"] or st["has_noise"]:
        cols.append("scale")     # checker inv_scale | noise scale (disjoint)
    if st["has_noise"] or st["has_image"]:
        cols.append("seed_img")  # noise seed bits | image id (disjoint)
    return cols


MAX_PRIMS = 4096
MAX_LIGHTS = 8
MAX_MEDIA = 8


def _refused_statics(st: dict) -> list:
    """What in these statics the fused kernels do not compute, in words."""
    named = [("an external mesh hit", st["ext_hit"]),
             (f"more than {MAX_MEDIA} media", st["n_media"] > MAX_MEDIA),
             (f"no primitive or more than {MAX_PRIMS}",
              not 0 < st["n_sph"] + st["n_quad"] + st["n_box"] <= MAX_PRIMS),
             (f"no light or more than {MAX_LIGHTS}",
              not 0 < st["n_lights_live"] <= MAX_LIGHTS)]
    return [name for name, on in named if on]


def supported_statics(st: dict) -> bool:
    """The fused kernels' subset, read from `scene_statics`: spheres, quads
    and fused boxes; lambertian, metal, dielectric, diffuse-light and
    isotropic materials; constant-density media; solid, checker, noise
    (perlin, marble, turbulent) and image textures; at most MAX_PRIMS rows,
    MAX_LIGHTS lights and MAX_MEDIA media, and no external mesh hit."""
    return not _refused_statics(st)


def refused_features(scene: T.Scene) -> list:
    """What keeps a scene off the fused kernels, in words (empty when
    `supported(scene)`): triangles (kept outside the packed tables),
    triangle lights (the light sampler covers quad and sphere rows), and
    what `supported_statics` refuses."""
    return ([m for m, on in (("triangles", scene.has_triangles),
                             ("triangle lights", scene.has_tri_lights)) if on]
            + _refused_statics(scene_statics(scene)))


def supported(scene: T.Scene) -> bool:
    """True when `bounce_fused_q` carries the scene."""
    return not refused_features(scene)


def fused_features(st: dict) -> int:
    """The compile-time feature set of the bounce core for these statics,
    the fused kernels' and `bounce`'s (csrc/fused_common.cuh): bit 0 the sphere section, bit 1
    the fr column (metal fuzz or dielectric index) with the dielectric
    branch, bit 2 isotropic scattering with the media loop, bit 3 the
    texture value (the checker select and the noise), on when the layout
    has a scale column or the scene has images; bit 5 (FEAT_IMG) the image
    texel read inside the kernel, only ever with bit 3. A scene without
    spheres, fr column, media and textures runs the core compiled without
    them. The kernels (`bounce` too) add bit 4, the cull of the scan,
    themselves, for a table of which some section holds more than one
    block of SCAN_BLOCK rows (csrc/fused_common.cuh)."""
    lay = _mat_layout(st)
    return ((1 if st["n_sph"] else 0)
            | (2 if "fr" in lay else 0)
            | (4 if st["has_isotropic"] else 0)
            | (8 if "scale" in lay or st["has_image"] else 0)
            | (FEAT_IMG if st["has_image"] else 0))


def supported_ext_statics(st: dict) -> bool:
    """What `bounce` with an external mesh hit carries, read from
    `scene_statics`: every feature of the fused kernels (every material,
    texture and medium), within MAX_PRIMS rows, MAX_LIGHTS lights and
    MAX_MEDIA media (the JAX package's `supported_ext`)."""
    return (st["n_media"] <= MAX_MEDIA
            and 0 < st["n_sph"] + st["n_quad"] + st["n_box"] <= MAX_PRIMS
            and 0 < st["n_lights_live"] <= MAX_LIGHTS)


def supported_ext(scene: T.Scene) -> bool:
    """True when `bounce` with external mesh-hit planes carries the scene
    (the JAX package's `supported_ext`): triangles are allowed (their
    closest hit arrives as planes), triangle lights are not (the light
    sampler covers quad and sphere rows), nor tables over the caps."""
    if scene.has_tri_lights:
        return False
    return supported_ext_statics(scene_statics(scene, ext=True))


def scene_statics(scene: T.Scene, ext: bool = False) -> dict:
    """Static kernel parameters from the scene's flags and table shapes.
    `ext`: the bounce folds an externally computed mesh closest hit
    (the walk's `MeshHit`, or on the CPU the planes of
    `ext_planes_from_hit`) into its winner."""
    n_sph = scene.spheres.count if scene.has_spheres else 0
    n_quad = scene.quads.count if scene.has_quads else 0
    n_box = scene.boxes.count if scene.has_boxes else 0
    pad8 = lambda x: (x + P_BLOCK - 1) // P_BLOCK * P_BLOCK
    return dict(
        n_sph=n_sph, n_quad=n_quad, n_box=n_box,
        sph_base=0, quad_base=pad8(n_sph),
        box_base=pad8(n_sph) + pad8(n_quad),
        n_rows=pad8(n_sph) + pad8(n_quad) + pad8(n_box),
        n_lights=scene.lights.count, n_lights_live=scene.lights.n,
        n_media=scene.media.count if scene.has_media else 0,
        has_metal=scene.has_metal, has_dielectric=scene.has_dielectric,
        has_isotropic=scene.has_isotropic or scene.has_media,
        has_noise=scene.has_noise, has_image=scene.has_image,
        has_checker=scene.has_checker, box_rot=scene.has_rot_boxes,
        ext_hit=ext, cull=False)


def join_mat_cols(scene: T.Scene, lay, mat_id):
    """The scene-specialized material/texture columns (_mat_layout) for a
    vector of material ids: solid albedo folds into the checker even/odd
    pair, and mutually exclusive parameters share one column."""
    mats = scene.materials
    tex = scene.textures
    tex_id = mats.tex_id[mat_id]
    kind_t = tex.kind[tex_id]
    is_check = kind_t == T.TEX_CHECKER
    ev = np.where(is_check[:, None], tex.even[tex_id], tex.color[tex_id])
    od = np.where(is_check[:, None], tex.odd[tex_id], tex.color[tex_id])
    vals = {"kind": mats.kind[mat_id].astype(np.float32),
            "ev_r": ev[:, 0], "ev_g": ev[:, 1], "ev_b": ev[:, 2],
            "od_r": od[:, 0], "od_g": od[:, 1], "od_b": od[:, 2]}
    if "texk" in lay:
        vals["texk"] = kind_t.astype(np.float32)
    if "fr" in lay:
        vals["fr"] = np.where(mats.kind[mat_id] == T.MAT_METAL,
                              mats.fuzz[mat_id], mats.ref_idx[mat_id])
    if "scale" in lay:
        vals["scale"] = np.where(is_check, tex.inv_scale[tex_id],
                                 tex.scale[tex_id])
    if "seed_img" in lay:
        seed_f = np.asarray(scene.perlin.seed[tex.noise_id[tex_id]],
                            np.uint32).view(np.float32)
        vals["seed_img"] = np.where(kind_t == T.TEX_IMAGE,
                                    tex.image_id[tex_id].astype(np.float32),
                                    seed_f)
    return [np.asarray(vals[c], np.float32) for c in lay]


def pack_scene(scene: T.Scene):
    """Dense row tables for the kernel: primitives (P, MAT_BASE +
    len(_mat_layout)) in kind sections (spheres, quads, boxes), each padded
    to a P_BLOCK multiple with kind=-1 rows and kept in declaration order
    (the reference's strict-`<` tie-break); lights (L, L_COLS); media
    (M, M_COLS); and the 1-row block-AABB placeholder (the JAX package's
    `cull=False` table; of its culled variant the port keeps only the
    Morton box of the lane coherence sort, `coherence_bounds`).
    Returns numpy arrays (prims, lights, media, blk), float32, and when the
    scene has image textures also its image table: the texels (n_img, Hm,
    Wm, 3) float32, padded to the largest image, and each image's (w, h)
    (n_img, 2) int32, both contiguous (the fused kernels read the texel at
    a hit's uv from them)."""
    st = scene_statics(scene)
    lay = _mat_layout(st)
    p_cols = MAT_BASE + len(lay)
    mat_cols = lambda mat_id: join_mat_cols(scene, lay, mat_id)

    def section(cols, active, count):
        rows = np.where(active[:, None],
                        np.stack([np.asarray(c, np.float32) for c in cols],
                                 axis=1),
                        np.full((count, p_cols), -1.0, np.float32))
        pad = (-count) % P_BLOCK
        if pad:
            rows = np.concatenate(
                [rows, np.full((pad, p_cols), -1.0, np.float32)])
        return rows

    sections = []
    if scene.has_spheres:
        sp = scene.spheres
        zero = np.zeros_like(sp.radius)
        cols = ([zero] + [sp.center0[:, i] for i in range(3)]
                + [sp.center_delta[:, i] for i in range(3)]
                + [sp.radius, sp.radius * sp.radius] + [zero] * 4
                + mat_cols(sp.mat_id))
        sections.append(section(cols, sp.active, sp.count))
    if scene.has_quads:
        qd = scene.quads
        qcvw = np.sum(qd.q * qd.cvw, axis=-1, dtype=np.float32)
        qcwu = np.sum(qd.q * qd.cwu, axis=-1, dtype=np.float32)
        cols = ([np.ones_like(qd.area)] + [qd.normal[:, i] for i in range(3)]
                + [qd.d_plane] + [qd.cvw[:, i] for i in range(3)]
                + [qd.cwu[:, i] for i in range(3)] + [qcvw, qcwu]
                + mat_cols(qd.mat_id))
        sections.append(section(cols, qd.active, qd.count))
    if scene.has_boxes:
        bx = scene.boxes
        zero = np.zeros_like(bx.lo[:, 0])
        cols = ([np.full_like(bx.lo[:, 0], 3.0)]
                + [bx.lo[:, i] for i in range(3)]
                + [bx.hi[:, i] for i in range(3)]
                + [bx.cos_t, bx.sin_t] + [bx.offset[:, i] for i in range(3)]
                + [zero] + mat_cols(bx.mat_id))
        sections.append(section(cols, bx.active, bx.count))
    prims = np.concatenate(sections, axis=0).astype(np.float32)
    blk = np.zeros((1, 16), np.float32)

    lt = scene.lights
    lrows = []
    for li in range(lt.count):
        pid = int(lt.prim_id[li])
        if scene.has_quads:
            qd = scene.quads
            k = min(max(pid, 0), qd.count - 1)
            qrow = np.concatenate([
                np.zeros((1,), np.float32), qd.q[k], qd.u[k], qd.v[k],
                qd.normal[k], qd.d_plane[k][None], qd.cvw[k], qd.cwu[k],
                np.sum(qd.q[k] * qd.cvw[k], dtype=np.float32)[None],
                np.sum(qd.q[k] * qd.cwu[k], dtype=np.float32)[None],
                qd.area[k][None]])
        else:
            qrow = np.zeros((L_COLS,), np.float32)
        if scene.has_spheres:
            sp = scene.spheres
            k = min(max(pid, 0), sp.count - 1)
            srow = np.concatenate([np.ones((1,), np.float32), sp.center0[k],
                                   sp.radius[k][None],
                                   np.zeros((L_COLS - 5,), np.float32)])
        else:
            srow = np.zeros((L_COLS,), np.float32)
        lrows.append(qrow if lt.kind[li] == T.LIGHT_QUAD else srow)
    lights = np.stack(lrows).astype(np.float32)

    md = scene.media
    alb = scene.textures.color[scene.materials.tex_id[md.mat_id]]
    med = np.stack(
        [md.kind.astype(np.float32)] + [md.center[:, i] for i in range(3)]
        + [md.radius, md.cos_t, md.sin_t] + [md.offset[:, i] for i in range(3)]
        + [md.box_min[:, i] for i in range(3)]
        + [md.box_max[:, i] for i in range(3)] + [md.neg_inv_density]
        + [alb[:, i] for i in range(3)], axis=1).astype(np.float32)
    if st["has_image"]:
        return (prims, lights, med, blk,
                np.array(scene.images.data, np.float32),
                np.array(scene.images.wh, np.int32))
    return prims, lights, med, blk


def pack_camera(arrays) -> np.ndarray:
    """Flatten CameraArrays to the kernel's (1, 20) float32 row:
    pixel00, du, dv, center, defocus_u, defocus_v, 1/sqrt(spp), 0."""
    return np.concatenate([
        arrays.pixel00, arrays.du, arrays.dv, arrays.center,
        arrays.defocus_u, arrays.defocus_v,
        np.asarray([arrays.recip_spp_sqrt, 0.0], np.float32),
    ]).astype(np.float32).reshape(1, 20)


# ---------------------------------------------------------------------------
# counter-based PRNG, bit for bit the JAX kernel's. torch has no uint32
# arithmetic, so values live in int64 tensors masked to 32 bits.
# ---------------------------------------------------------------------------

_M32, _mul32, _mix32 = rng.M32, rng.mul32, rng.mix32
_bits_to_u01 = rng.bits_to_u01


def _u01_dyn(lane, seed, slot):
    """U[0,1) = hash(lane, seed, slot). Arguments are int64 tensors or ints
    holding uint32 values (a negative int32 seed is taken mod 2^32)."""
    x = lane ^ _mul32(torch.as_tensor(seed) & _M32, 0x9E3779B9) \
        ^ _mul32(torch.as_tensor(slot) & _M32, 0x632BE5AB)
    return _bits_to_u01(_mix32(x))


def _u01(lane, seed: int, slot: int):
    """`_u01_dyn` for a slot and a seed known on the host (the JAX
    package's static-slot `_u01`): both multiplies fold into constants."""
    x = lane ^ (((seed & _M32) * 0x9E3779B9) & _M32) \
        ^ ((slot * 0x632BE5AB) & _M32)
    return _bits_to_u01(_mix32(x))


def _item_to_coords(item, npix: int, width: int, sqrt_spp: int):
    """(pi, pj, si, sj) of stratum-major item ids
    (item = stratum * npix + pixel, pixel = pj * width + pi,
    stratum = si * sqrt_spp + sj), by exact integer division."""
    stratum = torch.div(item, npix, rounding_mode="floor")
    pixel = item - stratum * npix
    pj = torch.div(pixel, width, rounding_mode="floor")
    si = torch.div(stratum, sqrt_spp, rounding_mode="floor")
    return pixel - pj * width, pj, si, stratum - si * sqrt_spp


# ---------------------------------------------------------------------------
# plain PyTorch version (the CPU path, and the yardstick of the CUDA kernel)
# ---------------------------------------------------------------------------

def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _normalize3(x, y, z):
    inv = torch.rsqrt(x * x + y * y + z * z + 1e-38)
    return x * inv, y * inv, z * inv


def _safe_d(v):
    """v kept at least 1e-30 away from zero, its sign kept."""
    return torch.where(torch.abs(v) < 1e-30, torch.where(v < 0, -1e-30, 1e-30),
                       v)


def _onb_transform(nx, ny, nz, lx, ly, lz):
    """The reference ONB about n (onb.go:13-25) applied to (lx, ly, lz)."""
    wx, wy, wz = _normalize3(nx, ny, nz)
    use_y = torch.abs(nx) > 0.9
    ax = torch.where(use_y, 0.0, 1.0)
    ay = torch.where(use_y, 1.0, 0.0)
    vx = ny * 0.0 - nz * ay
    vy = nz * ax - nx * 0.0
    vz = nx * ay - ny * ax
    vx, vy, vz = _normalize3(vx, vy, vz)
    ux = ny * vz - nz * vy
    uy = nz * vx - nx * vz
    uz = nx * vy - ny * vx
    ux, uy, uz = _normalize3(ux, uy, uz)
    return (lx * ux + ly * vx + lz * wx,
            lx * uy + ly * vy + lz * wy,
            lx * uz + ly * vz + lz * wz)


def _media_update(st, med, rays, u, t_best, n_hx, n_hy, n_hz):
    """Constant-density media (medium.go:27-58), after every primitive
    section and the ext hit: each medium's boundary span (sphere roots, or
    the rotated box's slabs in object space) clamped by the closest hit so
    far, and an exponential free-flight distance from the medium's
    uniform u[N_U + m]. A medium winner carries normal (1, 0, 0), front
    face true and an isotropic material with the medium's albedo. Returns
    the updated (t_best, normal xyz) and the winning medium's index per
    lane (-1 where none wins)."""
    ox, oy, oz, dx, dy, dz, a_quad, inv_a = rays
    ray_len = torch.sqrt(a_quad)
    inv_len = 1.0 / ray_len
    med_idx = torch.full_like(ox, -1, dtype=torch.int64)
    for m, g in enumerate(med.tolist()[:st["n_media"]]):
        if g[0] > 0.5:
            # box span in object space (transformation.go:25-34, 79-85)
            cth, sth = g[5], g[6]
            osx = ox - g[7]
            osz = oz - g[9]
            xo = cth * osx - sth * osz
            yo = oy - g[8]
            zo = sth * osx + cth * osz
            dxo = cth * dx - sth * dz
            dzo = sth * dx + cth * dz
            near = torch.full_like(ox, -float("inf"))
            far = torch.full_like(ox, float("inf"))
            for oc, dc, lo_c, hi_c in ((xo, dxo, 10, 13), (yo, dy, 11, 14),
                                       (zo, dzo, 12, 15)):
                t0a = (g[lo_c] - oc) / _safe_d(dc)
                t1a = (g[hi_c] - oc) / _safe_d(dc)
                near = torch.maximum(near, torch.minimum(t0a, t1a))
                far = torch.minimum(far, torch.maximum(t0a, t1a))
            ok = far > near
        else:
            # sphere span
            cx, cy, cz = g[1] - ox, g[2] - oy, g[3] - oz
            h = _dot3(dx, dy, dz, cx, cy, cz)
            c = _dot3(cx, cy, cz, cx, cy, cz) - g[4] * g[4]
            disc = h * h - a_quad * c
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            near = (h - sq) * inv_a
            far = (h + sq) * inv_a
            ok = disc >= 0.0
        ok = ok & (far > near + 1e-4)      # second boundary hit (medium.go:34)
        t0 = torch.clamp(near, min=T_MIN)  # medium.go:37
        t1 = torch.minimum(far, t_best)    # medium.go:38
        ok = ok & (t0 < t1)                # medium.go:39
        t0 = torch.clamp(t0, min=0.0)      # medium.go:43
        dist_inside = (t1 - t0) * ray_len
        hit_dist = g[16] * torch.log(u[N_U + m])
        ok = ok & (hit_dist <= dist_inside)
        t_c = t0 + hit_dist * inv_len
        win = ok & (t_c < t_best)
        t_best = torch.where(win, t_c, t_best)
        n_hx = torch.where(win, 1.0, n_hx)    # medium.go:54
        n_hy = torch.where(win, 0.0, n_hy)
        n_hz = torch.where(win, 0.0, n_hz)
        med_idx = torch.where(win, m, med_idx)
    return t_best, n_hx, n_hy, n_hz, med_idx


def _texture_value(st, mat, hx, hy, hz, lit):
    """The albedo at the hit points (texture.go:25-60, 88-125), op for op
    as the JAX kernel: the checker select by the parity of the summed
    floors of scale * p (solid and noise rows pack even == odd, so the
    select is unconditional wherever the layout has a scale column), then
    on noise rows perlin 0.5 (1 + noise(scale p)), marble 0.5 (1 +
    sin(scale pz + 10 turb(p))) or turbulent turb(p) as gray. The noise
    is computed only on the `lit` lanes whose row needs it (the others'
    texture is never read). Returns (r, g, b) planes."""
    if "scale" not in mat:
        return mat["ev_r"], mat["ev_g"], mat["ev_b"]
    sc = mat["scale"]
    fsum = sum(torch.floor(sc * h).to(torch.int32) for h in (hx, hy, hz))
    even = torch.remainder(fsum, 2) == 0
    tex = [torch.where(even, mat["ev_" + c], mat["od_" + c]) for c in "rgb"]
    if not st["has_noise"]:
        return tuple(tex)
    texk = mat["texk"]
    seed = mat["seed_img"].view(torch.int32).to(torch.int64) & _M32
    gray = torch.zeros_like(hx)
    lane_p = torch.nonzero(lit & (texk == float(T.TEX_PERLIN))).squeeze(1)
    lane_t = torch.nonzero(lit & ((texk == float(T.TEX_MARBLE))
                                  | (texk == float(T.TEX_TURBULENT)))) \
        .squeeze(1)
    if lane_p.numel():                                    # texture.go:115
        s_p = sc[lane_p]
        nz = perlin.noise_planes(seed[lane_p], s_p * hx[lane_p],
                                 s_p * hy[lane_p], s_p * hz[lane_p])
        gray[lane_p] = 0.5 * (1.0 + nz)
    if lane_t.numel():
        tb = perlin.turbulence_planes(seed[lane_t], hx[lane_t], hy[lane_t],
                                      hz[lane_t])
        marble = texk[lane_t] == float(T.TEX_MARBLE)     # texture.go:117
        gray[lane_t] = torch.where(
            marble, 0.5 * (1.0 + torch.sin(sc[lane_t] * hz[lane_t]
                                           + 10.0 * tb)), tb)  # :119
    need = torch.zeros_like(lit)
    need[lane_p] = True
    need[lane_t] = True
    return tuple(torch.where(need, gray, t) for t in tex)


def _atan2(y, x):
    """atan2 by the JAX kernel's degree-9 minimax polynomial (A&S 4.4.49,
    ~1e-5 rad), op for op: the sphere uv must index the same texel."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    hi = torch.maximum(ax, ay)
    t = torch.minimum(ax, ay) / torch.clamp(hi, min=1e-30)
    t2 = t * t
    r = t * (0.9998660 + t2 * (-0.3302995 + t2 * (0.1801410 + t2 * (
        -0.0851330 + 0.0208351 * t2))))
    r = torch.where(ay > ax, 0.5 * math.pi - r, r)
    r = torch.where(x < 0.0, math.pi - r, r)
    return torch.where(y < 0.0, -r, r)


def _acos(x):
    """acos(x) = atan2(sqrt(1 - x^2), x), the JAX kernel's. The square root
    is taken in float64 and rounded once, the correctly rounded float32
    root that XLA and the card's `__fsqrt_rn` give: PyTorch's float32
    `sqrt` on the CPU may be one ulp off, which can move the texel."""
    root = torch.sqrt(torch.clamp(1.0 - x * x, min=0.0).to(torch.float64))
    return _atan2(root.to(x.dtype), x)


def image_texel_index(wh, hm: int, wm: int, img_id, u, v):
    """Flat index into the (n_img, Hm, Wm, 3) texel table, as rows of 3,
    of the nearest texel at (u, v) (texture.go:70-86, the JAX package's
    `sampling.image_value`): truncated mod-repeat, v flipped, truncation to
    int and the clamp to the image's own (w, h) (imageLoader.go:49-62)."""
    uu = torch.abs(torch.fmod(u, 1.0))
    vv = 1.0 - torch.abs(torch.fmod(v, 1.0))
    w = wh[img_id, 0]
    h = wh[img_id, 1]
    i = (uu * (w.to(u.dtype) - 1.0)).to(torch.int32)
    j = (vv * (h.to(u.dtype) - 1.0)).to(torch.int32)
    i = torch.minimum(torch.clamp(i, min=0), w - 1).to(torch.int64)
    j = torch.minimum(torch.clamp(j, min=0), h - 1).to(torch.int64)
    return (img_id.to(torch.int64) * hm + j) * wm + i


def image_value(data, wh, img_id, u, v):
    """(N, 3) nearest texels of images `img_id` at (u, v): the JAX
    package's `sampling.image_value` on the `pack_scene` image table."""
    idx = image_texel_index(wh, data.shape[1], data.shape[2], img_id, u, v)
    return data.reshape(-1, 3)[idx]


def _image_albedo(images, is_img, img_f, is_sph, out_n, quad_uv):
    """The texel albedo of the lanes `is_img` (lit, diffuse, their row's
    texk an image; the JAX package's patch `patch_image_weight_planes`):
    uv of a sphere from its pre-flip outward normal `out_n`
    (objects.go:44-50), of a quad its (alpha, beta) `quad_uv`
    (objects.go:196-199); image id `img_f` (the seed_img column). Returns
    the (r, g, b) planes and the texel's flat index (-1 off `is_img`)."""
    data, wh = images
    ox_, oy_, oz_ = out_n
    theta = _acos(torch.clamp(-oy_, -1.0, 1.0))
    phi = _atan2(-oz_, ox_) + math.pi
    uu = torch.where(is_sph, phi * (0.5 * INV_PI), quad_uv[0])
    vv = torch.where(is_sph, theta * INV_PI, quad_uv[1])
    zero = torch.zeros_like(uu)
    img_id = torch.where(is_img, img_f, 0.0).to(torch.int64)
    idx = image_texel_index(wh, data.shape[1], data.shape[2], img_id,
                            torch.where(is_img, uu, zero),
                            torch.where(is_img, vv, zero))
    texel = data.reshape(-1, 3)[idx]
    return (texel[:, 0], texel[:, 1], texel[:, 2],
            torch.where(is_img, idx, -1))


# ---- the closest-hit scan: the brute-force plain version, and the CUDA
# kernels' culled scan and its plain model -----------------------------------
#
# The CUDA kernels (csrc/bounce_core.cuh) scan a table built here once per
# scene (`scan_layout`): each section's rows in the scan's order, in blocks
# of SCAN_BLOCK, each block led by the bounds of its rows. Spheres of more
# than one block in the Morton order of their swept boxes' centres (the JAX
# package's `pack_scene(cull=True)` key), quads and boxes in declaration
# order (on book2's grid of boxes a warp needs fewer blocks so:
# scripts/sim_sphere_cull.py); spheres and boxes carry their declaration
# row, and inactive ones are left out. A section of more than one block is
# culled: a block whose padded bounds the ray cannot meet in (T_MIN,
# t_best] is skipped. A row takes the winner's place when it is nearer, or
# as near and declared earlier, so the winner is the declaration-order
# scan's whatever the order (`closest_culled_ref` is the plain model the
# tests hold to `closest_ref`).
SCAN_BLOCK = 8
SCAN_F4 = (2, 3, 3)        # float4s of a staged sphere, quad and box row
SCAN_PAD = 4e-3            # CULL_PAD of csrc/bounce_core.cuh
# a lane whose direction's largest component is below this scans every
# block (the cull's proof bounds t by that component)
SCAN_MIN_D = 2.0 ** -64
# the dynamic shared memory the kernels stage the scan table in, bytes
# (STAGE_BYTES of csrc/bounce_core.cuh)
STAGE_BYTES = 56 * 1024 - 128


def _morton30(p, lo, ext):
    """30-bit Morton code of float32 points (N, 3) in the box [lo, lo +
    ext), as the JAX package's `pack_scene` computes it."""
    from go_raytracer_tpu_torch.ops.trace import _part1by2

    q = np.clip((p - lo) / ext * np.float32(1024.0), 0.0,
                1023.0).astype(np.int32)
    return (_part1by2(q[:, 0]) << 2) | (_part1by2(q[:, 1]) << 1) \
        | _part1by2(q[:, 2])


def coherence_bounds(scene: T.Scene):
    """The box (blo, bext) in which the lane coherence sort
    (`integrator/regen.coherence_sort`) takes the Morton code of a lane's
    origin, each a (3,) float32 array, as the JAX package's window derives
    it from the block table of `pack_scene(scene, cull=True)`: blo the least
    corner of every active primitive's box, bext the span to the greatest
    corner, at least 1e-6. A sphere's box holds it over the motion with
    radius |r|; a quad's is the hull of its four corners widened by 1e-4; a
    box's the hull of its eight rotated corners plus the offset. Inactive
    rows count as the table's empty boxes (lo 3e38, hi -3e38); a scene
    without dense primitives has the table's one zero row: blo 0, bext
    1e-6. Everything in float32, in the JAX package's order of operations,
    so that the Morton cells, and with them the permutation, are its own
    (`_row_bounds`, the scan table's boxes, rounds otherwise)."""
    f32 = lambda a: np.asarray(a, np.float32)
    big = np.float32(3e38)
    los, his = [], []

    def add(lo, hi, active):
        act = np.asarray(active, bool)[:, None]
        los.append(np.where(act, lo, big).min(axis=0, initial=big))
        his.append(np.where(act, hi, -big).max(axis=0, initial=-big))

    if scene.has_spheres:
        sp = scene.spheres
        c0 = f32(sp.center0)
        c1 = c0 + f32(sp.center_delta)
        r = np.abs(f32(sp.radius))[:, None]
        add(np.minimum(c0, c1) - r, np.maximum(c0, c1) + r, sp.active)
    if scene.has_quads:
        qd = scene.quads
        q, u, v = f32(qd.q), f32(qd.u), f32(qd.v)
        corners = np.stack([q, q + u, q + v, q + u + v])
        eps = np.float32(1e-4)
        add(corners.min(axis=0) - eps, corners.max(axis=0) + eps, qd.active)
    if scene.has_boxes:
        bx = scene.boxes
        lo, hi = f32(bx.lo), f32(bx.hi)
        cs, sn, off = f32(bx.cos_t), f32(bx.sin_t), f32(bx.offset)
        cw = []
        for m in range(8):
            x = np.where(m & 1, hi[:, 0], lo[:, 0])
            y = np.where(m & 2, hi[:, 1], lo[:, 1])
            z = np.where(m & 4, hi[:, 2], lo[:, 2])
            cw.append(np.stack([cs * x + sn * z, y, -sn * x + cs * z],
                               axis=-1) + off)
        cw = np.stack(cw)
        add(cw.min(axis=0), cw.max(axis=0), bx.active)
    if not los:
        return np.zeros(3, np.float32), np.full(3, 1e-6, np.float32)
    blo = np.min(los, axis=0).astype(np.float32)
    with np.errstate(over="ignore"):
        bext = np.maximum(np.max(his, axis=0).astype(np.float32) - blo,
                          np.float32(1e-6))
    return blo, bext.astype(np.float32)


def _row_bounds(prims, st, sec):
    """(rows, lo, hi, active) of section `sec` (0 spheres, 1 quads, 2
    boxes): its declaration rows and each row's world box, float32. A
    sphere's box holds it over the motion, radius |r|; a quad's is the hull
    of the corners its packed columns describe (alpha, beta in {0, 1} on
    its plane, solved in float64 and rounded outward); a box's the hull of
    its rotated corners plus the offset (the JAX package's formula)."""
    base, n = ((st["sph_base"], st["n_sph"]), (st["quad_base"], st["n_quad"]),
               (st["box_base"], st["n_box"]))[sec]
    rows = np.arange(base, base + n, dtype=np.int64)
    g = prims[rows]
    act = g[:, 0] >= 0.0
    lo = np.zeros((n, 3), np.float32)
    hi = np.zeros((n, 3), np.float32)
    if sec == 0:
        c0 = g[:, 1:4]
        c1 = c0 + g[:, 4:7]
        r = np.abs(g[:, 7:8])
        lo, hi = np.minimum(c0, c1) - r, np.maximum(c0, c1) + r
    elif sec == 1 and act.any():
        q = g[act].astype(np.float64)
        m = np.stack([q[:, 5:8], q[:, 8:11], q[:, 1:4]], axis=1)
        corners = np.stack([np.linalg.solve(m, np.stack(
            [q[:, 11] + a, q[:, 12] + b, q[:, 4]], axis=1)[..., None])[..., 0]
            for a in (0.0, 1.0) for b in (0.0, 1.0)])
        lo[act] = np.nextafter(corners.min(axis=0).astype(np.float32),
                               np.float32(-np.inf))
        hi[act] = np.nextafter(corners.max(axis=0).astype(np.float32),
                               np.float32(np.inf))
    elif sec == 2:
        cs, sn = g[:, 7], g[:, 8]
        pts = []
        for m in range(8):
            x = np.where(m & 1, g[:, 4], g[:, 1])
            y = np.where(m & 2, g[:, 5], g[:, 2])
            z = np.where(m & 4, g[:, 6], g[:, 3])
            pts.append(np.stack([cs * x + sn * z, y, -sn * x + cs * z],
                                axis=1) + g[:, 9:12])
        pts = np.stack(pts)
        lo, hi = pts.min(axis=0), pts.max(axis=0)
    return rows, lo.astype(np.float32), hi.astype(np.float32), act


@dataclasses.dataclass
class ScanLayout:
    """The culled scan's table of a packed primitive table (`scan_layout`).
    Per section (spheres, quads, boxes): `order`, the declaration rows it
    scans in their order; `lo`, `hi` (nb, 3) and `pad` (nb,), the bounds
    of each block of SCAN_BLOCK of them and SCAN_PAD times their size
    (|centre|_1 + |half extent|_1); `row_lo`, `row_hi`, each scanned row's
    own box. `rot`: some box is rotated or offset (the kernels' box test
    then turns the ray per row; otherwise its reciprocals are hoisted).
    `table` (n_f4, 4) float32: per section the blocks' bounds {lo, pad}
    {hi, 0}, then the rows: sphere {c0, r^2} {cd, row}, quad {normal
    (zero: inactive), D} {alpha row, alpha0} {beta row, beta0}, box {lo,
    cos} {hi, sin} {offset, row}."""
    order: tuple
    lo: tuple
    hi: tuple
    pad: tuple
    row_lo: tuple
    row_hi: tuple
    rot: bool
    table: np.ndarray

    @property
    def counts(self):
        return tuple(len(o) for o in self.order)

    @property
    def stage_bytes(self):
        """The kernels' staged prefix of `table`, bytes (`stage_layout`)."""
        return min(self.table.shape[0], STAGE_BYTES // 16) * 16


def scan_layout(prims, st, sphere_order: str = "morton",
                box_order: str = "decl", pad: float = SCAN_PAD) -> ScanLayout:
    """The culled scan's table of `prims` (a packed table, numpy or a
    tensor) and its statics. The kernels take the defaults; "decl"
    spheres give the declaration-order scan (scripts/check_cull_host.py's
    reference), "morton" boxes sort the boxes as the spheres
    (scripts/sim_sphere_cull.py's comparison), and `pad` replaces SCAN_PAD
    (the host check's mutation)."""
    prims = np.ascontiguousarray(
        prims.detach().cpu().numpy() if isinstance(prims, torch.Tensor)
        else prims, np.float32)
    order, los, his, pads, rlo, rhi, parts = [], [], [], [], [], [], []
    rot = False
    for sec in range(3):
        rows, lo, hi, act = _row_bounds(prims, st, sec)
        keep = act if sec != 1 else np.ones_like(act)
        # (a section of one block keeps its declaration order)
        if act.sum() > SCAN_BLOCK and (
                (sec == 0 and sphere_order == "morton")
                or (sec == 2 and box_order == "morton")):
            if act.any():
                blo, bhi = lo[act].min(axis=0), hi[act].max(axis=0)
                ext = np.maximum(bhi - blo, np.float32(1e-6))
                key = np.where(act, _morton30(
                    np.float32(0.5) * (lo + hi), blo, ext), 1 << 30)
                perm = np.argsort(key, kind="stable")
            else:
                perm = np.arange(len(rows))
            perm = perm[keep[perm]]
        else:
            perm = np.nonzero(keep)[0]
        rows, lo, hi, act = rows[perm], lo[perm], hi[perm], act[perm]
        g = prims[rows]
        if sec == 2:
            rot = rot or bool(((g[:, 7] != 1.0) | (g[:, 8] != 0.0)
                               | (g[:, 9:12] != 0.0).any(axis=1)).any())
        nb = -(-len(rows) // SCAN_BLOCK)
        blo = np.zeros((nb, 3), np.float32)
        bhi = np.zeros((nb, 3), np.float32)
        for k in range(nb):
            s = slice(SCAN_BLOCK * k, SCAN_BLOCK * (k + 1))
            if act[s].any():
                blo[k] = lo[s][act[s]].min(axis=0)
                bhi[k] = hi[s][act[s]].max(axis=0)
        size = (np.abs(np.float32(0.5) * (blo + bhi)).sum(axis=1)
                + np.float32(0.5) * (bhi - blo).sum(axis=1))
        bpad = (np.float32(pad) * size).astype(np.float32)
        bnd = np.zeros((nb, 2, 4), np.float32)
        bnd[:, 0, :3], bnd[:, 0, 3], bnd[:, 1, :3] = blo, bpad, bhi
        rowid = rows.astype(np.float32)
        if sec == 0:
            f4 = np.stack([np.concatenate([g[:, 1:4], g[:, 8:9]], axis=1),
                           np.concatenate([g[:, 4:7], rowid[:, None]],
                                          axis=1)], axis=1)
        elif sec == 1:
            nrm = np.where(act[:, None], g[:, 1:4], 0.0)
            f4 = np.stack([np.concatenate([nrm, g[:, 4:5]], axis=1),
                           np.concatenate([g[:, 5:8], g[:, 11:12]], axis=1),
                           np.concatenate([g[:, 8:11], g[:, 12:13]], axis=1)],
                          axis=1)
        else:
            f4 = np.stack([np.concatenate([g[:, 1:4], g[:, 7:8]], axis=1),
                           np.concatenate([g[:, 4:7], g[:, 8:9]], axis=1),
                           np.concatenate([g[:, 9:12], rowid[:, None]],
                                          axis=1)], axis=1)
        parts += [bnd.reshape(-1, 4), f4.reshape(-1, 4)]
        order.append(rows)
        los.append(blo)
        his.append(bhi)
        pads.append(bpad)
        rlo.append(lo)
        rhi.append(hi)
    table = np.ascontiguousarray(np.concatenate(parts).astype(np.float32))
    if table.shape[0] == 0:
        table = np.zeros((1, 4), np.float32)
    return ScanLayout(tuple(order), tuple(los), tuple(his), tuple(pads),
                      tuple(rlo), tuple(rhi), rot, table)


def scan_tables(prims: torch.Tensor, st):
    """`scan_layout` of a packed table tensor and its `table` on the
    tensor's device, built once and kept on the tensor (rebuilt when the
    tensor is written in place)."""
    key = (prims._version, st["sph_base"], st["n_sph"], st["quad_base"],
           st["n_quad"], st["box_base"], st["n_box"])
    hit = getattr(prims, "_grt_scan", None)
    if hit is None or hit[0] != key:
        lay = scan_layout(prims, st)
        hit = (key, lay, torch.from_numpy(lay.table).to(prims.device))
        prims._grt_scan = hit
    return hit[1], hit[2]


class _Closest:
    """The closest hit so far of every lane: t, the normal slots, the row
    (-1: none) and the quad uv. A candidate takes its place when it is
    strictly nearer, or with `by_row` also when it is as near and of a
    lower declaration row (the rule that makes any scan order give the
    declaration-order scan's winner)."""

    def __init__(self, like, by_row: bool):
        self.t = torch.full_like(like, float("inf"))
        self.n = [torch.zeros_like(like) for _ in range(3)]
        self.row = torch.full_like(like, -1, dtype=torch.int64)
        self.uv = [torch.zeros_like(like), torch.zeros_like(like)]
        self.by_row = by_row

    def before(self, t, r: int):
        if not self.by_row:
            return t < self.t
        return (t < self.t) | ((t == self.t) & (self.row > r))

    def take(self, ok, t, n, r: int, uv=None):
        ok = ok & self.before(t, r)
        self.t = torch.where(ok, t, self.t)
        self.n = [torch.where(ok, a, b) for a, b in zip(n, self.n)]
        self.row = torch.where(ok, r, self.row)
        if uv is not None:
            self.uv = [torch.where(ok, a, b) for a, b in zip(uv, self.uv)]


def _sphere_cand(g, ray, tm, a_quad, inv_a, before):
    """A sphere row's test (objects.go:83-115): (ok, root, c - o), the
    normal slots carrying c - o until the winner's normal is resolved."""
    ox, oy, oz, dx, dy, dz = ray
    cx = g[1] + tm * g[4] - ox
    cy = g[2] + tm * g[5] - oy
    cz = g[3] + tm * g[6] - oz
    h = _dot3(dx, dy, dz, cx, cy, cz)
    c = _dot3(cx, cy, cz, cx, cy, cz) - g[8]
    disc = h * h - a_quad * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    r1 = (h - sq) * inv_a
    r2 = (h + sq) * inv_a
    root = torch.where((T_MIN < r1) & before(r1), r1, r2)
    ok = (g[0] >= 0.0) & (disc >= 0.0) & (T_MIN < root) & before(root)
    return ok, root, (cx, cy, cz)


def _quad_cand(g, ray, before):
    """A quad row's test (objects.go:167-206): (ok, t, normal, (alpha,
    beta))."""
    ox, oy, oz, dx, dy, dz = ray
    dn = _dot3(dx, dy, dz, g[1], g[2], g[3])
    on = _dot3(ox, oy, oz, g[1], g[2], g[3])
    t_q = (g[4] - on) / dn
    px = ox + t_q * dx
    py = oy + t_q * dy
    pz = oz + t_q * dz
    alpha = _dot3(px, py, pz, g[5], g[6], g[7]) - g[11]
    beta = _dot3(px, py, pz, g[8], g[9], g[10]) - g[12]
    ok = ((g[0] >= 0.0) & (torch.abs(dn) >= 1e-8)
          & (T_MIN <= t_q) & before(t_q)
          & (alpha >= 0.0) & (alpha <= 1.0)
          & (beta >= 0.0) & (beta <= 1.0))
    return ok, t_q, (g[1], g[2], g[3]), (alpha, beta)


def _box_cand(g, ray, inv_w, rot: bool, before):
    """A fused box row's slab test, rotate-Y + translate (transformation.go):
    (ok, t, normal). Without `rot` the ray is the object-space ray and its
    reciprocals `inv_w` are the world ray's, hoisted out of the loop."""
    ox, oy, oz, dx, dy, dz = ray
    if rot:
        cos, sin = g[7], g[8]
        osx = ox - g[9]
        oy_ = oy - g[10]
        osz = oz - g[11]
        bx_o = cos * osx - sin * osz
        bz_o = sin * osx + cos * osz
        by_o = oy_
        bdx = cos * dx - sin * dz
        bdz = sin * dx + cos * dz
        ix_, iy_, iz_ = (1.0 / _safe_d(bdx), 1.0 / _safe_d(dy),
                         1.0 / _safe_d(bdz))
    else:
        ix_, iy_, iz_ = inv_w
        bx_o, by_o, bz_o = ox, oy, oz
        bdx, bdz = dx, dz
    tx0 = (g[1] - bx_o) * ix_
    tx1 = (g[4] - bx_o) * ix_
    ty0 = (g[2] - by_o) * iy_
    ty1 = (g[5] - by_o) * iy_
    tz0 = (g[3] - bz_o) * iz_
    tz1 = (g[6] - bz_o) * iz_
    lx, hx = torch.minimum(tx0, tx1), torch.maximum(tx0, tx1)
    ly, hy = torch.minimum(ty0, ty1), torch.maximum(ty0, ty1)
    lz, hz = torch.minimum(tz0, tz1), torch.maximum(tz0, tz1)
    near = torch.maximum(torch.maximum(lx, ly), lz)
    far = torch.minimum(torch.minimum(hx, hy), hz)
    entry = near >= T_MIN
    t_c = torch.where(entry, near, far)
    ok = (g[0] >= 0.0) & (far > near) & (T_MIN <= t_c) & before(t_c)
    is_x = torch.where(entry, lx, hx) == t_c
    is_y = ~is_x & (torch.where(entry, ly, hy) == t_c)
    is_z = ~is_x & ~is_y
    flip = torch.where(entry, -1.0, 1.0)
    zero = torch.zeros_like(t_c)
    nx = torch.where(is_x, torch.where(bdx >= 0, flip, -flip), zero)
    ny = torch.where(is_y, torch.where(dy >= 0, flip, -flip), zero)
    nz = torch.where(is_z, torch.where(bdz >= 0, flip, -flip), zero)
    if rot:
        nx, nz = cos * nx + sin * nz, -sin * nx + cos * nz
    return ok, t_c, (nx, ny, nz)


def _row_test(sec, g, r, ray, tm, sph, inv_w, rot, win, uv: bool, go=None):
    """Row `r` (table row `g`, a list) of section `sec` against every lane
    (or the lanes `go`), taken where it wins."""
    before = lambda t: win.before(t, r)
    if sec == 0:
        ok, t, n = _sphere_cand(g, ray, tm, *sph, before)
        ab = None
    elif sec == 1:
        ok, t, n, ab = _quad_cand(g, ray, before)
        ab = ab if uv else None
    else:
        ok, t, n = _box_cand(g, ray, inv_w, rot, before)
        ab = None
    win.take(ok if go is None else ok & go, t, n, r, ab)


def _scan_ray_consts(ray):
    ox, oy, oz, dx, dy, dz = ray
    a_quad = _dot3(dx, dy, dz, dx, dy, dz)
    inv_w = (1.0 / _safe_d(dx), 1.0 / _safe_d(dy), 1.0 / _safe_d(dz))
    return (a_quad, 1.0 / a_quad), inv_w


def closest_ref(st, P, ox, oy, oz, dx, dy, dz, tm):
    """The closest hit over the sphere, quad and box sections, every row in
    declaration order, a row taking the winner's place when strictly
    nearer (the reference's `hittable_list`, camera.go:300). `P`: the
    packed table as a list of rows. Returns (t, the normal slots (c - o
    for a sphere), the row (-1: none), the winning quad's (alpha, beta))."""
    ray = (ox, oy, oz, dx, dy, dz)
    sph, inv_w = _scan_ray_consts(ray)
    win = _Closest(ox, by_row=False)
    for sec, (base, n) in enumerate(((st["sph_base"], st["n_sph"]),
                                     (st["quad_base"], st["n_quad"]),
                                     (st["box_base"], st["n_box"]))):
        for r in range(base, base + n):
            _row_test(sec, P[r], r, ray, tm, sph, inv_w, st["box_rot"], win,
                      st["has_image"])
    return win.t, win.n, win.row, win.uv


def block_hit_ref(lo, hi, pad, ray):
    """The cull's test of blocks (csrc/bounce_core.cuh `block_hit`) for
    every lane, as (nb, N) bool: the block's box grown by its `pad` plus
    SCAN_PAD |o|_1 met by the ray in (T_MIN, inf), its slabs from the
    rounded o / d (the interval's far end is the caller's, t_best)."""
    ox, oy, oz, dx, dy, dz = ray
    inv = [1.0 / _safe_d(v) for v in (dx, dy, dz)]
    oi = [o * i for o, i in zip((ox, oy, oz), inv)]
    po = SCAN_PAD * (torch.abs(ox) + torch.abs(oy) + torch.abs(oz))
    lo, hi = (torch.as_tensor(x, device=ox.device) for x in (lo, hi))
    p = torch.as_tensor(pad, device=ox.device)[:, None] + po[None]
    near = torch.full_like(p, -float("inf"))
    far = torch.full_like(p, float("inf"))
    for a in range(3):
        t0 = (lo[:, a:a + 1] - p) * inv[a][None] - oi[a][None]
        t1 = (hi[:, a:a + 1] + p) * inv[a][None] - oi[a][None]
        near = torch.maximum(near, torch.minimum(t0, t1))
        far = torch.minimum(far, torch.maximum(t0, t1))
    return near, far


# float operations of one test of the culled scan, counted from
# csrc/bounce_core.cuh (a fused multiply-add as two; compares, min and max
# left out): a block's bounds (6 fma, the pad's 7 adds), a sphere row (its
# c - o, h, c and discriminant, and on a non-negative one the root and its
# square root), a quad row (dn, on, t, the point, alpha and beta), a box
# row with its reciprocals hoisted (6 subtracts, 6 multiplies) and with the
# ray turned per row (the offset, the turn, 3 divisions)
SCAN_OPS = {"block": 19, "sphere": 25, "quad": 30, "box": 12, "box_rot": 33}


def scan_ops(layout: ScanLayout, stats) -> torch.Tensor:
    """Float operations per lane of the culled scan from the plain model's
    counts (`closest_culled_ref`'s `stats`) and SCAN_OPS: what a lane's
    tests cost, the work the culled bound counts."""
    row_ops = (SCAN_OPS["sphere"], SCAN_OPS["quad"],
               SCAN_OPS["box_rot" if layout.rot else "box"])
    return sum(SCAN_OPS["block"] * b.double() + r * w.double()
               for b, r, w in zip(stats["blocks"], row_ops, stats["rows"]))


def brute_ops(layout: ScanLayout) -> int:
    """Float operations of the brute-force scan of the same rows (every row
    of every section, SCAN_OPS)."""
    n_sph, n_quad, n_box = layout.counts
    return (n_sph * SCAN_OPS["sphere"] + n_quad * SCAN_OPS["quad"]
            + n_box * SCAN_OPS["box_rot" if layout.rot else "box"])


def closest_culled_ref(st, prims, ox, oy, oz, dx, dy, dz, tm, layout=None,
                       stats=None):
    """The CUDA kernels' culled scan as a plain model: `layout` (default
    `scan_layout(prims, st)`) walked section by section and block by block,
    a block of a section of more than one skipped on a lane whose ray
    cannot meet its padded bounds in (T_MIN, t_best] (unless the lane's
    largest direction component is below SCAN_MIN_D), a row taking the
    winner's place when nearer or as near and declared earlier. Returns
    what `closest_ref` returns; the tests hold the two equal. `stats` (a
    dict) receives per section the blocks whose bounds each lane tested
    and the rows it tested ("blocks", "rows": (N,) int64 each) and the
    (nb, N) bool of the blocks it scanned ("scanned")."""
    lay = layout if layout is not None else scan_layout(prims, st)
    P = (prims.tolist() if isinstance(prims, torch.Tensor)
         else np.asarray(prims).tolist())
    ray = (ox, oy, oz, dx, dy, dz)
    sph, inv_w = _scan_ray_consts(ray)
    win = _Closest(ox, by_row=True)
    no_cull = torch.maximum(torch.maximum(torch.abs(dx), torch.abs(dy)),
                            torch.abs(dz)) < SCAN_MIN_D
    blocks, rows, scanned = [], [], []
    for sec in range(3):
        blocks.append(torch.zeros_like(ox, dtype=torch.int64))
        rows.append(torch.zeros_like(ox, dtype=torch.int64))
        order = lay.order[sec]
        nb = lay.lo[sec].shape[0]
        cull = nb > 1
        if cull:
            near, far = block_hit_ref(lay.lo[sec], lay.hi[sec], lay.pad[sec],
                                      ray)
        seen = torch.zeros((nb,) + ox.shape, dtype=torch.bool,
                           device=ox.device)
        for k in range(nb):
            if cull:
                go = (torch.clamp(near[k], min=T_MIN)
                      <= torch.minimum(far[k], win.t)) | no_cull
                blocks[sec] += 1
            else:
                go = torch.ones_like(ox, dtype=torch.bool)
            seen[k] = go
            blk = order[SCAN_BLOCK * k:SCAN_BLOCK * (k + 1)]
            rows[sec] += go.to(torch.int64) * len(blk)
            for r in blk.tolist():
                _row_test(sec, P[r], r, ray, tm, sph, inv_w, lay.rot, win,
                          st["has_image"], go if cull else None)
        scanned.append(seen)
    if stats is not None:
        stats.update(blocks=blocks, rows=rows, scanned=scanned)
    return win.t, win.n, win.row, win.uv


def _bounce_core_ref(st, prims, lights, bg, ox, oy, oz, dx, dy, dz, alive, u,
                     tm=None, ext=None, med=None, images=None, probe=None):
    """One bounce of the supported subset (camera.go:293-331): closest hit
    over the sphere, quad and box sections, the external mesh hit folded
    in (`ext`, with st["ext_hit"]), the media (`med`, the `pack_scene`
    media table, with st["n_media"]), face-forward flip, the texture value
    (checker, perlin, marble, turbulent), emission or background, mixture
    light/cosine/isotropic sampling and its pdf, metal and dielectric
    scattering. Mirrors the JAX kernel's `_bounce_core` op for op; where
    JAX carries the winner's material columns through the scan, this
    carries the winner's row and gathers its columns once after it (the
    same values, bit for bit: the noise seed is a bit pattern). `u` holds
    N_U + n_media uniform planes; `tm` (ray time) is needed when the scene
    has spheres. With st["has_image"], `images` = the `pack_scene` image
    table (texels, wh) and a diffuse lane whose row has an image texture
    takes the texel at its uv as albedo (`_image_albedo`): its record is
    the JAX kernel's after `patch_image_weight_planes`. `probe` (a list,
    for the tests) receives each call's (N,) int64 flat texel index of
    those lanes, -1 elsewhere. Returns (vr, vg, vb, emit, cf, new origin
    xyz, new direction xyz, alive_out)."""
    P = prims.tolist()
    Lr = lights.tolist()
    lay = _mat_layout(st)
    if st["n_sph"] or st["n_media"]:
        a_quad = _dot3(dx, dy, dz, dx, dy, dz)
        inv_a = 1.0 / a_quad
    t_best, (n_hx, n_hy, n_hz), row, quad_uv = closest_ref(
        st, P, ox, oy, oz, dx, dy, dz, tm)

    # the winner's material columns (`lay`): the primitive row's, zero
    # where nothing was hit
    won = row >= 0
    rows = torch.clamp(row, min=0)
    mat = {name: torch.where(won, prims[rows, MAT_BASE + c], 0.0)
           for c, name in enumerate(lay)}
    if st["ext_hit"]:
        # the mesh hit wins only when strictly nearer; planes: t, the
        # un-flipped outward normal, with images the texture (u, v), then
        # the material columns (`lay`)
        okx = ext[0] < t_best
        t_best = torch.where(okx, ext[0], t_best)
        n_hx = torch.where(okx, ext[1], n_hx)
        n_hy = torch.where(okx, ext[2], n_hy)
        n_hz = torch.where(okx, ext[3], n_hz)
        k0 = 6 if st["has_image"] else 4
        if st["has_image"]:
            quad_uv = [torch.where(okx, ext[4 + k], quad_uv[k])
                       for k in range(2)]
        mat = {name: torch.where(okx, ext[k0 + c], mat[name])
               for c, name in enumerate(lay)}
        row = torch.where(okx, -1, row)
    win_med = torch.zeros_like(ox, dtype=torch.bool)
    if st["n_media"]:
        t_best, n_hx, n_hy, n_hz, med_idx = _media_update(
            st, med, (ox, oy, oz, dx, dy, dz, a_quad, inv_a), u,
            t_best, n_hx, n_hy, n_hz)
        win_med = med_idx >= 0
        mi = torch.clamp(med_idx, min=0)
        alb = {c: med[mi, 17 + k] for k, c in enumerate("rgb")}
        med_vals = {"kind": float(T.MAT_ISOTROPIC), "texk": float(T.TEX_SOLID),
                    **{p + c: alb[c] for p in ("ev_", "od_") for c in "rgb"}}
        mat = {name: torch.where(win_med, med_vals.get(name, 0.0), v)
               for name, v in mat.items()}
        row = torch.where(win_med, -1, row)

    m_kind = mat["kind"]
    hit = torch.isfinite(t_best)
    t_safe = torch.where(hit, t_best, 1.0)
    hx = ox + t_safe * dx
    hy = oy + t_safe * dy
    hz = oz + t_safe * dz
    if st["n_sph"]:
        sph_ok = (row >= 0) & (row < st["quad_base"]) & hit
        inv_r = 1.0 / torch.where(sph_ok, prims[rows, 7], 1.0)
        n_hx = torch.where(sph_ok, (t_safe * dx - n_hx) * inv_r, n_hx)
        n_hy = torch.where(sph_ok, (t_safe * dy - n_hy) * inv_r, n_hy)
        n_hz = torch.where(sph_ok, (t_safe * dz - n_hz) * inv_r, n_hz)
    out_n = (n_hx, n_hy, n_hz)    # pre-flip outward normal: the sphere uv
    # media force frontFace = true (medium.go:55)
    front = (_dot3(dx, dy, dz, n_hx, n_hy, n_hz) < 0.0) | win_med
    n_hx = torch.where(front, n_hx, -n_hx)
    n_hy = torch.where(front, n_hy, -n_hy)
    n_hz = torch.where(front, n_hz, -n_hz)
    tex_r, tex_g, tex_b = _texture_value(st, mat, hx, hy, hz, alive & hit)

    miss = alive & ~hit
    lit = alive & hit
    is_light = lit & (m_kind == float(T.MAT_DIFFUSE_LIGHT))
    is_metal = lit & (m_kind == float(T.MAT_METAL))
    is_diel = lit & (m_kind == float(T.MAT_DIELECTRIC))
    diffuse = lit & (m_kind == float(T.MAT_LAMBERTIAN))
    if st["has_isotropic"]:
        is_iso = lit & (m_kind == float(T.MAT_ISOTROPIC))
        diffuse = diffuse | is_iso
    if st["has_image"]:
        # a diffuse lane on an image row shades with the texel at its uv
        # (the albedo of an emitting or metal row stays its even colour)
        is_img = diffuse & (mat["texk"] == float(T.TEX_IMAGE))
        is_sph = (row >= 0) & (row < st["quad_base"])
        *texel, tex_idx = _image_albedo(images, is_img, mat["seed_img"],
                                        is_sph, out_n, quad_uv)
        tex_r, tex_g, tex_b = (torch.where(is_img, a, b) for a, b in
                               zip(texel, (tex_r, tex_g, tex_b)))
        if probe is not None:
            probe.append(tex_idx)
    e_on = is_light & front
    zero = torch.zeros_like(ox)
    er = torch.where(miss, bg[0], torch.where(e_on, tex_r, zero))
    eg = torch.where(miss, bg[1], torch.where(e_on, tex_g, zero))
    eb = torch.where(miss, bg[2], torch.where(e_on, tex_b, zero))

    # mixture sampling (pdf.go:58-74): light pick + per-kind sample
    n_lights, n_live = st["n_lights"], st["n_lights_live"]
    li = torch.clamp((u[4] * n_live).to(torch.int32), max=n_live - 1)
    ldx = torch.zeros_like(ox)
    ldy = torch.zeros_like(ox)
    ldz = torch.zeros_like(ox)
    for l in range(n_lights):
        g = Lr[l]
        sel = li == l
        if g[0] < 0.5:      # quad (objects.go:161-165)
            cand = (g[1] + u[5] * g[4] + u[6] * g[7] - hx,
                    g[2] + u[5] * g[5] + u[6] * g[8] - hy,
                    g[3] + u[5] * g[6] + u[6] * g[9] - hz)
        else:               # sphere cone sample (objects.go:63-80)
            tcx, tcy, tcz = g[1] - hx, g[2] - hy, g[3] - hz
            dist_sq = _dot3(tcx, tcy, tcz, tcx, tcy, tcz)
            ctm = torch.sqrt(torch.clamp(1.0 - g[4] * g[4] / dist_sq, min=0.0))
            zz = 1.0 + u[6] * (ctm - 1.0)
            phi = 2.0 * math.pi * u[5]
            st_ = torch.sqrt(torch.clamp(1.0 - zz * zz, min=0.0))
            cand = _onb_transform(tcx, tcy, tcz, torch.cos(phi) * st_,
                                  torch.sin(phi) * st_, zz)
        ldx = torch.where(sel, cand[0], ldx)
        ldy = torch.where(sel, cand[1], ldy)
        ldz = torch.where(sel, cand[2], ldz)

    # cosine about the shading normal (pdf.go:38-40)
    phi_m = 2.0 * math.pi * u[7]
    sq_m = torch.sqrt(u[8])
    cz_m = torch.sqrt(torch.clamp(1.0 - u[8], min=0.0))
    mdx, mdy, mdz = _onb_transform(n_hx, n_hy, n_hz, torch.cos(phi_m) * sq_m,
                                   torch.sin(phi_m) * sq_m, cz_m)
    if st["has_isotropic"]:
        # uniform sphere for isotropic scattering (pdf.go:15-23)
        z_i = 1.0 - 2.0 * u[7]
        r_i = torch.sqrt(torch.clamp(1.0 - z_i * z_i, min=0.0))
        phi_i = 2.0 * math.pi * u[8]
        mdx = torch.where(is_iso, r_i * torch.cos(phi_i), mdx)
        mdy = torch.where(is_iso, r_i * torch.sin(phi_i), mdy)
        mdz = torch.where(is_iso, z_i, mdz)
    use_light = u[3] < 0.5
    gdx = torch.where(use_light, ldx, mdx)
    gdy = torch.where(use_light, ldy, mdy)
    gdz = torch.where(use_light, ldz, mdz)

    # mixture pdf: mean of the live lights' pdfs (hittable.go:89-97)
    g_len_sq = _dot3(gdx, gdy, gdz, gdx, gdy, gdz)
    g_len = torch.sqrt(g_len_sq)
    l_pdf = torch.zeros_like(ox)
    for l in range(n_live):
        g = Lr[l]
        if g[0] >= 0.5:
            # sphere pdf (objects.go:52-62); NaN from inside is kept
            ocx, ocy, ocz = g[1] - hx, g[2] - hy, g[3] - hz
            hh = _dot3(gdx, gdy, gdz, ocx, ocy, ocz)
            dsq = _dot3(ocx, ocy, ocz, ocx, ocy, ocz)
            disc_l = hh * hh - g_len_sq * (dsq - g[4] * g[4])
            sql = torch.sqrt(torch.clamp(disc_l, min=0.0))
            r1l = (hh - sql) / g_len_sq
            r2l = (hh + sql) / g_len_sq
            rootl = torch.where(r1l > 1e-4, r1l, r2l)
            hit_s = (disc_l >= 0.0) & (rootl > 1e-4)
            ctm2 = torch.sqrt(1.0 - g[4] * g[4] / dsq)
            pdf_s = 1.0 / (2.0 * math.pi * (1.0 - ctm2))
            l_pdf = l_pdf + torch.where(hit_s, pdf_s, zero)
            continue
        # quad pdf (objects.go:152-160)
        dnl = _dot3(gdx, gdy, gdz, g[10], g[11], g[12])
        onl = _dot3(hx, hy, hz, g[10], g[11], g[12])
        t_l = (g[13] - onl) / dnl
        lpx = hx + t_l * gdx
        lpy = hy + t_l * gdy
        lpz = hz + t_l * gdz
        al = _dot3(lpx, lpy, lpz, g[14], g[15], g[16]) - g[20]
        be = _dot3(lpx, lpy, lpz, g[17], g[18], g[19]) - g[21]
        hit_q = ((torch.abs(dnl) >= 1e-8) & (t_l >= 1e-3)
                 & (al >= 0.0) & (al <= 1.0) & (be >= 0.0) & (be <= 1.0))
        pdf_q = t_l * t_l * g_len_sq * g_len / (torch.abs(dnl) * g[22])
        l_pdf = l_pdf + torch.where(hit_q, pdf_q, zero)
    l_pdf = l_pdf / float(n_live)

    ugx, ugy, ugz = _normalize3(gdx, gdy, gdz)
    cos_t = _dot3(ugx, ugy, ugz, n_hx, n_hy, n_hz)
    mat_pdf = torch.clamp(cos_t, min=0.0) * INV_PI
    if st["has_isotropic"]:
        mat_pdf = torch.where(is_iso, INV_4PI, mat_pdf)
    pdf_value = 0.5 * l_pdf + 0.5 * mat_pdf
    # a light sample below the surface (no scattering pdf) that misses the
    # light by a rounding at its edge makes both pdfs 0: its weight is 0,
    # where the reference's 0 / 0 is NaN (a pixel its PrintColor blacks out)
    zero_zero = (mat_pdf == 0.0) & (pdf_value == 0.0)
    ratio = torch.where(diffuse & ~zero_zero, mat_pdf, zero) \
        / torch.where(diffuse & ~zero_zero, pdf_value, 1.0)
    emit = miss | e_on
    vr = torch.where(emit, er, torch.where(diffuse, tex_r * ratio, zero))
    vg = torch.where(emit, eg, torch.where(diffuse, tex_g * ratio, zero))
    vb = torch.where(emit, eb, torch.where(diffuse, tex_b * ratio, zero))
    ndx, ndy, ndz = gdx, gdy, gdz
    if st["has_metal"]:
        # metal (materials.go:70-79): mirror direction plus fuzz * a
        # uniform unit vector
        m_fr = mat["fr"]
        dn_m = _dot3(dx, dy, dz, n_hx, n_hy, n_hz)
        rx, ry, rz = _normalize3(dx - 2.0 * dn_m * n_hx,
                                 dy - 2.0 * dn_m * n_hy,
                                 dz - 2.0 * dn_m * n_hz)
        zf = 1.0 - 2.0 * u[0]
        rf = torch.sqrt(torch.clamp(1.0 - zf * zf, min=0.0))
        phif = 2.0 * math.pi * u[1]
        rx = rx + m_fr * rf * torch.cos(phif)
        ry = ry + m_fr * rf * torch.sin(phif)
        rz = rz + m_fr * zf
        vr = torch.where(is_metal, tex_r, vr)
        vg = torch.where(is_metal, tex_g, vg)
        vb = torch.where(is_metal, tex_b, vb)
        ndx = torch.where(is_metal, rx, ndx)
        ndy = torch.where(is_metal, ry, ndy)
        ndz = torch.where(is_metal, rz, ndz)
    if st["has_dielectric"]:
        # dielectric (materials.go:94-130): Schlick reflectance against
        # u[2], total internal reflection tested on squares, refraction as
        # vec.go:141-146
        udx, udy, udz = _normalize3(dx, dy, dz)
        m_ridx = mat["fr"]
        ri = torch.where(front, 1.0 / m_ridx, m_ridx)
        cos_d = torch.clamp(-_dot3(udx, udy, udz, n_hx, n_hy, n_hz), max=1.0)
        r0 = (1.0 - m_ridx) / (1.0 + m_ridx)
        r0 = r0 * r0
        x = 1.0 - cos_d
        x2 = x * x
        schlick = r0 + (1.0 - r0) * (x * (x2 * x2))
        do_reflect = (ri * ri * (1.0 - cos_d * cos_d) > 1.0) | (schlick > u[2])
        dn_d = _dot3(udx, udy, udz, n_hx, n_hy, n_hz)
        rfx = udx - 2.0 * dn_d * n_hx
        rfy = udy - 2.0 * dn_d * n_hy
        rfz = udz - 2.0 * dn_d * n_hz
        ppx = ri * (udx + cos_d * n_hx)
        ppy = ri * (udy + cos_d * n_hy)
        ppz = ri * (udz + cos_d * n_hz)
        par = -torch.sqrt(torch.abs(1.0 - _dot3(ppx, ppy, ppz, ppx, ppy, ppz)))
        ddx = torch.where(do_reflect, rfx, ppx + par * n_hx)
        ddy = torch.where(do_reflect, rfy, ppy + par * n_hy)
        ddz = torch.where(do_reflect, rfz, ppz + par * n_hz)
        vr = torch.where(is_diel, 1.0, vr)
        vg = torch.where(is_diel, 1.0, vg)
        vb = torch.where(is_diel, 1.0, vb)
        ndx = torch.where(is_diel, ddx, ndx)
        ndy = torch.where(is_diel, ddy, ndy)
        ndz = torch.where(is_diel, ddz, ndz)
    dead = ~alive
    vr = torch.where(dead, zero, vr)
    vg = torch.where(dead, zero, vg)
    vb = torch.where(dead, zero, vb)
    cf = diffuse & alive
    return (vr, vg, vb, emit, cf,
            torch.where(lit, hx, ox), torch.where(lit, hy, oy),
            torch.where(lit, hz, oz), ndx, ndy, ndz,
            diffuse | is_metal | is_diel)


def _camera_rays_ref(cam, pi, pj, si, sj, u01, base: int, has_defocus: bool):
    """Camera ray generation (camera.go:256-270) for every lane, from PRNG
    slots base .. base + 3 (`u01(slot)`, a plane): the ray through pixel
    (pi, pj) at stratum (si, sj) jittered by slots 0-1, from the camera
    centre, or with defocus from the point of the defocus disk at radius
    sqrt(u2) and angle 2 pi u3 (the JAX kernel's polar map, not the
    reference's rejection sampler; slots 2-3 are drawn only then). `cam` =
    the `pack_camera` row as a list. Returns (origin xyz, direction xyz)
    planes."""
    recip = cam[18]
    off_x = (si + u01(base)) * recip - 0.5
    off_y = (sj + u01(base + 1)) * recip - 0.5
    px = pi + off_x
    py = pj + off_y
    sx = cam[0] + px * cam[3] + py * cam[6]
    sy = cam[1] + px * cam[4] + py * cam[7]
    sz = cam[2] + px * cam[5] + py * cam[8]
    if has_defocus:
        r_d = torch.sqrt(u01(base + 2))
        phi_d = (2.0 * math.pi) * u01(base + 3)
        da = r_d * torch.cos(phi_d)
        db = r_d * torch.sin(phi_d)
        cx = cam[9] + da * cam[12] + db * cam[15]
        cy = cam[10] + da * cam[13] + db * cam[16]
        cz = cam[11] + da * cam[14] + db * cam[17]
    else:
        cx = cam[9] + torch.zeros_like(sx)
        cy = cam[10] + torch.zeros_like(sx)
        cz = cam[11] + torch.zeros_like(sx)
    return cx, cy, cz, sx - cx, sy - cy, sz - cz


@dataclasses.dataclass
class FusedQOut:
    """Preallocated outputs of `bounce_fused_q`, so a caller can have the
    records written straight into its window buffers. `rec`: Vr, Vg, Vb
    (float32) and FL (int32), each (n_inner, N). `seg`, `take`, `base`:
    (n_inner,) int32 — lanes alive after each level's refill, lanes that
    started a path, and the queue cursor at the level's start (the item
    id of its first start). `cursor`: (1,) int32, the cursor after the
    last level. `state`: the nine state planes; they may be the input
    planes themselves (the update is per lane, read before write)."""

    rec: Sequence[torch.Tensor]
    seg: torch.Tensor
    take: torch.Tensor
    base: torch.Tensor
    cursor: torch.Tensor
    state: Sequence[torch.Tensor]

    @staticmethod
    def empty(n: int, n_inner: int, device) -> "FusedQOut":
        f = lambda shape, dt: torch.empty(shape, dtype=dt, device=device)
        return FusedQOut(
            rec=[f((n_inner, n), torch.float32) for _ in range(3)]
            + [f((n_inner, n), torch.int32)],
            seg=f((n_inner,), torch.int32), take=f((n_inner,), torch.int32),
            base=f((n_inner,), torch.int32), cursor=f((1,), torch.int32),
            state=[f((n,), torch.float32) for _ in range(7)]
            + [f((n,), torch.int32) for _ in range(2)])


def bounce_fused_q_ref(tables, statics, cam_row, bg, seed4, ox, oy, oz,
                       dx, dy, dz, time, alive_i32, depth, *, has_defocus,
                       max_depth, n_inner=1, width=0, sqrt_spp=0, npix=0,
                       out: Optional[FusedQOut] = None, probe=None):
    """Plain PyTorch version of `bounce_fused_q` (same arguments, same
    results): `n_inner` levels, each one global exclusive rank of the
    dead lanes in flat lane order, the refill, camera rays, one bounce,
    the records and the depth cap. `probe` (a list) receives each level's
    texel indices (`_bounce_core_ref`).

    FL bits: 0 firefly clamp, 1 emit, 2 started, and for a started lane
    bits 3.. its rank among the level's starts (so item = base + FL >> 3)."""
    prims, lights = tables[0], tables[1]
    st = statics
    n = ox.shape[0]
    dev = ox.device
    if out is None:
        out = FusedQOut.empty(n, n_inner, dev)
    seed4_l = [int(v) for v in seed4.tolist()]
    seed, refill_rem, cursor, item_end = seed4_l
    cam = cam_row.reshape(-1).tolist()
    bgl = bg.tolist()
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    alive = alive_i32 > 0
    tm = time
    slots = N_U_RAYGEN + N_U + st["n_media"]
    for j in range(n_inner):
        u01 = lambda k: _u01_dyn(lane, seed, j * slots + k)
        dead = ~alive
        rank = torch.cumsum(dead.to(torch.int64), 0) - dead.to(torch.int64)
        item = cursor + rank
        take = dead & (item < item_end) & (refill_rem > j)
        n_take = int(take.sum())
        out.base[j] = cursor
        out.take[j] = n_take
        pi, pj, si, sj = (c.to(torch.float32) for c in
                          _item_to_coords(item, npix, width, sqrt_spp))
        cx, cy, cz, rdx, rdy, rdz = _camera_rays_ref(
            cam, pi, pj, si, sj, u01, 0, has_defocus)
        ox = torch.where(take, cx, ox)
        oy = torch.where(take, cy, oy)
        oz = torch.where(take, cz, oz)
        dx = torch.where(take, rdx, dx)
        dy = torch.where(take, rdy, dy)
        dz = torch.where(take, rdz, dz)
        tm = torch.where(take, u01(4), tm)
        alive = alive | take
        depth = torch.where(take, torch.zeros_like(depth), depth)

        u = [u01(N_U_RAYGEN + k) for k in range(N_U + st["n_media"])]
        (vr, vg, vb, emit, cf, nox, noy, noz, ndx, ndy, ndz,
         alive_out) = _bounce_core_ref(st, prims, lights, bgl, ox, oy, oz,
                                       dx, dy, dz, alive, u, tm=tm,
                                       med=tables[2], images=tables[4:6],
                                       probe=probe)
        out.rec[0][j] = vr
        out.rec[1][j] = vg
        out.rec[2][j] = vb
        rank_bits = torch.where(take, (item - cursor) << 3,
                                torch.zeros_like(item))
        out.rec[3][j] = (cf.to(torch.int64) | (emit.to(torch.int64) << 1)
                         | (take.to(torch.int64) << 2) | rank_bits) \
            .to(torch.int32)
        out.seg[j] = int(alive.sum())
        cursor += n_take
        # depth cap (camera.go:293-296): a path gets max_depth + 1 levels
        alive_out = alive_out & (depth < max_depth)
        depth = torch.where(alive, depth + 1, depth)
        ox, oy, oz, dx, dy, dz = nox, noy, noz, ndx, ndy, ndz
        alive = alive_out
    out.cursor[0] = cursor
    for dst, src in zip(out.state, (ox, oy, oz, dx, dy, dz, tm,
                                    alive.to(torch.int32), depth)):
        dst.copy_(src)
    return (tuple(out.rec), None, out.seg, out.take) + tuple(out.state)


# ---------------------------------------------------------------------------
# the CUDA kernel (csrc/bounce_fused_q.cu)
# ---------------------------------------------------------------------------

# The table ints of every fused kernel's argument struct, in the order of
# FUSED_TABLE_FIELDS in csrc/fused_common.cuh.
# The image table's pointers come first (texels, wh), then the scan table
# (`scan_tables`), then the ints.
_FUSED_TABLE_PTRS = ("img", "img_wh", "scan")
_FUSED_TABLE_INTS = ("p_cols", "n_sph", "quad_base", "n_quad", "n_box",
                     "n_lights", "n_lights_live",
                     "fr_col", "n_media", "feat", "texk_col", "scale_col",
                     "seed_col", "defocus", "img_h", "img_w", "scan_rot")


def _fused_table_ints(statics, tables, has_defocus: bool) -> dict:
    """Values of `_FUSED_TABLE_INTS` and `_FUSED_TABLE_PTRS` for a scene's
    statics and tables and the camera's defocus; a column the layout lacks
    is -1, the image table of a scene without images null and 0 x 0. The
    section sizes are the scan table's (its rows of each section)."""
    st = statics
    prims = tables[0]
    lay = _mat_layout(st)
    col = lambda name: MAT_BASE + lay.index(name) if name in lay else -1
    img = dict(img=None, img_wh=None, img_h=0, img_w=0)
    if st["has_image"]:
        img = dict(img=tables[4].data_ptr(), img_wh=tables[5].data_ptr(),
                   img_h=tables[4].shape[1], img_w=tables[4].shape[2])
    scan, scan_t = scan_tables(prims, st)
    n_sph, n_quad, n_box = scan.counts
    return dict(**img, scan=scan_t.data_ptr(), scan_rot=int(scan.rot),
                p_cols=prims.shape[1], n_sph=n_sph,
                quad_base=st["quad_base"], n_quad=n_quad, n_box=n_box,
                n_lights=st["n_lights"],
                n_lights_live=st["n_lights_live"], fr_col=col("fr"),
                n_media=st["n_media"], feat=fused_features(st),
                texk_col=col("texk"), scale_col=col("scale"),
                seed_col=col("seed_img"), defocus=int(bool(has_defocus)))


def _fused_table_checks(tables, statics):
    """The (name, tensor, dtype, shape) checks of the tables a fused kernel
    reads: prims, lights, the media table, whose n_media rows it reads
    (raises here if it has fewer), and with images the image table."""
    med = tables[2]
    if med.dim() != 2 or med.shape[1] != M_COLS \
            or med.shape[0] < statics["n_media"]:
        raise ValueError(f"media table: shape {tuple(med.shape)}, expected "
                         f"at least ({statics['n_media']}, {M_COLS})")
    f32 = torch.float32
    checks = [("prims", tables[0], f32, None),
              ("lights", tables[1], f32, None), ("med", med, f32, None)]
    if statics["has_image"]:
        if len(tables) < 6 or tables[4].dim() != 4 or tables[4].shape[3] != 3:
            raise ValueError("a scene with images needs pack_scene's image "
                             "table (n_img, Hm, Wm, 3) and wh (n_img, 2)")
        checks += [("images", tables[4], f32, None),
                   ("images wh", tables[5], torch.int32,
                    (tables[4].shape[0], 2))]
    return checks


class _FusedQArgs(ctypes.Structure):
    """Mirror of `FusedQArgs` in csrc/bounce_fused_q.cu (field for field)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "prims", "lights", "med", "cam", "bg", "seed4",
        "ox_in", "oy_in", "oz_in", "dx_in", "dy_in", "dz_in", "tm_in",
        "alive_in", "depth_in",
        "ox", "oy", "oz", "dx", "dy", "dz", "tm", "alive", "depth",
        "vr", "vg", "vb", "fl", "seg", "take", "base", "cursor_out",
        "dead_cnt", "cur_buf", "lvl_base") + _FUSED_TABLE_PTRS] + [
            (name, ctypes.c_int) for name in (
            _FUSED_TABLE_INTS + ("n", "n_inner", "max_depth", "width",
                                 "sqrt_spp", "npix", "rec_levels"))]


def _check_cuda_args(tensors):
    for name, t, dt, shape in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor like the lanes")
        if t.dtype != dt:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {dt}")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _bounce_fused_q_cuda(tables, statics, cam_row, bg, seed4, state, *,
                         has_defocus, max_depth, n_inner, width, sqrt_spp,
                         npix, out: FusedQOut, lvl_base=None):
    """Launch K1, or with `lvl_base` (a (1,) int32 tensor) its direct entry
    point, which writes level j to row lvl_base[0] + j of the whole-window
    buffers `out.rec` (S, N)."""

    st = statics
    n = state[0].shape[0]
    if n % BLOCK:
        raise ValueError(f"lane count {n} is not a multiple of {BLOCK}")
    prims, lights = tables[0], tables[1]
    f32, i32 = torch.float32, torch.int32
    checks = _fused_table_checks(tables, st) + [
        ("cam_row", cam_row, f32, (1, 20)), ("bg", bg, f32, (3,)),
        ("seed4", seed4, i32, (4,))]
    names = ("ox", "oy", "oz", "dx", "dy", "dz", "time", "alive", "depth")
    for k, (nm, t) in enumerate(zip(names, state)):
        checks.append((nm, t, f32 if k < 7 else i32, (n,)))
    for k, (nm, t) in enumerate(zip(names, out.state)):
        checks.append((nm + "_out", t, f32 if k < 7 else i32, (n,)))
    rec_levels = out.rec[0].shape[0] if lvl_base is not None else n_inner
    for k, t in enumerate(out.rec):
        checks.append((f"rec{k}", t, f32 if k < 3 else i32,
                       (rec_levels, n)))
    for nm in ("seg", "take", "base"):
        checks.append((nm, getattr(out, nm), i32, (n_inner,)))
    checks.append(("cursor", out.cursor, i32, (1,)))
    if lvl_base is not None:
        checks.append(("base", lvl_base, i32, (1,)))
    _check_cuda_args(checks)

    scratch = torch.empty(2 * (n // BLOCK) + 2, dtype=i32,
                          device=prims.device)
    p = lambda t: t.data_ptr()
    a = _FusedQArgs(
        prims=p(prims), lights=p(lights), med=p(tables[2]), cam=p(cam_row),
        bg=p(bg), seed4=p(seed4),
        **{k + "_in": p(t) for k, t in zip(
            ("ox", "oy", "oz", "dx", "dy", "dz", "tm", "alive", "depth"),
            state)},
        **{k: p(t) for k, t in zip(
            ("ox", "oy", "oz", "dx", "dy", "dz", "tm", "alive", "depth"),
            out.state)},
        vr=p(out.rec[0]), vg=p(out.rec[1]), vb=p(out.rec[2]),
        fl=p(out.rec[3]), seg=p(out.seg), take=p(out.take),
        base=p(out.base), cursor_out=p(out.cursor),
        dead_cnt=p(scratch), cur_buf=p(scratch) + 4 * 2 * (n // BLOCK),
        lvl_base=None if lvl_base is None else p(lvl_base),
        rec_levels=rec_levels, **_fused_table_ints(st, tables, has_defocus),
        n=n,
        n_inner=n_inner, max_depth=max_depth, width=width,
        sqrt_spp=sqrt_spp, npix=npix)
    lib = _cuda.library("bounce_fused_q")
    entry = lib.grt_bounce_fused_q if lvl_base is None \
        else lib.grt_bounce_fused_q_direct
    err = entry(ctypes.addressof(a),
                torch.cuda.current_stream(prims.device).cuda_stream)
    if err:
        raise RuntimeError(f"bounce_fused_q launch failed: {_cuda.error_string(err)}")
    if lvl_base is None:
        _cuda.count(globals(), "launches")
    else:
        _cuda.count(globals(), "launches_direct")


def bounce_fused_q(tables, statics, cam_row, bg, seed4, ox, oy, oz, dx, dy,
                   dz, time, alive_i32, depth, *, has_defocus, max_depth,
                   n_inner=1, width=0, sqrt_spp=0, npix=0,
                   out: Optional[FusedQOut] = None):
    """`n_inner` in-kernel-queue bounce levels (the JAX package's
    `bounce_fused_q`). tables = (prims, lights, media, blk) tensors from
    `pack_scene`; seed4 = int32 [step seed, refill levels remaining, queue
    cursor, item_end] on the lanes' device. Returns (rec_planes, None,
    seg_counts, take_counts, ox, oy, oz, dx, dy, dz, time, alive_i32,
    depth); `out` (optional) receives every output, plus the per-level
    bases and the final cursor.

    CUDA tensors launch the kernel; CPU tensors run `bounce_fused_q_ref`.
    The kernel leaves a dead lane's direction as it was, where the plain
    version (like the JAX kernel) writes a don't-care sampled direction."""
    if not supported_statics(statics):
        raise NotImplementedError(
            "scene outside this kernel's subset (see supported())")
    state = (ox, oy, oz, dx, dy, dz, time, alive_i32, depth)
    if not ox.is_cuda:
        return bounce_fused_q_ref(
            tables, statics, cam_row, bg, seed4, *state,
            has_defocus=has_defocus, max_depth=max_depth, n_inner=n_inner,
            width=width, sqrt_spp=sqrt_spp, npix=npix, out=out)
    if out is None:
        out = FusedQOut.empty(ox.shape[0], n_inner, ox.device)
    _bounce_fused_q_cuda(tables, statics, cam_row, bg, seed4, state,
                         has_defocus=has_defocus, max_depth=max_depth,
                         n_inner=n_inner, width=width, sqrt_spp=sqrt_spp,
                         npix=npix, out=out)
    return (tuple(out.rec), None, out.seg, out.take) + tuple(out.state)


def _check_direct(statics):
    if not supported_statics(statics):
        raise NotImplementedError(
            "scene outside this kernel's subset (see supported())")
    if statics["has_image"]:
        raise NotImplementedError(
            "bounce_fused_q_direct: the direct-record path excludes scenes "
            "with image textures, as in the JAX package")


def bounce_fused_q_direct_ref(tables, statics, cam_row, bg, seed4, base,
                              rec_bufs, ox, oy, oz, dx, dy, dz, time,
                              alive_i32, depth, *, has_defocus, max_depth,
                              n_inner=1, width=0, sqrt_spp=0, npix=0,
                              out: Optional[FusedQOut] = None):
    """Plain PyTorch version of `bounce_fused_q_direct` (same arguments,
    same results): `bounce_fused_q_ref`, its records copied to rows
    base[0] .. base[0] + n_inner - 1 of the buffers (the rows that
    exist)."""
    _check_direct(statics)
    n = ox.shape[0]
    if out is None:
        out = FusedQOut.empty(n, n_inner, ox.device)
    else:
        out = dataclasses.replace(out, rec=[
            torch.empty((n_inner, n), dtype=r.dtype, device=r.device)
            for r in rec_bufs])
    bounce_fused_q_ref(tables, statics, cam_row, bg, seed4, ox, oy, oz, dx,
                       dy, dz, time, alive_i32, depth,
                       has_defocus=has_defocus, max_depth=max_depth,
                       n_inner=n_inner, width=width, sqrt_spp=sqrt_spp,
                       npix=npix, out=out)
    b = int(base.reshape(-1)[0])
    lo, hi = max(b, 0), min(b + n_inner, rec_bufs[0].shape[0])
    for buf, r in zip(rec_bufs, out.rec):
        if hi > lo:
            buf[lo:hi] = r[lo - b:hi - b]
    return tuple(rec_bufs) + (out.seg, out.take) + tuple(out.state)


def bounce_fused_q_direct(tables, statics, cam_row, bg, seed4, base,
                          rec_bufs, ox, oy, oz, dx, dy, dz, time, alive_i32,
                          depth, *, has_defocus, max_depth, n_inner=1,
                          width=0, sqrt_spp=0, npix=0,
                          out: Optional[FusedQOut] = None):
    """`bounce_fused_q` writing its records in place (the JAX package's
    `bounce_fused_q_direct`): `rec_bufs` = (Vr, Vg, Vb, FL) whole-window
    buffers (S, N); level j lands at row base[0] + j, `base` a (1,) int32
    tensor on the lanes' device, and every other row keeps its contents.
    Returns (Vr, Vg, Vb, FL, seg_counts, take_counts, ox, oy, oz, dx, dy,
    dz, time, alive_i32, depth); `out` (optional, its `rec` unused)
    receives the counts, bases, cursor and state as for `bounce_fused_q`.

    CUDA tensors launch the kernel's direct entry point; CPU tensors run
    `bounce_fused_q_direct_ref`. A scene with image textures raises, as
    the JAX package's direct-record path excludes them."""
    _check_direct(statics)
    if len(rec_bufs) != 4 or any(r.shape != rec_bufs[0].shape
                                 or r.dim() != 2 for r in rec_bufs):
        raise ValueError("rec_bufs must be four (S, N) buffers")
    if base.numel() != 1:
        raise ValueError("base must hold one level index")
    state = (ox, oy, oz, dx, dy, dz, time, alive_i32, depth)
    kw = dict(has_defocus=has_defocus, max_depth=max_depth, n_inner=n_inner,
              width=width, sqrt_spp=sqrt_spp, npix=npix)
    if not ox.is_cuda:
        return bounce_fused_q_direct_ref(tables, statics, cam_row, bg, seed4,
                                         base, rec_bufs, *state, out=out,
                                         **kw)
    if out is None:
        out = FusedQOut.empty(ox.shape[0], n_inner, ox.device)
    out = dataclasses.replace(out, rec=list(rec_bufs))
    _bounce_fused_q_cuda(tables, statics, cam_row, bg, seed4, state,
                         out=out, lvl_base=base, **kw)
    return tuple(rec_bufs) + (out.seg, out.take) + tuple(out.state)


# ---------------------------------------------------------------------------
# the `queue` and `positional` schedules' kernels: the refill comes from the
# caller (bounce_fused) or from per-lane pointer planes (bounce_fused_pos)
# ---------------------------------------------------------------------------

STATE_NAMES = ("ox", "oy", "oz", "dx", "dy", "dz", "tm", "alive", "depth")
POS_NAMES = ("pi", "pj", "si", "sj", "rem")


@dataclasses.dataclass
class FusedOut:
    """Preallocated outputs of `bounce_fused` and `bounce_fused_pos`, so a
    caller can have the records written straight into its window buffers.
    `rec`: the record planes, each (n_inner, N) — Vr, Vg, Vb (float32) and
    FL (int32) for `bounce_fused`; Er, Eg, Eb, Wr, Wg, Wb (float32), CF and
    ST (int32) for `bounce_fused_pos`. `seg`: (n_inner,) int32, the lanes
    alive at each level's bounce. `state`: the nine state planes, plus
    pi, pj, si, sj, rem (float32) for `bounce_fused_pos`; they may be the
    input planes themselves (the update is per lane, read before write)."""

    rec: Sequence[torch.Tensor]
    seg: torch.Tensor
    state: Sequence[torch.Tensor]

    @staticmethod
    def empty(n: int, n_inner: int, device, positional=False) -> "FusedOut":
        f = lambda shape, dt: torch.empty(shape, dtype=dt, device=device)
        n_f, n_i = (6, 2) if positional else (3, 1)
        return FusedOut(
            rec=[f((n_inner, n), torch.float32) for _ in range(n_f)]
            + [f((n_inner, n), torch.int32) for _ in range(n_i)],
            seg=f((n_inner,), torch.int32),
            state=[f((n,), torch.float32) for _ in range(7)]
            + [f((n,), torch.int32) for _ in range(2)]
            + [f((n,), torch.float32) for _ in range(5 if positional else 0)])


def _check_fused(statics):
    if not supported_statics(statics):
        raise NotImplementedError(
            "scene outside this kernel's subset (see supported())")


def _finish_fused(out, seg_counts, state):
    for j, c in enumerate(seg_counts):
        out.seg[j] = c
    for dst, src in zip(out.state, state):
        dst.copy_(src)
    return (tuple(out.rec), None, out.seg) + tuple(out.state)


def bounce_fused_ref(tables, statics, cam_row, bg, seed, ox, oy, oz, dx, dy,
                     dz, time, alive_i32, depth, take_i32, pi, pj, si, sj, *,
                     has_defocus, max_depth, n_inner=1,
                     out: Optional[FusedOut] = None, probe=None):
    """Plain PyTorch version of `bounce_fused` (same arguments, same
    results), op for op as the JAX kernel: the camera rays blended into
    the taken lanes from PRNG slots 0-4, then per level j one bounce from
    slots 5 + k j .. (k = N_U + n_media uniforms per level: the last
    n_media feed the media), the merged V/FL records, the alive count and
    the depth cap. `probe`: as `bounce_fused_q_ref`'s."""
    _check_fused(statics)
    prims, lights = tables[0], tables[1]
    n = ox.shape[0]
    if out is None:
        out = FusedOut.empty(n, n_inner, ox.device)
    seed = int(seed)
    cam = cam_row.reshape(-1).tolist()
    bgl = bg.tolist()
    lane = torch.arange(n, dtype=torch.int64, device=ox.device)
    u01 = lambda slot: _u01(lane, seed, slot)
    take = take_i32 > 0
    cx, cy, cz, rdx, rdy, rdz = _camera_rays_ref(
        cam, pi, pj, si, sj, u01, 0, has_defocus)
    ox = torch.where(take, cx, ox)
    oy = torch.where(take, cy, oy)
    oz = torch.where(take, cz, oz)
    dx = torch.where(take, rdx, dx)
    dy = torch.where(take, rdy, dy)
    dz = torch.where(take, rdz, dz)
    tm = torch.where(take, u01(4), time)
    alive = (alive_i32 > 0) | take
    depth = torch.where(take, torch.zeros_like(depth), depth)
    n_u = N_U + statics["n_media"]
    segs = []
    for j in range(n_inner):
        u = [u01(N_U_RAYGEN + j * n_u + k) for k in range(n_u)]
        (vr, vg, vb, emit, cf, nox, noy, noz, ndx, ndy, ndz,
         alive_out) = _bounce_core_ref(statics, prims, lights, bgl, ox, oy,
                                       oz, dx, dy, dz, alive, u, tm=tm,
                                       med=tables[2], images=tables[4:6],
                                       probe=probe)
        out.rec[0][j] = vr
        out.rec[1][j] = vg
        out.rec[2][j] = vb
        out.rec[3][j] = cf.to(torch.int32) | (emit.to(torch.int32) << 1)
        segs.append(alive.sum())
        # depth cap (camera.go:293-296): a path gets max_depth + 1 levels
        alive_out = alive_out & (depth < max_depth)
        depth = torch.where(alive, depth + 1, depth)
        ox, oy, oz, dx, dy, dz = nox, noy, noz, ndx, ndy, ndz
        alive = alive_out
    return _finish_fused(out, segs, (ox, oy, oz, dx, dy, dz, tm,
                                     alive.to(torch.int32), depth))


def bounce_fused_pos_ref(tables, statics, cam_row, bg, seed2, ox, oy, oz, dx,
                         dy, dz, time, alive_i32, depth, pi, pj, si, sj, rem,
                         *, has_defocus, max_depth, n_inner=1, width=0,
                         sqrt_spp=0, out: Optional[FusedOut] = None,
                         probe=None):
    """Plain PyTorch version of `bounce_fused_pos` (same arguments, same
    results), op for op as the JAX kernel. Per level j < seed2[1], a dead
    lane with rem > 0.5 starts its next item: the started flag is recorded,
    the camera ray comes from PRNG slots k j .. k j + 4 (k = N_U_RAYGEN +
    N_U + n_media slots per level), and the item pointer advances by carry
    selects (sj, then si, then pi, then pj) that keep the planes exact
    integers; then one bounce from slots k j + 5 .., the unmerged E / W /
    clamp records, the alive count and the depth cap. `probe`: as
    `bounce_fused_q_ref`'s."""
    _check_fused(statics)
    prims, lights = tables[0], tables[1]
    n = ox.shape[0]
    if out is None:
        out = FusedOut.empty(n, n_inner, ox.device, positional=True)
    seed, refill_rem = (int(v) for v in seed2.tolist())
    cam = cam_row.reshape(-1).tolist()
    bgl = bg.tolist()
    lane = torch.arange(n, dtype=torch.int64, device=ox.device)
    u01 = lambda slot: _u01(lane, seed, slot)
    alive = alive_i32 > 0
    tm = time
    n_u = N_U + statics["n_media"]
    zero = torch.zeros_like(ox)
    one = torch.ones_like(ox)
    segs = []
    for j in range(n_inner):
        base = j * (N_U_RAYGEN + n_u)
        take = ~alive & (rem > 0.5) if refill_rem > j \
            else torch.zeros_like(alive)
        out.rec[7][j] = take.to(torch.int32)
        cx, cy, cz, rdx, rdy, rdz = _camera_rays_ref(
            cam, pi, pj, si, sj, u01, base, has_defocus)
        ox = torch.where(take, cx, ox)
        oy = torch.where(take, cy, oy)
        oz = torch.where(take, cz, oz)
        dx = torch.where(take, rdx, dx)
        dy = torch.where(take, rdy, dy)
        dz = torch.where(take, rdz, dz)
        tm = torch.where(take, u01(base + 4), tm)
        alive = alive | take
        depth = torch.where(take, torch.zeros_like(depth), depth)

        # advance the item pointer (pixel-major: sj fastest, then si, then
        # the pixel column pi, then the pixel row pj), exact float carries
        sj_n = sj + 1.0
        wrap_s = sj_n > (sqrt_spp - 0.5)
        sj_n = torch.where(wrap_s, zero, sj_n)
        si_n = si + torch.where(wrap_s, one, zero)
        wrap_i = si_n > (sqrt_spp - 0.5)
        si_n = torch.where(wrap_i, zero, si_n)
        adv_p = wrap_s & wrap_i
        pi_n = pi + torch.where(adv_p, one, zero)
        wrap_p = pi_n > (width - 0.5)
        pi_n = torch.where(wrap_p, zero, pi_n)
        pj_n = pj + torch.where(wrap_p, one, zero)
        pi = torch.where(take, pi_n, pi)
        pj = torch.where(take, pj_n, pj)
        si = torch.where(take, si_n, si)
        sj = torch.where(take, sj_n, sj)
        rem = rem - take.to(torch.float32)

        u = [u01(base + N_U_RAYGEN + k) for k in range(n_u)]
        (vr, vg, vb, emit, cf, nox, noy, noz, ndx, ndy, ndz,
         alive_out) = _bounce_core_ref(statics, prims, lights, bgl, ox, oy,
                                       oz, dx, dy, dz, alive, u, tm=tm,
                                       med=tables[2], images=tables[4:6],
                                       probe=probe)
        for c, v in enumerate((vr, vg, vb)):
            out.rec[c][j] = torch.where(emit, v, zero)
            out.rec[3 + c][j] = torch.where(emit, zero, v)
        out.rec[6][j] = cf.to(torch.int32)
        segs.append(alive.sum())
        # depth cap (camera.go:293-296)
        alive_out = alive_out & (depth < max_depth)
        depth = torch.where(alive, depth + 1, depth)
        ox, oy, oz, dx, dy, dz = nox, noy, noz, ndx, ndy, ndz
        alive = alive_out
    return _finish_fused(out, segs, (ox, oy, oz, dx, dy, dz, tm,
                                     alive.to(torch.int32), depth,
                                     pi, pj, si, sj, rem))


def _args_struct(name, pointers, ints):
    """A ctypes mirror of a kernel's argument struct: pointers, then ints."""
    return type(name, (ctypes.Structure,), {"_fields_": [
        (p, ctypes.c_void_p) for p in pointers] + [
        (i, ctypes.c_int) for i in ints]})


# Mirror of `FusedArgs` in csrc/bounce_fused.cu (field for field).
_FusedArgs = _args_struct(
    "_FusedArgs",
    ("prims", "lights", "med", "cam", "bg", "seed")
    + tuple(k + "_in" for k in STATE_NAMES) + ("take",) + POS_NAMES[:4]
    + STATE_NAMES + ("vr", "vg", "vb", "fl", "seg") + _FUSED_TABLE_PTRS,
    _FUSED_TABLE_INTS + ("n", "n_inner", "max_depth"))

# Mirror of `FusedPosArgs` in csrc/bounce_fused_pos.cu (field for field).
_FusedPosArgs = _args_struct(
    "_FusedPosArgs",
    ("prims", "lights", "med", "cam", "bg", "seed2")
    + tuple(k + "_in" for k in STATE_NAMES + POS_NAMES)
    + STATE_NAMES + POS_NAMES
    + ("er", "eg", "eb", "wr", "wg", "wb", "cf", "st", "seg")
    + _FUSED_TABLE_PTRS,
    _FUSED_TABLE_INTS + ("n", "n_inner", "max_depth", "width", "sqrt_spp"))


def _launch_fused(lib, struct, tables, statics, cam_row, bg, seed_field, seed,
                  state, extra_in, rec_names, out: FusedOut, n_inner,
                  has_defocus, ints):
    """Check every tensor, fill `struct` and launch the entry point of
    library `lib`. `seed_field`: the struct's name of the seed tensor
    ("seed", one int, or "seed2", two); `state`: the input state planes
    (nine, or fourteen with the pointer planes); `extra_in`: further
    (name, tensor, dtype) inputs; `rec_names`: the struct's names of the
    record planes; `ints`: the struct's ints beyond the common ones."""

    st = statics
    n = state[0].shape[0]
    if n % BLOCK:
        raise ValueError(f"lane count {n} is not a multiple of {BLOCK}")
    prims, lights = tables[0], tables[1]
    f32, i32 = torch.float32, torch.int32
    names = (STATE_NAMES + POS_NAMES)[:len(state)]
    dtypes = [i32 if k in ("alive", "depth") else f32 for k in names]
    if len(out.state) != len(state) or len(out.rec) != len(rec_names):
        raise ValueError("out: wrong number of state or record planes")
    checks = _fused_table_checks(tables, st) + [
        ("cam_row", cam_row, f32, (1, 20)), ("bg", bg, f32, (3,)),
        (seed_field, seed, i32, (2 if seed_field == "seed2" else 1,)),
        ("seg", out.seg, i32, (n_inner,))]
    checks += [(nm, t, dt, (n,)) for nm, t, dt in zip(names, state, dtypes)]
    checks += [(nm + "_out", t, dt, (n,))
               for nm, t, dt in zip(names, out.state, dtypes)]
    checks += [(nm, t, dt, (n,)) for nm, t, dt in extra_in]
    checks += [(nm, t, i32 if nm in ("fl", "cf", "st") else f32, (n_inner, n))
               for nm, t in zip(rec_names, out.rec)]
    _check_cuda_args(checks)
    p = lambda t: t.data_ptr()
    a = struct(
        prims=p(prims), lights=p(lights), med=p(tables[2]), cam=p(cam_row),
        bg=p(bg), **{seed_field: p(seed)},
        **{k + "_in": p(t) for k, t in zip(names, state)},
        **{k: p(t) for k, t in zip(names, out.state)},
        **{nm: p(t) for nm, t, _ in extra_in},
        **{nm: p(t) for nm, t in zip(rec_names, out.rec)}, seg=p(out.seg),
        **_fused_table_ints(st, tables, has_defocus), n=n, n_inner=n_inner,
        **ints)
    err = getattr(_cuda.library(lib), _cuda.ENTRY[lib])(
        ctypes.addressof(a),
        torch.cuda.current_stream(prims.device).cuda_stream)
    if err:
        raise RuntimeError(f"{lib} launch failed: {_cuda.error_string(err)}")


def bounce_fused(tables, statics, cam_row, bg, seed, ox, oy, oz, dx, dy, dz,
                 time, alive_i32, depth, take_i32, pi, pj, si, sj, *,
                 has_defocus, max_depth, n_inner=1,
                 out: Optional[FusedOut] = None):
    """`n_inner` bounce levels of the `queue` schedule in one kernel call,
    the refill at the first level only (the JAX package's `bounce_fused`).

    tables = (prims, lights, media, blk) tensors from `pack_scene`; seed: a
    (1,) int32 tensor on the lanes' device; the nine state planes; and the
    refill the caller computed: `take_i32` (int32, > 0 where a lane starts
    a path) and its pixel column, pixel row, stratum row and stratum column
    `pi, pj, si, sj` (float32). Returns (rec_planes, None, seg_counts, ox,
    oy, oz, dx, dy, dz, time, alive_i32, depth): rec_planes = (Vr, Vg, Vb,
    FL), each (n_inner, N) — the merged emission-or-weight planes and the
    flag bits (bit0 firefly clamp, bit1 emit); seg_counts (n_inner,) int32.
    `out` (optional) receives every output.

    CUDA tensors launch the kernel; CPU tensors run `bounce_fused_ref`.
    The kernel leaves a dead lane's direction as it was, where the plain
    version (like the JAX kernel) writes a don't-care sampled direction."""
    state = (ox, oy, oz, dx, dy, dz, time, alive_i32, depth)
    refill = (take_i32, pi, pj, si, sj)
    if not ox.is_cuda:
        return bounce_fused_ref(
            tables, statics, cam_row, bg, seed, *state, *refill,
            has_defocus=has_defocus, max_depth=max_depth, n_inner=n_inner,
            out=out)
    _check_fused(statics)
    if out is None:
        out = FusedOut.empty(ox.shape[0], n_inner, ox.device)
    extra = [("take", take_i32, torch.int32)] + [
        (nm, t, torch.float32) for nm, t in zip(POS_NAMES, refill[1:])]
    _launch_fused("bounce_fused", _FusedArgs, tables, statics, cam_row, bg,
                  "seed", seed, state, extra, ("vr", "vg", "vb", "fl"), out,
                  n_inner, has_defocus, dict(max_depth=max_depth))
    _cuda.count(globals(), "launches_fused")
    return (tuple(out.rec), None, out.seg) + tuple(out.state)


def bounce_fused_pos(tables, statics, cam_row, bg, seed2, ox, oy, oz, dx, dy,
                     dz, time, alive_i32, depth, pi, pj, si, sj, rem, *,
                     has_defocus, max_depth, n_inner=1, width=0, sqrt_spp=0,
                     out: Optional[FusedOut] = None):
    """`n_inner` bounce levels of the `positional` schedule in one kernel
    call, with the per-lane refill at every level (the JAX package's
    `bounce_fused_pos`).

    seed2: (2,) int32 on the lanes' device, [seed, refill levels
    remaining]; the nine state planes; and each lane's next-item pointer
    `pi, pj, si, sj` with its remaining item count `rem`, float32 planes
    holding exact small integers. Returns (rec_planes, None, seg_counts,
    the fourteen new state planes): rec_planes = (Er, Eg, Eb, Wr, Wg, Wb,
    CF, ST), each (n_inner, N) — emission and weight apart, the clamp flag
    and the started flag (int32). `out` (optional) receives every output.

    CUDA tensors launch the kernel; CPU tensors run
    `bounce_fused_pos_ref`. The kernel leaves a dead lane's direction as
    it was, where the plain version writes a don't-care direction."""
    state = (ox, oy, oz, dx, dy, dz, time, alive_i32, depth,
             pi, pj, si, sj, rem)
    if not ox.is_cuda:
        return bounce_fused_pos_ref(
            tables, statics, cam_row, bg, seed2, *state,
            has_defocus=has_defocus, max_depth=max_depth, n_inner=n_inner,
            width=width, sqrt_spp=sqrt_spp, out=out)
    _check_fused(statics)
    if out is None:
        out = FusedOut.empty(ox.shape[0], n_inner, ox.device, positional=True)
    _launch_fused("bounce_fused_pos", _FusedPosArgs, tables, statics, cam_row,
                  bg, "seed2", seed2, state, [],
                  ("er", "eg", "eb", "wr", "wg", "wb", "cf", "st"), out,
                  n_inner, has_defocus, dict(max_depth=max_depth, width=width,
                                             sqrt_spp=sqrt_spp))
    _cuda.count(globals(), "launches_fused_pos")
    return (tuple(out.rec), None, out.seg) + tuple(out.state)


# ---------------------------------------------------------------------------
# the mesh path's bounce: uniforms and the mesh hit come from the caller
# ---------------------------------------------------------------------------

def tri_mat_table(scene: T.Scene, statics) -> np.ndarray:
    """(len(_mat_layout), T) float32: every triangle's joined material
    columns, one row per column, so the per-lane join of
    `ext_planes_from_hit` is one gather that yields contiguous planes."""
    lay = _mat_layout(statics)
    return np.stack(join_mat_cols(scene, lay, scene.triangles.mat_id)) \
        .astype(np.float32)


class MeshHit(NamedTuple):
    """The mesh walk's winner of every lane as `ops/trace.mesh_closest`
    returns it: t (N,) float32, and idx (N,) int32, the triangle, -1 where
    no triangle beats the lane's cap. `bounce`'s ext mode takes it."""
    t: torch.Tensor
    idx: torch.Tensor


# Columns of a triangle's row in `tri_rows` (csrc/bounce.cu): v0, e0, e1,
# the three vertex normals, the face normal, has_vn, has_uv, the three
# vertex uv, then from TRI_MAT the material columns of `_mat_layout`; rows
# padded to whole float4s.
TRI_MAT = 32


@dataclasses.dataclass
class TriTable:
    """What `bounce` gathers a mesh winner from: the triangle table of
    `ops/trace.to_device` (`tr`: v0, e0, e1, vn, has_vn, n_face, uv,
    has_uv), the material columns (`tri_mat_table` as a tensor) and, on the
    card, their rows packed for the kernel (`rows`, built once)."""
    tr: object
    tri_mat: torch.Tensor
    rows: Optional[torch.Tensor] = None

    @staticmethod
    def build(tr, tri_mat) -> "TriTable":
        rows = None
        if tri_mat.is_cuda:
            n = tri_mat.shape[1]
            f32 = torch.float32
            width = -(-(TRI_MAT + tri_mat.shape[0]) // 4) * 4
            rows = torch.zeros((n, width), dtype=f32, device=tri_mat.device)
            rows[:, 0:3], rows[:, 3:6], rows[:, 6:9] = tr.v0, tr.e0, tr.e1
            rows[:, 9:18] = tr.vn.reshape(n, 9)
            rows[:, 18:21] = tr.n_face
            rows[:, 21] = tr.has_vn.to(f32)
            rows[:, 22] = tr.has_uv.to(f32)
            rows[:, 24:30] = tr.uv.reshape(n, 6)
            rows[:, TRI_MAT:TRI_MAT + tri_mat.shape[0]] = tri_mat.t()
        return TriTable(tr=tr, tri_mat=tri_mat, rows=rows)


def ext_planes_from_hit(statics, tri: TriTable, o, d, hit: MeshHit,
                        t_cap=None):
    """The external mesh-hit planes of `bounce_ref` from the walk's winner:
    the winning triangle's barycentrics recomputed, its normal, uv and
    material gathered. Returns a tuple of contiguous (N,) float32 planes:
    t (inf where no triangle won: idx -1, t not finite, or with `t_cap` t
    not below it), the outward normal (interpolated vertex normals where
    present, else the face normal; un-flipped, the bounce recomputes
    `front`), with statics["has_image"] the texture u and v (the
    interpolated vertex uv where present, else the barycentrics), then the
    material columns of `_mat_layout(statics)`: the JAX package's plane
    order. This is the plain version of K3's gather in ext mode
    (csrc/bounce.cu `tri_ext`)."""
    from go_raytracer_tpu_torch.ops import trace as trace_mod

    t_t, i_t = hit
    hit_ = torch.isfinite(t_t) & (i_t >= 0)
    if t_cap is not None:
        hit_ = hit_ & (t_t < t_cap)
    idx = torch.where(hit_, i_t, 0).to(torch.int64)
    tr = tri.tr
    t_safe = torch.where(hit_, t_t, 1.0)
    _, bu, bv, _ = trace_mod.tri_hit_gathered(tr, idx, o, d, -trace_mod.INF,
                                              trace_mod.INF)
    w = 1.0 - bu - bv
    vn = tr.vn[idx]
    n_interp = (w[:, None] * vn[:, 0] + bu[:, None] * vn[:, 1]
                + bv[:, None] * vn[:, 2])
    ln = torch.sqrt(torch.sum(n_interp * n_interp, dim=-1))
    n_interp = n_interp / torch.clamp(ln, min=1e-30)[:, None]
    n_raw = torch.where(tr.has_vn[idx][:, None], n_interp, tr.n_face[idx])
    uv = ()
    if statics["has_image"]:
        # the texture uv: interpolated vertex uv where the mesh has it,
        # else the barycentrics (objects.go:437-446)
        uvt = tr.uv[idx]
        uv_i = (w[:, None] * uvt[:, 0] + bu[:, None] * uvt[:, 1]
                + bv[:, None] * uvt[:, 2])
        has_uv = tr.has_uv[idx]
        uv = (torch.where(has_uv, uv_i[:, 0], bu).contiguous(),
              torch.where(has_uv, uv_i[:, 1], bv).contiguous())
    return (torch.where(hit_, t_safe, trace_mod.INF),
            *n_raw.t().contiguous(), *uv, *tri.tri_mat[:, idx])


def n_ext_planes(statics) -> int:
    """The number of ext planes `ext_planes_from_hit` gives for these
    statics: t, the normal, with images u and v, and the material
    columns."""
    return 4 + (2 if statics["has_image"] else 0) + len(_mat_layout(statics))


def _check_bounce_scene(statics):
    """Ext mode accepts what `supported_ext_statics` accepts, dense mode
    what `supported_statics` accepts (the JAX package's `supported_ext`
    and `supported`)."""
    ok = supported_ext_statics(statics) if statics["ext_hit"] \
        else supported_statics(statics)
    if not ok:
        raise NotImplementedError(
            "scene outside this kernel's subset (see supported() and "
            "supported_ext())")


def _check_bounce_ext(statics, ext):
    """`ext` is the mesh hit (a `MeshHit`, or its planes) in ext mode, and
    None in dense mode."""
    if statics["ext_hit"] and ext is None:
        raise ValueError("statics['ext_hit'] needs the mesh hit (ext)")
    if not statics["ext_hit"] and ext is not None:
        raise ValueError("ext given but statics['ext_hit'] is false")
    if not isinstance(ext, (MeshHit, type(None))) \
            and len(ext) != n_ext_planes(statics):
        raise ValueError(f"statics['ext_hit'] needs {n_ext_planes(statics)} "
                         f"ext planes or a MeshHit")


def bounce_ref(tables, statics, o, d, time, alive, u, bg, ext=None, out=None,
               probe=None, tri=None):
    """Plain PyTorch version of `bounce` (same arguments, same results).
    `ext` may also be the planes of `ext_planes_from_hit` themselves.
    `probe` (a list) receives the (N,) int64 flat texel index of the image
    lanes, -1 elsewhere (`_bounce_core_ref`'s)."""
    _check_bounce_scene(statics)
    _check_bounce_ext(statics, ext)
    if isinstance(ext, MeshHit):
        if tri is None:
            raise ValueError("a MeshHit needs the triangle tables (tri)")
        ext = ext_planes_from_hit(statics, tri, o, d, ext)
    prims, lights = tables[0], tables[1]
    us = [u[:, k] for k in range(N_U + statics["n_media"])]
    (vr, vg, vb, emit, cf, nox, noy, noz, ndx, ndy, ndz, alive_out) = \
        _bounce_core_ref(statics, prims, lights, bg.tolist(),
                         o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                         d[:, 2], alive, us, tm=time, ext=ext,
                         med=tables[2] if statics["n_media"] else None,
                         images=tuple(tables[4:6]) if statics["has_image"]
                         else None, probe=probe)
    V = torch.stack([vr, vg, vb], dim=-1)
    zero = torch.zeros_like(V)
    res = (torch.where(emit[:, None], V, zero),
           torch.where(emit[:, None], zero, V), cf,
           torch.stack([nox, noy, noz], dim=-1),
           torch.stack([ndx, ndy, ndz], dim=-1), alive_out & alive)
    if out is not None:
        for dst, src in zip(out, res):
            dst.copy_(src)
        res = tuple(out)
    return (*res, None)


def dense_cap_ref(ms, o, d, time):
    """Plain PyTorch version of `K3Launch.cap`: each ray's nearest t over
    the scene's spheres (at its time), quads and boxes in (T_MIN, inf),
    inf where it meets none. ms: `ops/trace.to_device(scene, device)`."""
    from go_raytracer_tpu_torch.ops import intersect as ix_mod
    from go_raytracer_tpu_torch.ops import trace as trace_mod

    t_cap = torch.full((o.shape[0],), float("inf"), dtype=o.dtype,
                       device=o.device)
    if ms.has_spheres:
        t_cap = torch.minimum(t_cap, ix_mod.sphere_ts(
            ms.spheres, o, d, time, trace_mod.T_MIN, float("inf"))
            .amin(dim=1))
    if ms.has_quads:
        t_cap = torch.minimum(t_cap, ix_mod.quad_ts(
            ms.quads, o, d, trace_mod.T_MIN, float("inf")).amin(dim=1))
    if ms.has_boxes:
        t_cap = torch.minimum(t_cap, ix_mod.box_ts(
            ms.boxes, o, d, trace_mod.T_MIN, float("inf")).amin(dim=1))
    return t_cap


# Mirror of `BounceArgs` in csrc/bounce.cu (field for field).
_BounceArgs = type("_BounceArgs", (ctypes.Structure,), {"_fields_": [
    (name, ctypes.c_void_p) for name in (
        "prims", "lights", "med", "bg", "o", "d", "tm", "alive", "u",
        "hit_t", "hit_idx", "tri", "E", "W", "cf", "new_o", "new_d",
        "alive_out", "t_cap") + _FUSED_TABLE_PTRS] + [
    (name, ctypes.c_int) for name in _FUSED_TABLE_INTS] + [
    (name, ctypes.c_int) for name in (
        "n", "n_u", "ext", "tri_cols", "tri_fr", "tri_texk", "tri_scale",
        "tri_seed")]})

def bounce_out(n: int, device):
    """Output buffers of `bounce` for `n` lanes: E, W (N, 3) float32, cf
    (N,) bool, new_o, new_d (N, 3) float32, alive' (N,) bool."""
    vec = lambda: torch.empty((n, 3), dtype=torch.float32, device=device)
    flag = lambda: torch.empty(n, dtype=torch.bool, device=device)
    return vec(), vec(), flag(), vec(), vec(), flag()


class K3Launch:
    """K3 (`bounce`) prepared once for a scene: the table part of the
    kernel's argument struct, the table ints and their checks and the
    triangle rows of ext mode, so that a call sets only the lanes'
    pointers and count and checks the lanes' tensors.

    tables = `pack_scene(scene)` as tensors; statics = `scene_statics(scene,
    ext=...)`; bg (3,) float32; tri: a `TriTable` (ext mode, where `bounce`
    takes a `MeshHit`). On CPU tables every call runs the plain versions."""

    def __init__(self, tables, statics, bg, tri: Optional[TriTable] = None):
        self.tables, self.statics, self.bg, self.tri = tables, statics, bg, tri
        self.cuda = tables[0].is_cuda
        self.n_u = N_U + statics["n_media"]
        _check_bounce_scene(statics)
        if not self.cuda:
            return

        st = statics
        _check_cuda_args(_fused_table_checks(tables, st)
                         + [("bg", bg, torch.float32, (3,))])
        p = lambda t: t.data_ptr()
        a = _BounceArgs(prims=p(tables[0]), lights=p(tables[1]),
                        med=p(tables[2]), bg=p(bg),
                        **_fused_table_ints(st, tables, False))
        if st["ext_hit"]:
            if tri is None or tri.rows is None or not tri.rows.is_cuda:
                raise ValueError("ext mode on the card needs a TriTable "
                                 "built from CUDA tensors")
            lay_m = _mat_layout(st)
            col = lambda name: (TRI_MAT + lay_m.index(name)
                                if name in lay_m else -1)
            a.tri, a.ext, a.tri_cols = p(tri.rows), 1, tri.rows.shape[1]
            a.tri_fr, a.tri_texk = col("fr"), col("texk")
            a.tri_scale, a.tri_seed = col("scale"), col("seed_img")
        self.args = a
        lib = _cuda.library("bounce")
        self._fn, self._cap_fn = lib.grt_bounce, lib.grt_bounce_cap
        self._dev = tables[0].device

    def _lanes(self, checks):
        """Raise unless each (name, tensor, dtype, shape) is a contiguous
        tensor on the tables' device of that dtype and shape."""
        for name, t, dt, shape in checks:
            if t.device != self._dev or t.dtype != dt or t.shape != shape \
                    or not t.is_contiguous():
                raise ValueError(
                    f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}, "
                    f"expected a contiguous {dt} {tuple(shape)} on "
                    f"{self._dev}")

    def __call__(self, o, d, time, alive, u, ext=None, out=None):
        """`bounce` on this scene (its arguments but the tables, statics,
        bg and tri)."""
        st = self.statics
        if not o.is_cuda:
            return bounce_ref(self.tables, st, o, d, time, alive, u, self.bg,
                              ext, out, tri=self.tri)
        if not self.cuda:
            raise ValueError("the lanes are on the card, the tables are not")
        _check_bounce_ext(st, ext)
        if st["ext_hit"] and not isinstance(ext, MeshHit):
            raise ValueError("ext mode on the card takes the walk's MeshHit "
                             "(t, idx), not planes")
        n = o.shape[0]
        f32 = torch.float32
        if u.dim() != 2 or u.shape[1] < self.n_u:
            raise ValueError(f"u needs at least {self.n_u} columns "
                             f"(N_U + media)")
        if out is None:
            out = bounce_out(n, o.device)
        E, W, cf, new_o, new_d, alive_out = out
        vec, lane = (n, 3), (n,)
        checks = [("o", o, f32, vec), ("d", d, f32, vec),
                  ("time", time, f32, lane), ("alive", alive, torch.bool, lane),
                  ("u", u, f32, (n, u.shape[1])), ("out E", E, f32, vec),
                  ("out W", W, f32, vec), ("out cf", cf, torch.bool, lane),
                  ("out new_o", new_o, f32, vec),
                  ("out new_d", new_d, f32, vec),
                  ("out alive", alive_out, torch.bool, lane)]
        if st["ext_hit"]:
            checks += [("hit t", ext.t, f32, lane),
                       ("hit idx", ext.idx, torch.int32, lane)]
        self._lanes(checks)
        if n == 0:
            return (*out, None)
        a = self.args
        a.o, a.d, a.tm, a.alive = (o.data_ptr(), d.data_ptr(),
                                   time.data_ptr(), alive.data_ptr())
        a.u, a.n, a.n_u = u.data_ptr(), n, u.shape[1]
        a.E, a.W, a.cf = E.data_ptr(), W.data_ptr(), cf.data_ptr()
        a.new_o, a.new_d = new_o.data_ptr(), new_d.data_ptr()
        a.alive_out = alive_out.data_ptr()
        if st["ext_hit"]:
            a.hit_t, a.hit_idx = ext.t.data_ptr(), ext.idx.data_ptr()
        err = self._fn(ctypes.addressof(a),
                       torch.cuda.current_stream(self._dev).cuda_stream)
        if err:
            raise RuntimeError(f"bounce launch failed: "
                               f"{_cuda.error_string(err)}")
        _cuda.count(globals(), "launches_bounce")
        return (*out, None)

    def cap(self, ms, o, d, time, out=None):
        """The dense cap of the mesh path: each ray's nearest t over the
        scene's spheres (at its time), quads and boxes in (T_MIN, inf), inf
        where none (`bounce_cap`, the core's scan). CPU tensors run
        `dense_cap_ref` on `ms`; on the card `ms` is not read."""
        if not o.is_cuda:
            return dense_cap_ref(ms, o, d, time)
        if not self.cuda:
            raise ValueError("the lanes are on the card, the tables are not")
        n = o.shape[0]
        f32 = torch.float32
        if out is None:
            out = torch.empty(n, dtype=f32, device=o.device)
        self._lanes([("o", o, f32, (n, 3)), ("d", d, f32, (n, 3)),
                     ("time", time, f32, (n,)), ("out t_cap", out, f32, (n,))])
        if n == 0:
            return out
        a = self.args
        a.o, a.d, a.tm, a.t_cap, a.n = (o.data_ptr(), d.data_ptr(),
                                        time.data_ptr(), out.data_ptr(), n)
        err = self._cap_fn(ctypes.addressof(a),
                           torch.cuda.current_stream(self._dev).cuda_stream)
        if err:
            raise RuntimeError(f"bounce_cap launch failed: "
                               f"{_cuda.error_string(err)}")
        _cuda.count(globals(), "launches_cap")
        return out


def bounce(tables, statics, o, d, time, alive, u, bg, ext=None, out=None,
           tri=None):
    """One bounce for the whole ray bundle from given uniforms: the JAX
    package's `bounce` with its arguments and results, kept as that
    one-call form for the tests and `chip_smoke.py` (a render loop holds a
    `K3Launch`, which this builds for the one call).

    tables = `pack_scene(scene)` as tensors; statics =
    `scene_statics(scene, ext=...)`; o, d: (N, 3) float32; time: (N,)
    float32; alive: (N,) bool; u: (N, N_U + n_media) uniforms in the slot
    order metal a/b, dielectric, mix, light pick, light a/b, material a/b,
    then one per medium; bg: (3,). Dense mode (statics["ext_hit"] false)
    is the reference engine's bounce and carries what `supported`
    carries; with statics["ext_hit"], `ext` = the mesh walk's `MeshHit`
    and `tri` its scene's `TriTable` (on the CPU also the planes of
    `ext_planes_from_hit`; what `supported_ext` carries). Returns E (N,
    3), W (N, 3), cf (N,) bool, new_o, new_d (N, 3), alive' (N,) bool,
    None: an image-textured diffuse lane's texel is read inside the kernel,
    so W is already the JAX package's weight after `patch_image_weight` and
    there are no image planes to return. `out` = `bounce_out(N, device)` is
    written in place and returned, so a loop over levels allocates
    nothing; none of its tensors may be an input.

    CUDA tensors launch the kernel; CPU tensors run `bounce_ref`. The
    kernel leaves a dead lane's direction as it was, where the plain
    version writes a don't-care sampled direction."""
    if not o.is_cuda:
        return bounce_ref(tables, statics, o, d, time, alive, u, bg, ext, out,
                          tri=tri)
    return K3Launch(tables, statics, bg, tri)(o, d, time, alive, u, ext, out)
