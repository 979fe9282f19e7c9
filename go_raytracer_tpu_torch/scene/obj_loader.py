"""OBJ/MTL mesh loading (host-side) with the reference's exact semantics.

Mirrors internal/objLoader/objLoader.go:18-538 and mtlLoader.go:53-326:

* LoadOptions matches LoadObjOptions (objLoader.go:18-45) field for field.
* Two-pass parse: mtllib scan, vertices+bounds with scale/FlipYZ, center+
  position transform, then vn/usemtl/f with fan triangulation of n-gons and
  1-based / negative index fixup (objLoader.go:47-61).
* MTL materials run through the same conversion heuristic
  (mtlLoader.go:233-326) — it defines how mesh scenes look.
* Emissive (and, with find_windows, dielectric) triangles are returned as
  light handles for importance sampling (objLoader.go:492-510).

Output goes straight into SceneBuilder.add_mesh as bulk numpy blocks.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np

from go_raytracer_tpu_torch.scene import assets
from go_raytracer_tpu_torch.scene import types as T
from go_raytracer_tpu_torch.scene.builder import IDENTITY, SceneBuilder, Transform


@dataclasses.dataclass
class LoadOptions:
    """objLoader.go:18-45 (defaults from DefaultLoadOptions, debug off)."""

    scale_factor: float = 1.0
    flip_yz: bool = False
    debug: bool = False
    ignore_normals: bool = False
    center: bool = True
    flip_faces: bool = False
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    default_material: Optional[int] = None
    ignore_mtl: bool = False
    find_windows: bool = False


@dataclasses.dataclass
class MtlMaterial:
    """mtlLoader.go:18-45 with newmtl defaults (mtlLoader.go:87-98)."""

    name: str
    ambient: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0.2, 0.2, 0.2]))
    diffuse: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0.8, 0.8, 0.8]))
    specular: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    emission: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    spec_exp: float = 0.0
    dissolve: float = 1.0
    refraction: float = 1.0
    illum: int = 2
    map_kd: str = ""
    map_ka: str = ""


def parse_mtl(path: str) -> dict:
    """Parse an MTL file into MtlMaterial records (mtlLoader.go:53-204)."""
    mats = {}
    cur: Optional[MtlMaterial] = None
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key = parts[0]
            if key == "newmtl" and len(parts) >= 2:
                cur = MtlMaterial(name=parts[1])
                mats[parts[1]] = cur
            elif cur is None:
                continue
            elif key in ("Ka", "Kd", "Ks", "Ke") and len(parts) >= 4:
                vec = np.array([_flt(parts[1]), _flt(parts[2]), _flt(parts[3])])
                attr = {"Ka": "ambient", "Kd": "diffuse",
                        "Ks": "specular", "Ke": "emission"}[key]
                setattr(cur, attr, vec)
            elif key == "Ns" and len(parts) >= 2:
                cur.spec_exp = _flt(parts[1])
            elif key == "d" and len(parts) >= 2:
                cur.dissolve = _flt(parts[1])
            elif key == "Ni" and len(parts) >= 2:
                cur.refraction = _flt(parts[1])
            elif key == "Tf" and len(parts) >= 4:
                # dissolve = mean transmission filter (mtlLoader.go:157-166)
                cur.dissolve = (_flt(parts[1]) + _flt(parts[2]) + _flt(parts[3])) / 3.0
            elif key == "illum" and len(parts) >= 2:
                try:
                    cur.illum = int(parts[1])
                except ValueError:
                    pass
            elif key == "map_Kd" and len(parts) >= 2:
                cur.map_kd = " ".join(parts[1:])
            elif key == "map_Ka" and len(parts) >= 2:
                cur.map_ka = " ".join(parts[1:])
    return mats


def _flt(s: str) -> float:
    try:
        return float(s)
    except ValueError:
        return 0.0


def convert_material(b: SceneBuilder, mtl: MtlMaterial, base_dir: str):
    """The reference's MTL->raytracer heuristic (mtlLoader.go:233-326),
    ported verbatim. Returns (builder mat id, kind)."""
    # 1. dielectrics
    if (mtl.dissolve < 0.95 and mtl.refraction > 1.0) or mtl.illum in (4, 6, 7):
        ri = mtl.refraction if mtl.refraction > 1.01 else 1.5
        return b.dielectric(ri), T.MAT_DIELECTRIC
    # 2. translucent -> isotropic
    if mtl.dissolve < 0.95:
        return b.isotropic(tuple(mtl.diffuse)), T.MAT_ISOTROPIC
    # 3. emissive
    if float(mtl.emission.sum()) > 0.1:
        tex = _map_tex(b, mtl.map_kd or mtl.map_ka, base_dir)
        if tex is not None:
            return b.diffuse_light(tex=tex), T.MAT_DIFFUSE_LIGHT
        return b.diffuse_light(tuple(mtl.emission)), T.MAT_DIFFUSE_LIGHT
    # 4. metallic
    spec_i = float(mtl.specular.sum())
    diff_i = float(mtl.diffuse.sum())
    if spec_i > 0.1 and spec_i > diff_i * 0.5:
        if mtl.spec_exp <= 0.0:
            rough = 1.0
        elif mtl.spec_exp >= 1000.0:
            rough = 0.0
        else:
            rough = float(np.clip((1.0 - mtl.spec_exp / 1000.0) ** 2, 0.0, 1.0))
        color = mtl.specular
        if spec_i < 0.2:
            blend = 1.0 - spec_i / 0.2
            color = (1.0 - blend) * mtl.specular + blend * mtl.diffuse
        return b.metal(tuple(color), rough), T.MAT_METAL
    # 5. by illumination model
    if mtl.illum in (3, 4, 5):
        return b.metal(tuple(mtl.specular), 0.3), T.MAT_METAL
    tex = _map_tex(b, mtl.map_kd or mtl.map_ka, base_dir)
    if tex is not None:
        return b.lambertian(tex=tex), T.MAT_LAMBERTIAN
    return b.lambertian(tuple(mtl.diffuse)), T.MAT_LAMBERTIAN


def _map_tex(b: SceneBuilder, map_name: str, base_dir: str):
    if not map_name:
        return None
    for cand in (os.path.join(base_dir, map_name), map_name):
        if os.path.exists(cand):
            return b.image_texture(assets.load_image(cand))
    return None


def _fix_index(i: int, length: int) -> int:
    """1-based and negative index fixup with clamping (objLoader.go:47-61)."""
    i = length + i if i < 0 else i - 1
    return int(np.clip(i, 0, length - 1))


def load_obj(b: SceneBuilder, path: str, options: LoadOptions = LoadOptions(),
             transform: Transform = IDENTITY) -> List:
    """Parse the OBJ into builder triangles; returns light handles
    (emissive, plus dielectric when find_windows) for importance sampling."""
    with open(path) as fh:
        lines = fh.read().splitlines()

    default_mat = (options.default_material if options.default_material is not None
                   else b.lambertian((0.8, 0.8, 0.8)))  # objLoader.go:88-90
    mat_kinds = {default_mat: None}

    # mtllib scan (objLoader.go:104-142)
    mtl_mats = {}
    if not options.ignore_mtl:
        for line in lines:
            parts = line.strip().split()
            if parts and parts[0] == "mtllib" and len(parts) >= 2:
                mtl_path = os.path.join(os.path.dirname(path), " ".join(parts[1:]))
                if options.debug:
                    print(f"Loading MTL file: {mtl_path}")  # objLoader.go:126-128
                if os.path.exists(mtl_path):
                    for name, mtl in parse_mtl(mtl_path).items():
                        mid, kind = convert_material(b, mtl, os.path.dirname(path))
                        mtl_mats[name] = mid
                        mat_kinds[mid] = kind
                        if options.debug:
                            # material report (mtlLoader.go:211-227)
                            print(f"Loaded material {name}: kind={kind} "
                                  f"Kd={tuple(mtl.diffuse)} Ks={tuple(mtl.specular)} "
                                  f"Ke={tuple(mtl.emission)} Ns={mtl.spec_exp} "
                                  f"d={mtl.dissolve} Ni={mtl.refraction} "
                                  f"illum={mtl.illum}")
                break

    # pass 1: vertices, texcoords, bounds (objLoader.go:145-208)
    raw_v, tex_coords = [], []
    for line in lines:
        parts = line.strip().split()
        if not parts or parts[0].startswith("#"):
            continue
        if parts[0] == "v" and len(parts) >= 4:
            x, y, z = (_flt(parts[1]) * options.scale_factor,
                       _flt(parts[2]) * options.scale_factor,
                       _flt(parts[3]) * options.scale_factor)
            if options.flip_yz:
                y, z = z, y
            raw_v.append((x, y, z))
        elif parts[0] == "vt" and len(parts) >= 3:
            tex_coords.append((_flt(parts[1]), _flt(parts[2])))

    verts = np.asarray(raw_v, dtype=np.float64)
    if verts.size and options.debug:
        # model bounds report (objLoader.go:223-236)
        print(f"Model bounds: min={tuple(verts.min(0))} "
              f"max={tuple(verts.max(0))} "
              f"center={tuple((verts.min(0) + verts.max(0)) / 2.0)}")
    if verts.size and options.center:
        center = (verts.min(0) + verts.max(0)) / 2.0  # objLoader.go:211-215
        verts = verts - center + np.asarray(options.position)  # :243-247
        if options.debug:
            print(f"Centered model at {tuple(np.asarray(options.position))}")
            # post-transform verification bounds (objLoader.go:254-283)
            print(f"New bounds after centering: min={tuple(verts.min(0))} "
                  f"max={tuple(verts.max(0))} "
                  f"center={tuple((verts.min(0) + verts.max(0)) / 2.0)}")
    tex_coords = np.asarray(tex_coords, dtype=np.float64).reshape(-1, 2)

    # pass 2: normals, usemtl, faces (objLoader.go:286-470)
    normals = []
    cur_mat = default_mat
    tri_v, tri_n, tri_uv, tri_has_n, tri_has_uv, tri_mat = [], [], [], [], [], []
    for line in lines:
        parts = line.strip().split()
        if not parts or parts[0].startswith("#"):
            continue
        if parts[0] == "vn" and len(parts) >= 4:
            n = np.array([_flt(parts[1]), _flt(parts[2]), _flt(parts[3])])
            if options.flip_yz:
                n[1], n[2] = n[2], n[1]
            ln = np.linalg.norm(n)
            normals.append(n / ln if ln > 0 else n)
        elif parts[0] == "usemtl" and len(parts) >= 2 and not options.ignore_mtl:
            if parts[1] in mtl_mats:
                cur_mat = mtl_mats[parts[1]]
                if options.debug:
                    print(f"Switched to material: {parts[1]}")  # objLoader.go:333-335
            else:
                cur_mat = default_mat
                if options.debug:
                    print(f"Material not found: {parts[1]}, using default")  # :337-339
        elif parts[0] == "f" and len(parts) >= 4:
            fv, ft, fn = [], [], []
            for spec in parts[1:]:
                idx = spec.split("/")
                if idx[0]:
                    try:
                        fv.append(verts[_fix_index(int(idx[0]), len(verts))])
                    except ValueError:
                        continue
                if len(idx) > 1 and idx[1] and len(tex_coords):
                    try:
                        ft.append(tex_coords[_fix_index(int(idx[1]), len(tex_coords))])
                    except ValueError:
                        pass
                if (len(idx) > 2 and idx[2] and len(normals)
                        and not options.ignore_normals):
                    try:
                        fn.append(normals[_fix_index(int(idx[2]), len(normals))])
                    except ValueError:
                        pass
            if len(fv) < 3:
                continue
            # fan triangulation (objLoader.go:396-467)
            for i in range(2, len(fv)):
                v1, v2, v3 = fv[0], fv[i - 1], fv[i]
                if options.flip_faces:
                    v2, v3 = v3, v2
                has_uv = len(ft) >= len(fv) and len(ft) > i
                has_n = len(fn) >= len(fv) and len(fn) > i and not options.ignore_normals
                if has_uv:
                    t1, t2, t3 = ft[0], ft[i - 1], ft[i]
                    if options.flip_faces:
                        t2, t3 = t3, t2
                    tri_uv.append((t1, t2, t3))
                else:
                    tri_uv.append(((0, 0), (0, 0), (0, 0)))
                if has_n:
                    n1, n2, n3 = fn[0], fn[i - 1], fn[i]
                    if options.flip_faces:
                        n2, n3 = n3, n2
                    tri_n.append((n1, n2, n3))
                else:
                    tri_n.append((np.zeros(3), np.zeros(3), np.zeros(3)))
                tri_v.append((v1, v2, v3))
                tri_has_uv.append(has_uv)
                tri_has_n.append(has_n)
                tri_mat.append(cur_mat)

    if not tri_v:
        raise ValueError(f"No triangles found in OBJ file {path}")

    handles = b.add_mesh(
        np.asarray(tri_v), np.asarray(tri_mat, dtype=np.int32),
        normals=np.asarray(tri_n), has_vn=np.asarray(tri_has_n),
        uvs=np.asarray(tri_uv), has_uv=np.asarray(tri_has_uv),
        transform=transform)

    # light extraction (objLoader.go:492-510)
    lights = []
    for h, mid in zip(handles, tri_mat):
        kind = mat_kinds.get(mid)
        if kind == T.MAT_DIFFUSE_LIGHT or (options.find_windows and kind == T.MAT_DIELECTRIC):
            lights.append(h)
    if options.debug:
        # model summary (objLoader.go:476-484)
        print("=== MODEL SUMMARY ===")
        print(f"Loaded {len(verts)} vertices, {len(normals)} normals, "
              f"{len(tri_v)} triangles")
        if mtl_mats:
            print(f"Used {len(mtl_mats)} materials from MTL file")
        # light count + final bounds (objLoader.go:515-535); SceneBuilder
        # bakes transforms, so the pre-transform triangle bounds play the
        # BVH-bbox role here
        print(f"{len(lights)} Light sources found")
        tv = np.asarray(tri_v).reshape(-1, 3)
        bmin, bmax = tv.min(0), tv.max(0)
        print("=== FINAL BVH BOUNDS ===")
        for ax, nm in enumerate("XYZ"):
            print(f"{nm}: {bmin[ax]:f} to {bmax[ax]:f}")
        c = (bmin + bmax) / 2.0
        print(f"BVH center: [{c[0]:f}, {c[1]:f}, {c[2]:f}]")
    return lights


def procedural_statue(b: SceneBuilder, mat: int, options: LoadOptions,
                      transform: Transform = IDENTITY,
                      major_segments: int = 256, minor_segments: int = 128) -> List:
    """Stand-in high-poly mesh (a displaced torus knot, ~65k tris by
    default) used when no OBJ file is available, so modelExample and mesh
    benchmarks run hermetically. Goes through the same scale/center/
    position pipeline as a real OBJ."""
    p, q = 2, 3
    t = np.linspace(0, 2 * np.pi, major_segments, endpoint=False)
    r = 2.0 + np.cos(q * t)
    cx = np.stack([r * np.cos(p * t), r * np.sin(p * t), -np.sin(q * t)], -1)
    # tube frame
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
    verts = ring.reshape(-1, 3)
    # scale/center/position like the OBJ path (objLoader.go:189, 243-247)
    verts = verts * options.scale_factor
    if options.center:
        center = (verts.min(0) + verts.max(0)) / 2.0
        verts = verts - center + np.asarray(options.position)

    nmaj, nmin = major_segments, minor_segments
    idx = np.arange(nmaj * nmin).reshape(nmaj, nmin)
    i0 = idx
    i1 = np.roll(idx, -1, axis=0)
    i2 = np.roll(idx, -1, axis=1)
    i3 = np.roll(np.roll(idx, -1, axis=0), -1, axis=1)
    tris = np.concatenate([
        np.stack([i0.ravel(), i1.ravel(), i3.ravel()], -1),
        np.stack([i0.ravel(), i3.ravel(), i2.ravel()], -1),
    ])
    tri_v = verts[tris]  # (T, 3, 3)
    mat_ids = np.full(tri_v.shape[0], mat, dtype=np.int32)
    b.add_mesh(tri_v, mat_ids, transform=transform)
    return []
