"""Host-side scene compiler: Python scene description -> flat numpy tables.

Replaces the reference's runtime Hittable tree (HittableList / BVHNode /
translate / rotateY wrappers) with a build-time compiler:

* boxes fuse into one slab-test row each (hittable/objects.go:208-240),
* translate/rotate-Y wrappers are baked into primitive coordinates
  (hittable/transformation.go:13-110 becomes `Transform.point/vector`),
* materials/textures become integer-indexed tables,
* the lights list (hittable/hittable.go:89-103) becomes (kind, prim_id) rows.

Everything is numpy: the output `Scene` holds float32/int32/bool arrays,
value for value the tables of the JAX package's compiler. A mesh of
BVH_THRESHOLD triangles or more gets the triangle BVH (scene/bvh.py), its
8-wide collapse (scene/bvh8.py) and its cluster partition
(scene/clusters.py), and is stored in BVH leaf order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np

from go_raytracer_tpu_torch.scene import bvh as bvh_mod
from go_raytracer_tpu_torch.scene import bvh8 as bvh8_mod
from go_raytracer_tpu_torch.scene import clusters as cl_mod
from go_raytracer_tpu_torch.scene import perlin as perlin_mod
from go_raytracer_tpu_torch.scene import types as T


Vec = Tuple[float, float, float]


@dataclasses.dataclass
class Transform:
    """Rotate-Y-then-translate, matching the reference nesting
    Translate(RotateY(obj, deg), offset). Compose by wrapping `then`."""

    rotate_y_deg: float = 0.0
    translate: Vec = (0.0, 0.0, 0.0)

    def vector(self, v) -> np.ndarray:
        v = np.asarray(v, dtype=np.float64)
        th = math.radians(self.rotate_y_deg)
        c, s = math.cos(th), math.sin(th)
        # object -> world rotation (transformation.go:87-93)
        return np.array([c * v[0] + s * v[2], v[1], -s * v[0] + c * v[2]])

    def point(self, p) -> np.ndarray:
        return self.vector(p) + np.asarray(self.translate, dtype=np.float64)

    def then(self, outer: "Transform") -> "Transform":
        """Apply self first, then `outer` (rotate-then-translate chains
        only; two rotations raise)."""
        if self.rotate_y_deg != 0.0 and outer.rotate_y_deg != 0.0:
            raise ValueError("compose of two rotations not supported; bake manually")
        rot = self.rotate_y_deg + outer.rotate_y_deg
        off = outer.point(np.asarray(self.translate))
        return Transform(rot, tuple(off - 0.0))


IDENTITY = Transform()
# triangle count from which the mesh gets a triangle BVH
BVH_THRESHOLD = 2048
BVH_LEAF_SIZE = 16
# triangles per cluster of the binned intersector (at most 256 clusters,
# so the processed bits ride the per-round sort as at most 8 int32 planes)
CLUSTER_TRIS = 512
# triangles per cluster of the finer partition of the persistent-block
# intersector (ops/stream2.py; at most 1024 clusters)
CLUSTER2_TRIS = 128
# the finer partition is built only for meshes whose packed group table
# (64 B per triangle) fits this budget, as in the JAX package
CLUSTER2_TABLE_BYTES = 12 * 1024 * 1024


def _bulk_transform_vectors(tr: Transform, v: np.ndarray) -> np.ndarray:
    """Vectorized Transform.vector for (n, 3) arrays."""
    th = math.radians(tr.rotate_y_deg)
    c, s = math.cos(th), math.sin(th)
    out = np.empty_like(v)
    out[:, 0] = c * v[:, 0] + s * v[:, 2]
    out[:, 1] = v[:, 1]
    out[:, 2] = -s * v[:, 0] + c * v[:, 2]
    return out


def _bulk_transform_points(tr: Transform, p: np.ndarray) -> np.ndarray:
    return _bulk_transform_vectors(tr, p) + np.asarray(tr.translate, dtype=np.float64)


class SceneBuilder:
    def __init__(self, background: Vec = (0.0, 0.0, 0.0)):
        self.background = tuple(float(x) for x in background)
        self._tex = []
        self._perlin = []
        self._images = []
        self._mat = []
        self._spheres = []
        self._quads = []
        self._boxes = []
        self._tri_blocks = []
        self._tri_count = 0
        self._media = []
        self._lights = []
        self._perlin_rng = np.random.default_rng(1234)

    # ------------------------------------------------------------------ tex
    def _add_tex(self, **row) -> int:
        base = dict(kind=T.TEX_SOLID, color=(0, 0, 0), inv_scale=0.0,
                    even=(0, 0, 0), odd=(0, 0, 0), scale=0.0,
                    noise_id=0, image_id=0)
        base.update(row)
        self._tex.append(base)
        return len(self._tex) - 1

    def solid(self, color: Vec) -> int:
        """texture.go:14-27"""
        return self._add_tex(kind=T.TEX_SOLID, color=tuple(color))

    def checker(self, scale: float, even: Vec, odd: Vec) -> int:
        """texture.go:29-60 (color-only variant)"""
        return self._add_tex(kind=T.TEX_CHECKER, inv_scale=1.0 / scale,
                             even=tuple(even), odd=tuple(odd))

    def image_texture(self, image: np.ndarray) -> int:
        """texture.go:62-86; `image` is (H, W, 3) float in [0, 1]."""
        self._images.append(np.asarray(image, dtype=np.float32))
        return self._add_tex(kind=T.TEX_IMAGE, image_id=len(self._images) - 1)

    def noise_texture(self, scale: float, variant: str = "perlin",
                      seed: Optional[int] = None) -> int:
        """texture.go:88-125; each texture owns a fresh noise seed."""
        rng = np.random.default_rng(seed) if seed is not None else self._perlin_rng
        self._perlin.append(perlin_mod.make_seed(rng))
        kind = {"perlin": T.TEX_PERLIN, "marble": T.TEX_MARBLE,
                "turbulent": T.TEX_TURBULENT}[variant]
        return self._add_tex(kind=kind, scale=float(scale),
                             noise_id=len(self._perlin) - 1)

    # ------------------------------------------------------------------ mat
    def _add_mat(self, kind: int, tex_id: int, fuzz=0.0, ref_idx=1.0) -> int:
        self._mat.append(dict(kind=kind, tex_id=tex_id, fuzz=float(fuzz),
                              ref_idx=float(ref_idx)))
        return len(self._mat) - 1

    def lambertian(self, albedo: Optional[Vec] = None, tex: Optional[int] = None) -> int:
        """materials.go:30-57"""
        tex_id = tex if tex is not None else self.solid(albedo)
        return self._add_mat(T.MAT_LAMBERTIAN, tex_id)

    def metal(self, albedo: Vec, fuzz: float) -> int:
        """materials.go:60-82"""
        return self._add_mat(T.MAT_METAL, self.solid(albedo), fuzz=fuzz)

    def dielectric(self, ref_idx: float) -> int:
        """materials.go:85-130"""
        return self._add_mat(T.MAT_DIELECTRIC, self.solid((1, 1, 1)), ref_idx=ref_idx)

    def diffuse_light(self, color: Optional[Vec] = None, tex: Optional[int] = None) -> int:
        """materials.go:132-155"""
        tex_id = tex if tex is not None else self.solid(color)
        return self._add_mat(T.MAT_DIFFUSE_LIGHT, tex_id)

    def isotropic(self, albedo: Optional[Vec] = None, tex: Optional[int] = None) -> int:
        """materials.go:157-177"""
        tex_id = tex if tex is not None else self.solid(albedo)
        return self._add_mat(T.MAT_ISOTROPIC, tex_id)

    # ----------------------------------------------------------- primitives
    def sphere(self, center: Vec, radius: float, mat: int,
               center2: Optional[Vec] = None,
               transform: Transform = IDENTITY):
        """objects.go:23-37; motion blur via center2 (NewMotionSphere)."""
        c0 = transform.point(center)
        c1 = transform.point(center2) if center2 is not None else c0
        self._spheres.append(dict(center0=c0, center_delta=c1 - c0,
                                  radius=float(radius), mat_id=mat))
        return ("sphere", len(self._spheres) - 1)

    def quad(self, q: Vec, u: Vec, v: Vec, mat: int,
             transform: Transform = IDENTITY):
        """objects.go:129-146"""
        self._quads.append(dict(q=transform.point(q), u=transform.vector(u),
                                v=transform.vector(v), mat_id=mat))
        return ("quad", len(self._quads) - 1)

    def box(self, a: Vec, b: Vec, mat: int, transform: Transform = IDENTITY,
            fuse: bool = True):
        """objects.go:208-240: six quads, fused into ONE slab-test row when
        the texture never reads uv (types.Boxes). Axis-preserving
        transforms bake into world bounds; a rotate-Y keeps object-space
        bounds plus the rotation row. `fuse=False` forces six quads."""
        a = np.asarray(a, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        if fuse and self._box_fusable(mat):
            if self._axis_preserving(lo, hi, transform):
                c0 = transform.point(lo)
                c1 = transform.point(hi)
                self._boxes.append(dict(lo=np.minimum(c0, c1),
                                        hi=np.maximum(c0, c1),
                                        cos_t=1.0, sin_t=0.0,
                                        offset=(0.0, 0.0, 0.0), mat_id=mat))
            else:
                th = math.radians(transform.rotate_y_deg)
                self._boxes.append(dict(lo=lo, hi=hi, cos_t=math.cos(th),
                                        sin_t=math.sin(th),
                                        offset=tuple(float(x) for x in
                                                     transform.translate),
                                        mat_id=mat))
            return [("box", len(self._boxes) - 1)]
        dx = np.array([hi[0] - lo[0], 0, 0])
        dy = np.array([0, hi[1] - lo[1], 0])
        dz = np.array([0, 0, hi[2] - lo[2]])
        # front, right, back, left, top, bottom (objects.go:227-237)
        return [self.quad((lo[0], lo[1], hi[2]), dx, dy, mat, transform),
                self.quad((hi[0], lo[1], hi[2]), -dz, dy, mat, transform),
                self.quad((hi[0], lo[1], lo[2]), -dx, dy, mat, transform),
                self.quad((lo[0], lo[1], lo[2]), dz, dy, mat, transform),
                self.quad((lo[0], hi[1], hi[2]), dx, -dz, mat, transform),
                self.quad((lo[0], lo[1], lo[2]), dx, dz, mat, transform)]

    def _box_fusable(self, mat: int) -> bool:
        """True when the texture is uv-independent (fusion drops uv)."""
        return self._tex[self._mat[mat]["tex_id"]]["kind"] != T.TEX_IMAGE

    def _axis_preserving(self, lo, hi, transform: Transform) -> bool:
        """True when the transform maps each axis edge to a single-axis
        vector, so the box stays axis-aligned after baking."""
        for axis in range(3):
            e = np.zeros(3)
            e[axis] = hi[axis] - lo[axis]
            v = np.asarray(transform.vector(e), dtype=np.float64)
            if np.count_nonzero(np.abs(v) > 1e-12 * max(np.abs(v).max(), 1e-300)) > 1:
                return False
        return True

    def triangle(self, vertices: Sequence[Vec], mat: int,
                 normals: Optional[Sequence[Vec]] = None,
                 uvs: Optional[Sequence[Tuple[float, float]]] = None,
                 transform: Transform = IDENTITY):
        """objects.go:257-316 (all four constructors)."""
        v = np.asarray(vertices, dtype=np.float64)[None]
        vn = (np.asarray(normals, dtype=np.float64)[None]
              if normals is not None else None)
        uv = np.asarray(uvs, dtype=np.float64)[None] if uvs is not None else None
        return self.add_mesh(
            v, np.asarray([mat], dtype=np.int32), normals=vn,
            has_vn=None if normals is None else np.asarray([True]),
            uvs=uv, has_uv=None if uvs is None else np.asarray([True]),
            transform=transform)[0]

    def add_mesh(self, vertices: np.ndarray, mat_ids: np.ndarray,
                 normals: Optional[np.ndarray] = None,
                 has_vn: Optional[np.ndarray] = None,
                 uvs: Optional[np.ndarray] = None,
                 has_uv: Optional[np.ndarray] = None,
                 transform: Transform = IDENTITY):
        """Bulk triangle path: vertices (T,3,3), mat_ids (T,), optional
        normals (T,3,3) + has_vn (T,), uvs (T,3,2) + has_uv (T,)."""
        tcount = vertices.shape[0]
        v = np.asarray(vertices, dtype=np.float64)
        if transform is not IDENTITY:
            v = _bulk_transform_points(transform, v.reshape(-1, 3)).reshape(tcount, 3, 3)
        vn = None
        if normals is not None:
            vn = np.asarray(normals, dtype=np.float64)
            if transform is not IDENTITY:
                vn = _bulk_transform_vectors(transform, vn.reshape(-1, 3)).reshape(tcount, 3, 3)
        self._tri_blocks.append(dict(
            v=v, vn=vn,
            has_vn=(np.asarray(has_vn, dtype=bool) if has_vn is not None
                    else np.full(tcount, normals is not None)),
            uv=np.asarray(uvs, dtype=np.float64) if uvs is not None else None,
            has_uv=(np.asarray(has_uv, dtype=bool) if has_uv is not None
                    else np.full(tcount, uvs is not None)),
            mat_id=np.asarray(mat_ids, dtype=np.int32)))
        start = self._tri_count
        self._tri_count += tcount
        return [("triangle", start + i) for i in range(tcount)]

    def constant_medium_sphere(self, center: Vec, radius: float, density: float,
                               albedo: Optional[Vec] = None, tex: Optional[int] = None,
                               transform: Transform = IDENTITY):
        """medium.go:13-25 with a sphere boundary."""
        mat = self.isotropic(albedo=albedo, tex=tex)
        self._media.append(dict(kind=T.MEDIUM_SPHERE,
                                center=transform.point(center),
                                radius=float(radius), cos_t=1.0, sin_t=0.0,
                                offset=(0, 0, 0), box_min=(0, 0, 0),
                                box_max=(0, 0, 0),
                                neg_inv_density=-1.0 / density, mat_id=mat))
        return ("medium", len(self._media) - 1)

    def constant_medium_box(self, a: Vec, b: Vec, density: float,
                            albedo: Optional[Vec] = None, tex: Optional[int] = None,
                            rotate_y_deg: float = 0.0, translate: Vec = (0, 0, 0)):
        """medium.go:13-25 with a rotated/translated box boundary."""
        mat = self.isotropic(albedo=albedo, tex=tex)
        a = np.asarray(a, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        th = math.radians(rotate_y_deg)
        self._media.append(dict(kind=T.MEDIUM_BOX, center=(0, 0, 0), radius=0.0,
                                cos_t=math.cos(th), sin_t=math.sin(th),
                                offset=tuple(float(x) for x in translate),
                                box_min=tuple(np.minimum(a, b)),
                                box_max=tuple(np.maximum(a, b)),
                                neg_inv_density=-1.0 / density, mat_id=mat))
        return ("medium", len(self._media) - 1)

    # ---------------------------------------------------------------- light
    def add_light(self, handle):
        """Register a primitive in the importance-sampling list (the
        `lights` argument of Camera.Render, camera/camera.go:156)."""
        kind, idx = handle
        kmap = {"quad": T.LIGHT_QUAD, "sphere": T.LIGHT_SPHERE,
                "triangle": T.LIGHT_TRIANGLE}
        self._lights.append((kmap[kind], idx))

    # ---------------------------------------------------------------- build
    def build(self, bvh_threshold: int = BVH_THRESHOLD,
              bvh_leaf_size: int = BVH_LEAF_SIZE,
              cluster_tris: int = CLUSTER_TRIS,
              cluster2_tris: int = CLUSTER2_TRIS) -> T.Scene:
        f = lambda x: np.asarray(np.asarray(x, dtype=np.float64), np.float32)
        i32 = lambda x: np.asarray(x, dtype=np.int32)
        act = lambda rows, n: np.arange(len(rows)) < n

        sp = self._spheres or [dict(center0=np.zeros(3), center_delta=np.zeros(3),
                                    radius=1.0, mat_id=0)]
        n_sp = len(self._spheres)
        spheres = T.Spheres(
            center0=f([r["center0"] for r in sp]),
            center_delta=f([r["center_delta"] for r in sp]),
            radius=f([r["radius"] for r in sp]),
            mat_id=i32([r["mat_id"] for r in sp]), active=act(sp, n_sp))

        # quads: normal, D, w, cvw, cwu, area (objects.go:129-140)
        qd = self._quads or [dict(q=np.zeros(3), u=np.array([1.0, 0, 0]),
                                  v=np.array([0, 1.0, 0]), mat_id=0)]
        n_qd = len(self._quads)
        qs, us, vs = (np.array([r[k] for r in qd], dtype=np.float64)
                      for k in ("q", "u", "v"))
        ns = np.cross(us, vs)
        areas = np.linalg.norm(ns, axis=-1)
        normals = ns / areas[:, None]
        ws = ns / (ns * ns).sum(-1, keepdims=True)
        quads = T.Quads(
            q=f(qs), u=f(us), v=f(vs), normal=f(normals),
            d_plane=f((normals * qs).sum(-1)),
            cvw=f(np.cross(vs, ws)), cwu=f(np.cross(ws, us)), area=f(areas),
            mat_id=i32([r["mat_id"] for r in qd]), active=act(qd, n_qd))

        bx = self._boxes or [dict(lo=np.zeros(3), hi=np.ones(3), cos_t=1.0,
                                  sin_t=0.0, offset=(0.0, 0.0, 0.0), mat_id=0)]
        n_bx = len(self._boxes)
        has_rot_boxes = any(r["sin_t"] != 0.0 or r["cos_t"] != 1.0
                            for r in self._boxes)
        boxes = T.Boxes(
            lo=f([r["lo"] for r in bx]), hi=f([r["hi"] for r in bx]),
            cos_t=f([r["cos_t"] for r in bx]), sin_t=f([r["sin_t"] for r in bx]),
            offset=f([r["offset"] for r in bx]),
            mat_id=i32([r["mat_id"] for r in bx]), active=act(bx, n_bx))

        n_td = self._tri_count
        if self._tri_blocks:
            blocks = self._tri_blocks
            v = np.concatenate([blk["v"] for blk in blocks])
            has_vn = np.concatenate([blk["has_vn"] for blk in blocks])
            has_uv = np.concatenate([blk["has_uv"] for blk in blocks])
            mat_id_tri = np.concatenate([blk["mat_id"] for blk in blocks])
            vn = np.concatenate([blk["vn"] if blk["vn"] is not None
                                 else np.zeros_like(blk["v"]) for blk in blocks])
            uv = np.concatenate([blk["uv"] if blk["uv"] is not None
                                 else np.zeros(blk["v"].shape[:2] + (2,))
                                 for blk in blocks])
        else:
            v = np.asarray([[[0.0, 0, 0], [1.0, 0, 0], [0, 1.0, 0]]])
            has_vn = np.zeros(1, dtype=bool)
            has_uv = np.zeros(1, dtype=bool)
            mat_id_tri = np.zeros(1, dtype=np.int32)
            vn = np.zeros((1, 3, 3))
            uv = np.zeros((1, 3, 2))
        # The BVH is built before the triangle table so the table can be
        # permuted into leaf order: leaves, BVH8 groups and cluster groups
        # then reference contiguous rows and no traversal needs order[].
        has_tri_bvh = n_td >= bvh_threshold
        tri_light_remap = None
        if has_tri_bvh:
            fb = bvh_mod.build(v[:n_td], leaf_size=bvh_leaf_size)
            perm = fb.order[:n_td]
            inv_perm = np.empty(n_td, dtype=np.int32)
            inv_perm[perm] = np.arange(n_td, dtype=np.int32)
            tri_light_remap = inv_perm

            def permute(a):
                out = a.copy()
                out[:n_td] = a[perm]
                return out

            v, vn, uv = permute(v), permute(vn), permute(uv)
            has_vn, has_uv = permute(has_vn), permute(has_uv)
            mat_id_tri = permute(mat_id_tri)
            fb.order[:n_td] = np.arange(n_td, dtype=np.int32)
            v0_np = v[:n_td, 0]
            e0_np, e1_np = v[:n_td, 1] - v0_np, v[:n_td, 2] - v0_np
            b8 = bvh8_mod.collapse(fb.node_min, fb.node_max, fb.first,
                                   fb.count, fb.skip, v0_np, e0_np, e1_np,
                                   max_leaf=fb.leaf_size)
            cl = cl_mod.partition(fb, v0_np, e0_np, e1_np,
                                  max_tris=cluster_tris)
            cl2 = None
            if n_td * 64 <= CLUSTER2_TABLE_BYTES:
                cl2 = cl_mod.partition(fb, v0_np, e0_np, e1_np,
                                       max_tris=cluster2_tris,
                                       max_clusters=1024)
            tri_bvh = T.TriBVH(
                node_min=f(fb.node_min), node_max=f(fb.node_max),
                first=i32(fb.first), count=i32(fb.count), skip=i32(fb.skip),
                order=i32(fb.order), n_nodes=fb.n_nodes,
                leaf_size=fb.leaf_size,
                nodes8=b8.node_lines, tris8=b8.tri_lines,
                bvh8_dense=b8.dense_nodes,
                cl_lo=cl.aabb_lo, cl_hi=cl.aabb_hi, cl_gs=cl.group_start,
                cl_lines=cl.tri_lines,
                cl_boxes=cl_mod.pack_cluster_boxes(cl.aabb_lo, cl.aabb_hi),
                cl2_boxes=(None if cl2 is None else cl_mod.pack_cluster_boxes(
                    cl2.aabb_lo, cl2.aabb_hi)),
                cl2_gs=None if cl2 is None else cl2.group_start,
                cl2_lines=None if cl2 is None else cl2.tri_lines)
        else:
            tri_bvh = T.TriBVH(
                node_min=f(np.zeros((1, 3))), node_max=f(np.ones((1, 3))),
                first=i32([0]), count=i32([0]), skip=i32([1]),
                order=i32([-1]), n_nodes=1, leaf_size=1)
        v0, v1, v2 = v[:, 0], v[:, 1], v[:, 2]
        e0, e1 = v1 - v0, v2 - v0
        cn = np.cross(e0, e1)
        cn_len = np.linalg.norm(cn, axis=-1)
        n_face = cn / np.where(cn_len > 0, cn_len, 1.0)[:, None]
        vn = np.where(has_vn[:, None, None], vn, n_face[:, None, :])
        triangles = T.Triangles(
            v0=f(v0), e0=f(e0), e1=f(e1), cn=f(cn),
            c_e1v0=f(np.cross(e1, v0)), c_v0e0=f(np.cross(v0, e0)),
            k=f((v0 * cn).sum(-1)), n_face=f(n_face),
            vn=f(vn), has_vn=np.asarray(has_vn), uv=f(uv),
            has_uv=np.asarray(has_uv), area=f(cn_len / 2.0),
            mat_id=i32(mat_id_tri), active=np.arange(v.shape[0]) < n_td)

        md = self._media or [dict(kind=T.MEDIUM_SPHERE, center=(0, 0, 0), radius=1.0,
                                  cos_t=1.0, sin_t=0.0, offset=(0, 0, 0),
                                  box_min=(0, 0, 0), box_max=(1, 1, 1),
                                  neg_inv_density=-1.0, mat_id=0)]
        n_md = len(self._media)
        media = T.Media(
            kind=i32([r["kind"] for r in md]),
            center=f([r["center"] for r in md]),
            radius=f([r["radius"] for r in md]),
            cos_t=f([r["cos_t"] for r in md]), sin_t=f([r["sin_t"] for r in md]),
            offset=f([r["offset"] for r in md]),
            box_min=f([r["box_min"] for r in md]),
            box_max=f([r["box_max"] for r in md]),
            neg_inv_density=f([r["neg_inv_density"] for r in md]),
            mat_id=i32([r["mat_id"] for r in md]), active=act(md, n_md))

        mt = self._mat or [dict(kind=T.MAT_LAMBERTIAN, tex_id=0, fuzz=0.0, ref_idx=1.0)]
        materials = T.Materials(
            kind=i32([r["kind"] for r in mt]),
            tex_id=i32([r["tex_id"] for r in mt]),
            fuzz=f([r["fuzz"] for r in mt]),
            ref_idx=f([r["ref_idx"] for r in mt]))
        tx = self._tex or [dict(kind=T.TEX_SOLID, color=(0, 0, 0), inv_scale=0.0,
                                even=(0, 0, 0), odd=(0, 0, 0), scale=0.0,
                                noise_id=0, image_id=0)]
        textures = T.Textures(
            kind=i32([r["kind"] for r in tx]),
            color=f([r["color"] for r in tx]),
            inv_scale=f([r["inv_scale"] for r in tx]),
            even=f([r["even"] for r in tx]), odd=f([r["odd"] for r in tx]),
            scale=f([r["scale"] for r in tx]),
            noise_id=i32([r["noise_id"] for r in tx]),
            image_id=i32([r["image_id"] for r in tx]))

        pl = self._perlin or [perlin_mod.make_seed(np.random.default_rng(0))]
        perlin = T.Perlin(seed=np.asarray(pl, dtype=np.uint32))

        if self._images:
            hm = max(im.shape[0] for im in self._images)
            wm = max(im.shape[1] for im in self._images)
            data = np.zeros((len(self._images), hm, wm, 3), dtype=np.float32)
            wh = np.zeros((len(self._images), 2), dtype=np.int32)
            for k, im in enumerate(self._images):
                data[k, : im.shape[0], : im.shape[1]] = im
                wh[k] = (im.shape[1], im.shape[0])
        else:
            data = np.zeros((1, 1, 1, 3), dtype=np.float32)
            wh = np.ones((1, 2), dtype=np.int32)
        images = T.Images(data=f(data), wh=i32(wh))

        lt = self._lights or [(T.LIGHT_QUAD, 0)]
        if tri_light_remap is not None:
            lt = [(k, int(tri_light_remap[p]) if k == T.LIGHT_TRIANGLE else p)
                  for k, p in lt]
        lights = T.Lights(kind=i32([k for k, _ in lt]),
                          prim_id=i32([p for _, p in lt]),
                          n=len(self._lights))

        return T.Scene(
            spheres=spheres, quads=quads, triangles=triangles, media=media,
            materials=materials, textures=textures, perlin=perlin,
            images=images, lights=lights, background=f(self.background),
            tri_bvh=tri_bvh, boxes=boxes,
            has_boxes=n_bx > 0, has_rot_boxes=has_rot_boxes,
            has_tri_bvh=has_tri_bvh, has_spheres=n_sp > 0, has_quads=n_qd > 0,
            has_triangles=n_td > 0, has_media=n_md > 0,
            has_noise=any(r["kind"] in (T.TEX_PERLIN, T.TEX_MARBLE, T.TEX_TURBULENT)
                          for r in tx),
            has_checker=any(r["kind"] == T.TEX_CHECKER for r in tx),
            has_image=any(r["kind"] == T.TEX_IMAGE for r in tx),
            has_metal=any(r["kind"] == T.MAT_METAL for r in mt),
            has_dielectric=any(r["kind"] == T.MAT_DIELECTRIC for r in mt),
            has_isotropic=any(r["kind"] == T.MAT_ISOTROPIC for r in mt),
            has_quad_lights=any(k == T.LIGHT_QUAD for k, _ in lt),
            has_sphere_lights=any(k == T.LIGHT_SPHERE for k, _ in lt),
            has_tri_lights=any(k == T.LIGHT_TRIANGLE for k, _ in lt))
