"""Compiled scene: flat SoA tables as plain dataclasses of numpy arrays.

The scene compiler (scene/builder.py) flattens the reference's `Hittable`
tree (hittable/hittable.go:60-65) into fixed-shape struct-of-arrays tables:
transforms baked into coordinates, boxes fused into slab rows, materials and
textures as integer-indexed tables. The tables stay on the host; the kernel
side (ops/bounce.pack_scene) joins them into the dense rows the device
kernels read, and moves only those to the device.

Every table is padded to at least one row with `active=False` so shapes are
never empty. Field names and layouts match the JAX package's tables, so a
scene built by either package can be handed to the other
(`scene_from_numpy`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# Material kinds (hittable/materials.go:11-177)
MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
MAT_DIFFUSE_LIGHT = 3
MAT_ISOTROPIC = 4

# Texture kinds (hittable/texture.go:14-125)
TEX_SOLID = 0
TEX_CHECKER = 1
TEX_IMAGE = 2
TEX_PERLIN = 3
TEX_MARBLE = 4
TEX_TURBULENT = 5

# Light kinds for the light-importance-sampling tables (hittable/pdf.go:42-56)
LIGHT_QUAD = 0
LIGHT_SPHERE = 1
LIGHT_TRIANGLE = 2

# Participating-medium boundary kinds (hittable/medium.go:13-62)
MEDIUM_SPHERE = 0
MEDIUM_BOX = 1


@dataclasses.dataclass
class Spheres:
    """Sphere table (hittable/objects.go:14-115); motion blur as
    center(t) = center0 + t * center_delta (objects.go:30-37)."""

    center0: np.ndarray       # (S, 3)
    center_delta: np.ndarray  # (S, 3)
    radius: np.ndarray        # (S,)
    mat_id: np.ndarray        # (S,) int32
    active: np.ndarray        # (S,) bool

    @property
    def count(self) -> int:
        return self.radius.shape[0]


@dataclasses.dataclass
class Quads:
    """Quad table (hittable/objects.go:117-206) with the precomputed
    cvw = v x w and cwu = w x u, so alpha = p . cvw and beta = p . cwu."""

    q: np.ndarray        # (Q, 3) corner
    u: np.ndarray        # (Q, 3) edge 1
    v: np.ndarray        # (Q, 3) edge 2
    normal: np.ndarray   # (Q, 3) unit normal
    d_plane: np.ndarray  # (Q,)   plane D = normal . q
    cvw: np.ndarray      # (Q, 3)
    cwu: np.ndarray      # (Q, 3)
    area: np.ndarray     # (Q,)
    mat_id: np.ndarray   # (Q,) int32
    active: np.ndarray   # (Q,) bool

    @property
    def count(self) -> int:
        return self.area.shape[0]


@dataclasses.dataclass
class Boxes:
    """Fused box rows: the six quads of a box (objects.go:208-240) as one
    slab test, in object space with a rotate-Y + translate row
    (transformation.go); axis-aligned rows carry the identity rotation."""

    lo: np.ndarray      # (B, 3) object-space min
    hi: np.ndarray      # (B, 3) object-space max
    cos_t: np.ndarray   # (B,)
    sin_t: np.ndarray   # (B,)
    offset: np.ndarray  # (B, 3)
    mat_id: np.ndarray  # (B,) int32
    active: np.ndarray  # (B,) bool

    @property
    def count(self) -> int:
        return self.mat_id.shape[0]


@dataclasses.dataclass
class Triangles:
    """Triangle table (hittable/objects.go:242-465) with the factored
    Moller-Trumbore precomputes. A mesh large enough for a triangle BVH
    is stored in BVH leaf order, so leaves, BVH8 groups and cluster groups
    all index this table directly."""

    v0: np.ndarray
    e0: np.ndarray
    e1: np.ndarray
    cn: np.ndarray
    c_e1v0: np.ndarray
    c_v0e0: np.ndarray
    k: np.ndarray
    n_face: np.ndarray
    vn: np.ndarray
    has_vn: np.ndarray
    uv: np.ndarray
    has_uv: np.ndarray
    area: np.ndarray
    mat_id: np.ndarray
    active: np.ndarray

    @property
    def count(self) -> int:
        return self.area.shape[0]


@dataclasses.dataclass
class Media:
    """Constant-density media (hittable/medium.go:13-62) with analytic
    sphere or rotated-box boundaries."""

    kind: np.ndarray             # (M,) int32 MEDIUM_*
    center: np.ndarray           # (M, 3)
    radius: np.ndarray           # (M,)
    cos_t: np.ndarray            # (M,)
    sin_t: np.ndarray            # (M,)
    offset: np.ndarray           # (M, 3)
    box_min: np.ndarray          # (M, 3)
    box_max: np.ndarray          # (M, 3)
    neg_inv_density: np.ndarray  # (M,)
    mat_id: np.ndarray           # (M,) int32
    active: np.ndarray           # (M,) bool

    @property
    def count(self) -> int:
        return self.kind.shape[0]


@dataclasses.dataclass
class Materials:
    """Material table (hittable/materials.go); attenuation always routes
    through the texture table."""

    kind: np.ndarray     # (K,) int32 MAT_*
    tex_id: np.ndarray   # (K,) int32
    fuzz: np.ndarray     # (K,)
    ref_idx: np.ndarray  # (K,)

    @property
    def count(self) -> int:
        return self.kind.shape[0]


@dataclasses.dataclass
class Textures:
    """Texture table (hittable/texture.go:14-125)."""

    kind: np.ndarray       # (X,) int32 TEX_*
    color: np.ndarray      # (X, 3)
    inv_scale: np.ndarray  # (X,)
    even: np.ndarray       # (X, 3)
    odd: np.ndarray        # (X, 3)
    scale: np.ndarray      # (X,)
    noise_id: np.ndarray   # (X,) int32
    image_id: np.ndarray   # (X,) int32

    @property
    def count(self) -> int:
        return self.kind.shape[0]


@dataclasses.dataclass
class Perlin:
    """Per-noise-texture seeds of the hash-gradient noise (scene/perlin.py)."""

    seed: np.ndarray  # (P,) uint32

    @property
    def count(self) -> int:
        return self.seed.shape[0]


@dataclasses.dataclass
class Images:
    """Decoded image textures padded to a common (Hmax, Wmax)."""

    data: np.ndarray  # (I, Hmax, Wmax, 3) float32 in [0, 1]
    wh: np.ndarray    # (I, 2) int32 (width, height)

    @property
    def count(self) -> int:
        return self.data.shape[0]


@dataclasses.dataclass
class Lights:
    """Light-sampling list (hittable/hittable.go:89-103): rows reference
    primitive tables; `n` is the live count for the 1/K mixture weight."""

    kind: np.ndarray     # (L,) int32 LIGHT_*
    prim_id: np.ndarray  # (L,) int32
    n: int = 0

    @property
    def count(self) -> int:
        return self.kind.shape[0]


@dataclasses.dataclass
class TriBVH:
    """Flattened skip-link BVH over the triangle table (scene/bvh.py),
    its 8-wide collapse (scene/bvh8.py) and its cluster partition
    (scene/clusters.py). A scene without a mesh BVH carries a one-node
    placeholder and None for the derived tables."""

    node_min: np.ndarray  # (M, 3)
    node_max: np.ndarray  # (M, 3)
    first: np.ndarray     # (M,) int32
    count: np.ndarray     # (M,) int32 (0 = inner node)
    skip: np.ndarray      # (M,) int32
    order: np.ndarray     # (Tp,) int32 triangle ids, -1 padding
    n_nodes: int = 1
    leaf_size: int = 1
    # 8-wide collapse for the stack walk (ops/traverse8.py)
    nodes8: Optional[np.ndarray] = None   # packed (R, 128) float32 lines
    tris8: Optional[np.ndarray] = None    # packed (R2, 128) float32 lines
    bvh8_dense: bool = False
    # cluster partition for the binned intersector (ops/trace.binned_closest)
    cl_lo: Optional[np.ndarray] = None     # (K, 3) cluster box min
    cl_hi: Optional[np.ndarray] = None     # (K, 3) cluster box max
    cl_gs: Optional[np.ndarray] = None     # (K + 1,) int32 group offsets
    cl_lines: Optional[np.ndarray] = None  # packed triangle-group lines
    cl_boxes: Optional[np.ndarray] = None  # packed cluster-box lines
    # the finer partition of the persistent-block intersector
    # (ops/stream2.py); None for a mesh above the builder's table budget
    cl2_boxes: Optional[np.ndarray] = None
    cl2_gs: Optional[np.ndarray] = None
    cl2_lines: Optional[np.ndarray] = None


@dataclasses.dataclass
class Scene:
    """The complete compiled scene; `has_*` are the static capability
    flags that select kernel code paths."""

    spheres: Spheres
    quads: Quads
    triangles: Triangles
    media: Media
    materials: Materials
    textures: Textures
    perlin: Perlin
    images: Images
    lights: Lights
    background: np.ndarray  # (3,)
    tri_bvh: Optional[TriBVH] = None
    boxes: Optional[Boxes] = None
    has_boxes: bool = False
    has_rot_boxes: bool = False
    has_spheres: bool = True
    has_tri_bvh: bool = False
    has_quads: bool = True
    has_triangles: bool = False
    has_media: bool = False
    has_noise: bool = False
    has_checker: bool = False
    has_image: bool = False
    has_metal: bool = True
    has_dielectric: bool = True
    has_isotropic: bool = True
    has_quad_lights: bool = True
    has_sphere_lights: bool = True
    has_tri_lights: bool = False


_TABLES = {"spheres": Spheres, "quads": Quads, "triangles": Triangles,
           "media": Media, "materials": Materials, "textures": Textures,
           "perlin": Perlin, "images": Images, "lights": Lights,
           "tri_bvh": TriBVH, "boxes": Boxes}


def scene_from_numpy(other) -> Scene:
    """Carry a scene built elsewhere (any object with this module's field
    names whose leaves convert with `np.asarray`, e.g. the JAX package's
    `Scene`) across as this package's `Scene` of numpy arrays. Static
    fields (`Lights.n`, `TriBVH.n_nodes`, the `has_*` flags) are copied
    as they are; fields this package does not model are dropped."""
    kw = {}
    for f in dataclasses.fields(Scene):
        val = getattr(other, f.name, None)
        cls = _TABLES.get(f.name)
        if cls is not None and val is not None:
            sub = {}
            for g in dataclasses.fields(cls):
                x = getattr(val, g.name)
                sub[g.name] = x if x is None or isinstance(x, (int, bool)) \
                    else np.asarray(x)
            val = cls(**sub)
        elif f.name == "background":
            val = np.asarray(val)
        kw[f.name] = val
    return Scene(**kw)
