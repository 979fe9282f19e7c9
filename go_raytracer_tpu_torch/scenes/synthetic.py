"""A dense test scene for the closest-hit scan of the fused bounce kernels,
at any table size up to ops/bounce.MAX_PRIMS rows.

Not a reference scene: the kernels' tests and chip_smoke.py build it to
hold the staged scan (csrc/bounce_core.cuh) against the plain version on
what the registry scenes lack: a sphere section larger than a block's
staging budget, quads and boxes past it, and two spheres at the same
place with different materials, where the first declared must win.

`scan_scene` fills a builder given to it (this package's `SceneBuilder`,
or any object with its methods, such as the JAX package's in the tests),
so both packages can build the same scene from the same seed:

* spheres 0 and 1: the coincident pair, radius 2 at (0, 50, 0): diffuse
  lights of colour TIE_FIRST and TIE_SECOND, seen by the camera
  (`CAMERA`) and by nothing else, so a primary ray that meets them emits
  the first one's colour (with `moving_pair` the second one moves away
  from the first over the ray time: the tie scene);
* with `dielectric`, a hollow glass sphere (radius 1.2 and -1.0, the
  inner one's negative radius flipping its normal);
* the rest of the spheres radius 0.15-0.4 over a 24 x 24 floor, about a
  third of them moving (a centre delta in y), lambertian or metal with a
  fuzz; then the ground sphere (radius 1000);
* `n_quad` quads (the last one the quad light above the floor) and
  `n_box` rotated boxes, lambertian.

`inactive_rows` names rows of the packed table to clear to kind -1 as
`pack_scene` writes inactive rows: every INACTIVE_EVERY-th row of each
section, the pair, the glass and the light left active.
"""

from __future__ import annotations

import numpy as np

TIE_FIRST = (4.0, 0.5, 0.25)
TIE_SECOND = (0.25, 0.5, 4.0)
INACTIVE_EVERY = 11
# looking at the coincident pair from 20 units away, its disk filling the
# middle of the frame
CAMERA = dict(aspect_ratio=1.0, width=32, samples_per_pixel=16,
              max_depth=50, vertical_fov=8.0, background=(0.5, 0.6, 0.7),
              look_from=(0.0, 50.0, 20.0), look_at=(0.0, 50.0, 0.0))


def scan_scene(b, transform, n_sph: int, n_quad: int = 2, n_box: int = 1,
               seed: int = 0, dielectric: bool = True,
               moving_pair: bool = False):
    """Fill builder `b` (background CAMERA["background"]) with `n_sph`
    spheres (at least 4, or 6 with `dielectric`), `n_quad` quads (at
    least 1: the light) and `n_box` boxes; `transform` is the builder's
    package's Transform class. With `moving_pair` the pair's second sphere
    moves from the first's place (at ray time 0) down to (0, 10, 0) (at
    time 1): the tie scene, where the kernels' scan order (the Morton order
    of the spheres' swept boxes) puts the second before the first, and the
    rays at time 0 must still take the first. Returns b.build()."""
    rs = np.random.default_rng(seed)
    first = b.sphere((0.0, 50.0, 0.0), 2.0, b.diffuse_light(TIE_FIRST))
    b.sphere((0.0, 50.0, 0.0), 2.0, b.diffuse_light(TIE_SECOND),
             center2=(0.0, 10.0, 0.0) if moving_pair else None)
    n_fixed = 3
    if dielectric:
        glass = b.dielectric(1.5)
        b.sphere((3.0, 1.2, -2.0), 1.2, glass)
        b.sphere((3.0, 1.2, -2.0), -1.0, glass)
        n_fixed += 2
    assert first[1] == 0 and n_sph >= n_fixed + 1 and n_quad >= 1
    for _ in range(n_sph - n_fixed):
        c = (rs.uniform(-12, 12), rs.uniform(0.2, 3.0), rs.uniform(-12, 12))
        if rs.random() < 0.6:
            m = b.lambertian(tuple(rs.uniform(0.1, 0.9, 3)))
        else:
            m = b.metal(tuple(rs.uniform(0.5, 1.0, 3)), rs.uniform(0, 0.5))
        c2 = (c[0], c[1] + rs.uniform(0, 0.5), c[2]) \
            if rs.random() < 0.35 else None
        b.sphere(c, rs.uniform(0.15, 0.4), m, center2=c2)
    b.sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian((0.5, 0.5, 0.5)))
    for _ in range(n_quad - 1):
        q = (rs.uniform(-12, 12), rs.uniform(0, 3), rs.uniform(-12, 12))
        u = tuple(rs.normal(size=3) * 1.5)
        v = tuple(rs.normal(size=3) * 1.5)
        b.quad(q, u, v, b.lambertian(tuple(rs.uniform(0.1, 0.9, 3))))
    for _ in range(n_box):
        s = rs.uniform(0.3, 1.5, 3)
        tr = transform(rotate_y_deg=float(rs.uniform(-90, 90)),
                       translate=(rs.uniform(-12, 12), 0.0,
                                  rs.uniform(-12, 12)))
        b.box((0, 0, 0), tuple(s), b.lambertian(
            tuple(rs.uniform(0.1, 0.9, 3))), transform=tr)
    b.add_light(b.quad((-3.0, 8.0, -3.0), (6.0, 0.0, 0.0), (0.0, 0.0, 6.0),
                       b.diffuse_light((6.0, 6.0, 6.0))))
    return b.build()


def inactive_rows(statics, dielectric: bool = True) -> list:
    """Rows of the packed primitive table to clear to kind -1: every
    INACTIVE_EVERY-th row of each section from its second on, except the
    coincident pair, the glass spheres and the light (the last quad)."""
    rows = []
    for base, first, count in (
            (statics["sph_base"], 4 if dielectric else 2, statics["n_sph"]),
            (statics["quad_base"], 1, statics["n_quad"] - 1),
            (statics["box_base"], 1, statics["n_box"])):
        rows += [base + k for k in range(first, count, INACTIVE_EVERY)]
    return rows


def clear_rows(prims: np.ndarray, rows) -> np.ndarray:
    """A copy of the packed table with `rows` written as `pack_scene`
    writes an inactive row: every column -1."""
    out = np.array(prims, dtype=np.float32, copy=True)
    out[list(rows)] = -1.0
    return out


def build(n_sph: int, n_quad: int = 2, n_box: int = 1, seed: int = 0,
          dielectric: bool = True, moving_pair: bool = False):
    """The scan scene on this package's builder, with its camera (CAMERA)
    and its packed tables (`pack_scene`, numpy) with the inactive rows
    cleared: (scene, camera, tables, statics)."""
    from go_raytracer_tpu_torch.ops import bounce
    from go_raytracer_tpu_torch.render.camera import Camera
    from go_raytracer_tpu_torch.scene.builder import SceneBuilder, Transform

    scene = scan_scene(SceneBuilder(background=CAMERA["background"]),
                       Transform, n_sph, n_quad, n_box, seed=seed,
                       dielectric=dielectric, moving_pair=moving_pair)
    cam = Camera(**{k: v for k, v in CAMERA.items()
                    if k not in ("look_from", "look_at")})
    cam.position(CAMERA["look_from"], CAMERA["look_at"], (0, 1, 0))
    statics = bounce.scene_statics(scene)
    prims, *rest = bounce.pack_scene(scene)
    prims = clear_rows(prims, inactive_rows(statics, dielectric))
    return scene, cam, (prims, *rest), statics


def lane_state(n: int, seed: int = 0) -> list:
    """A mixed lane state of rays among the scan scene's primitives, as the
    fused kernels take it (numpy): origins over the floor, normal-random
    directions, ray times, 60% of the lanes alive, depths 0-49."""
    rs = np.random.default_rng(seed)
    o = np.stack([rs.uniform(-12, 12, n), rs.uniform(0.3, 4, n),
                  rs.uniform(-12, 12, n)], axis=1).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    return [np.ascontiguousarray(x) for x in (
        o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
        rs.uniform(0, 1, n).astype(np.float32),
        (rs.uniform(size=n) < 0.6).astype(np.int32),
        rs.integers(0, 50, n).astype(np.int32))]


# --------------------------------------------------------------------------
# the external-hit bounce's test meshes (ops/bounce.bounce with ext planes)
# --------------------------------------------------------------------------

def glass_fog_statue(b, obj_loader, transform_cls):
    """Fill builder `b` with scene 8 (modelExample: the ground sphere, the
    procedural statue in gold metal, the sun; scenes/registry.py) and two
    materials its mesh path does not otherwise meet: a glass sphere
    beside the statue and a fog sphere medium around the pair. `obj_loader`
    and `transform_cls` come from the same package as `b` (this package's
    `scene/obj_loader` and `scene/builder.Transform`, or the JAX
    package's), so both packages build the same scene. Returns the camera
    position (look-from, look-at) of modelExample."""
    b.sphere((0, -1000, 0), 1000, b.lambertian((0.4, 0.4, 0.4)))
    gold = b.metal((1.0, 215 / 255, 0.0), 0.5)
    opts = obj_loader.LoadOptions(scale_factor=5.0, center=True,
                                  position=(0, 1.8, 0), default_material=gold)
    lights = obj_loader.procedural_statue(
        b, gold, opts, transform=transform_cls(rotate_y_deg=180))
    b.sphere((3.0, 1.5, 2.0), 1.5, b.dielectric(1.5))
    b.constant_medium_sphere((1.0, 2.0, 1.0), 4.5, 0.05, (0.9, 0.9, 0.9))
    sun = b.sphere((7, 13, 7), 5, b.diffuse_light((4, 4, 4)))
    for h in lights:
        b.add_light(h)
    b.add_light(sun)
    return (10, 5, 10), (0, 0, 0)


IMAGE_MESH_TRIS = 64


def image_mesh(b, seed: int = 5):
    """Fill builder `b` with an image-textured triangle mesh (an 8 x 8
    ramp image, every triangle's vertex uv (0, 0), (1, 0), (0, 1)), a quad
    light above it and a ground sphere (the scene of the JAX package's
    tests/test_mesh_ext.py image-mesh case). Build it with
    bvh_threshold=1, so the mesh has a BVH."""
    img = np.linspace(0, 1, 8 * 8 * 3, dtype=np.float32).reshape(8, 8, 3)
    mat = b.lambertian(tex=b.image_texture(img))
    rng = np.random.default_rng(seed)
    tris, uvs = [], []
    for _ in range(IMAGE_MESH_TRIS):
        v0 = rng.uniform(-3, 3, 3)
        tris.append((v0, v0 + rng.uniform(0.2, 1.5, 3),
                     v0 + rng.uniform(0.2, 1.5, 3)))
        uvs.append(((0, 0), (1, 0), (0, 1)))
    b.add_mesh(np.asarray(tris), np.full(IMAGE_MESH_TRIS, mat, np.int32),
               uvs=np.asarray(uvs), has_uv=np.ones(IMAGE_MESH_TRIS, bool))
    b.add_light(b.quad((-1, 6, -1), (2, 0, 0), (0, 0, 2),
                       b.diffuse_light((4, 4, 4))))
    b.sphere((0, -1003.6, 0), 1000.0, b.lambertian((0.4, 0.4, 0.4)))
