"""The eight reference scenes (main.go:19-414), rebuilt on the scene
compiler. Each function returns (Scene, Camera).

The reference composes scenes with an unseeded global math/rand
(main.go:40-41 etc.), so its random layouts differ run-to-run; here layout
randomness comes from a seeded numpy Generator — parity is distributional
(SURVEY.md §6 "Hard parts").
"""

from __future__ import annotations

import numpy as np

from go_raytracer_tpu_torch.render.camera import Camera
from go_raytracer_tpu_torch.scene import assets
from go_raytracer_tpu_torch.scene.builder import SceneBuilder, Transform

# Cadence and mean-path-length hints below are the JAX package's values,
# kept so both packages walk the same windows on the same seeds; this
# package has not re-tuned them on its own hardware.


def book1(seed: int = 0):
    """Book-1 cover with extensions (main.go:19-91)."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder(background=(0.70, 0.80, 1.00))

    checker = b.checker(0.32, (0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    ground = b.lambertian(tex=checker)
    b.sphere((0, -1000, 0), 1000, ground)

    glass = b.dielectric(1.5)
    for a in range(-11, 11):
        for bb in range(-11, 11):
            mat = rng.random()
            center = np.array([a + 0.9 * rng.random(), 0.2, bb + 0.9 * rng.random()])
            if np.linalg.norm(center - np.array([4, 0.2, 0])) <= 0.9:
                continue
            if mat < 0.6:
                albedo = rng.random(3) * rng.random(3)
                m = b.lambertian(tuple(albedo))
                c2 = center + np.array([0, rng.uniform(0, 0.5), 0])
                b.sphere(tuple(center), 0.2, m, center2=tuple(c2))
            elif mat < 0.8:
                # quirk preserved: the reference creates a perlin material
                # here but never adds the sphere (main.go:52-60) — the grid
                # cell stays empty.
                pass
            elif mat < 0.95:
                albedo = rng.uniform(0.5, 1.0, 3)
                m = b.metal(tuple(albedo), rng.random())
                b.sphere(tuple(center), 0.2, m)
            else:
                b.sphere(tuple(center), 0.2, glass)

    b.sphere((0, 1, 0), 1.0, glass)
    b.sphere((-4, 1, 0), 1.0, b.lambertian((0.4, 0.2, 0.1)))
    b.sphere((4, 1, 0), 1.0, b.metal((0.7, 0.6, 0.5), 0.0))
    sun = b.sphere((0, 100, 0), 50, b.diffuse_light((5, 5, 5)))
    b.add_light(sun)

    cam = Camera(aspect_ratio=16 / 9, width=400, samples_per_pixel=100,
                 max_depth=50, vertical_fov=20, defocus_angle=0.6,
                 focus_distance=10.0, background=(0.70, 0.80, 1.00),
                 regen_cadence=1, regen_len=2.60)
    cam.position((13, 2, 3), (0, 0, 0), (0, 1, 0))
    return b.build(), cam


def book2(seed: int = 0):
    """Book-2 cover (main.go:94-174)."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder(background=(0, 0, 0))

    ground = b.lambertian((0.48, 0.83, 0.53))
    for i in range(20):
        for j in range(20):
            w = 100.0
            x0, z0 = -1000.0 + i * w, -1000.0 + j * w
            y1 = rng.uniform(1, 101)
            b.box((x0, 0.0, z0), (x0 + w, y1, z0 + w), ground)

    light = b.quad((123, 554, 147), (300, 0, 0), (0, 0, 265),
                   b.diffuse_light((7, 7, 7)))
    b.add_light(light)

    b.sphere((400, 400, 200), 50, b.lambertian((0.7, 0.3, 0.1)),
             center2=(430, 400, 200))
    b.sphere((260, 150, 45), 50, b.dielectric(1.5))
    b.sphere((0, 150, 145), 50, b.metal((0.8, 0.8, 0.9), 1.0))

    # water orb: dielectric boundary + interior medium (main.go:134-136)
    b.sphere((360, 150, 145), 70, b.dielectric(1.5))
    b.constant_medium_sphere((360, 150, 145), 70, 0.2, albedo=(0.2, 0.4, 0.9))
    # global fog (main.go:139-140) — unlike the water orb, the fog's
    # boundary sphere is NOT itself added to the world; only the medium is
    b.constant_medium_sphere((0, 0, 0), 5000, 0.0001, albedo=(1, 1, 1))

    earth_tex = b.image_texture(assets.load_image("earthmap.jpg"))
    b.sphere((400, 200, 400), 100, b.lambertian(tex=earth_tex))
    marble = b.noise_texture(0.2, "marble")
    b.sphere((220, 280, 300), 80, b.lambertian(tex=marble))

    white = b.lambertian((0.73, 0.73, 0.73))
    tr = Transform(rotate_y_deg=15.0, translate=(-100, 270, 395))
    for _ in range(1000):
        b.sphere(tuple(rng.uniform(0, 165, 3)), 10, white, transform=tr)

    cam = Camera(aspect_ratio=1.0, width=800, samples_per_pixel=100,
                 max_depth=40, vertical_fov=40, defocus_angle=0.0,
                 background=(0, 0, 0),
                 regen_cadence=1, regen_len=5.08)
    cam.position((478, 278, -600), (278, 278, 0), (0, 1, 0))
    return b.build(), cam


def _cornell_walls(b: SceneBuilder):
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    green = b.lambertian((0.12, 0.45, 0.15))
    light = b.diffuse_light((15, 15, 15))
    b.quad((555, 0, 0), (0, 555, 0), (0, 0, 555), green)
    b.quad((0, 0, 0), (0, 555, 0), (0, 0, 555), red)
    b.quad((0, 0, 0), (555, 0, 0), (0, 0, 555), white)
    b.quad((555, 555, 555), (-555, 0, 0), (0, 0, -555), white)
    b.quad((0, 0, 555), (555, 0, 0), (0, 555, 0), white)
    light_quad = b.quad((343, 550, 332), (-130, 0, 0), (0, 0, -105), light)
    return white, light_quad


def book3():
    """Book-3 cover: Cornell box + glass sphere (main.go:177-218); the
    lights list holds the ceiling quad AND the glass sphere (main.go:193-204)."""
    b = SceneBuilder(background=(0, 0, 0))
    white, light_quad = _cornell_walls(b)
    b.add_light(light_quad)

    b.box((0, 0, 0), (165, 330, 165), white,
          transform=Transform(rotate_y_deg=15, translate=(265, 0, 295)))
    s = b.sphere((190, 90, 190), 90, b.dielectric(1.5))
    b.add_light(s)

    cam = Camera(aspect_ratio=1.0, width=600, samples_per_pixel=10,
                 max_depth=50, vertical_fov=40, background=(0, 0, 0),
                 regen_cadence=8, regen_len=5.54)
    cam.position((278, 278, -800), (278, 278, 0), (0, 1, 0))
    return b.build(), cam


def quads_scene():
    """Five-quad showcase (main.go:220-247)."""
    b = SceneBuilder(background=(0.70, 0.80, 1.00))
    earth = b.lambertian(tex=b.image_texture(assets.load_image("earthmap.jpg")))
    back_light = b.diffuse_light((3, 3, 3))
    perlin = b.lambertian(tex=b.noise_texture(5, "marble"))
    metal = b.metal((0.8, 0.6, 0.2), 0.0)
    teal = b.lambertian((0.2, 0.8, 0.8))

    b.quad((-3, -2, 5), (0, 0, -4), (0, 4, 0), earth)
    light = b.quad((-2, -2, 0), (4, 0, 0), (0, 4, 0), back_light)
    b.quad((3, -2, 1), (0, 0, 4), (0, 4, 0), perlin)
    b.quad((-2, 3, 1), (4, 0, 0), (0, 0, 4), metal)
    b.quad((-2, -3, 5), (4, 0, 0), (0, 0, -4), teal)
    b.add_light(light)

    cam = Camera(aspect_ratio=1.0, width=400, samples_per_pixel=100,
                 max_depth=50, vertical_fov=80, background=(0.70, 0.80, 1.00),
                 regen_cadence=1, regen_len=1.47)
    cam.position((0, 0, 9), (0, 0, 0), (0, 1, 0))
    return b.build(), cam


def simple_light():
    """Marble spheres + quad/sphere lights (main.go:249-275). Only the quad
    is importance-sampled (Render is passed the bare quad, main.go:274)."""
    b = SceneBuilder(background=(0, 0, 0))
    marble = b.noise_texture(4, "marble")
    lamb = b.lambertian(tex=marble)
    light = b.diffuse_light((4, 4, 4))

    b.sphere((0, -1000, 0), 1000, lamb)
    b.sphere((0, 7, 0), 2, light)
    q = b.quad((3, 1, -2), (2, 0, 0), (0, 2, 0), light)
    b.sphere((0, 2, 0), 2, lamb)
    b.add_light(q)

    cam = Camera(aspect_ratio=16 / 9, width=400, samples_per_pixel=100,
                 max_depth=50, vertical_fov=20, background=(0, 0, 0),
                 regen_cadence=1, regen_len=1.69)
    cam.position((26, 3, 6), (0, 2, 0), (0, 1, 0))
    return b.build(), cam


def cornell_box():
    """The classic Cornell box (main.go:278-320)."""
    b = SceneBuilder(background=(0, 0, 0))
    white, light_quad = _cornell_walls(b)
    b.add_light(light_quad)

    b.box((0, 0, 0), (165, 330, 165), white,
          transform=Transform(rotate_y_deg=15, translate=(265, 0, 295)))
    b.box((0, 0, 0), (165, 165, 165), white,
          transform=Transform(rotate_y_deg=-18, translate=(130, 0, 65)))

    cam = Camera(aspect_ratio=1.0, width=600, samples_per_pixel=100,
                 max_depth=50, vertical_fov=40, background=(0, 0, 0),
                 regen_cadence=8, regen_len=2.93)
    cam.position((278, 278, -800), (278, 278, 0), (0, 1, 0))
    return b.build(), cam


def cornell_smoke():
    """Cornell box with smoke boxes (main.go:323-367)."""
    b = SceneBuilder(background=(0, 0, 0))
    _, light_quad = _cornell_walls(b)
    b.add_light(light_quad)

    b.constant_medium_box((0, 0, 0), (165, 330, 165), 0.01, albedo=(0, 0, 0),
                          rotate_y_deg=15, translate=(265, 0, 295))
    b.constant_medium_box((0, 0, 0), (165, 165, 165), 0.01, albedo=(1, 1, 1),
                          rotate_y_deg=-18, translate=(130, 0, 65))

    cam = Camera(aspect_ratio=1.0, width=600, samples_per_pixel=10,
                 max_depth=50, vertical_fov=40, background=(0, 0, 0),
                 regen_cadence=4, regen_len=2.91)
    cam.position((278, 278, -800), (278, 278, 0), (0, 1, 0))
    return b.build(), cam


def model_example(obj_path: str = "dragon.obj"):
    """Gold statue on a gray ground (main.go:371-409). Loads the OBJ if
    present; otherwise substitutes a procedural high-poly statue so the
    scene renders standalone."""
    from go_raytracer_tpu_torch.scene import obj_loader

    b = SceneBuilder(background=(0, 0, 0))
    b.sphere((0, -1000, 0), 1000, b.lambertian((0.4, 0.4, 0.4)))

    default_mat = b.metal((255 / 255, 215 / 255, 0.0), 0.5)
    opts = obj_loader.LoadOptions(scale_factor=5.0, center=True,
                                  position=(0, 1.8, 0),
                                  default_material=default_mat)
    try:
        path = assets.find_asset(obj_path)
        light_handles = obj_loader.load_obj(b, path, opts,
                                            transform=Transform(rotate_y_deg=180))
    except FileNotFoundError:
        light_handles = obj_loader.procedural_statue(
            b, default_mat, opts, transform=Transform(rotate_y_deg=180))

    sun = b.sphere((7, 13, 7), 5, b.diffuse_light((4, 4, 4)))
    for h in light_handles:
        b.add_light(h)
    b.add_light(sun)

    cam = Camera(aspect_ratio=16 / 9, width=600, samples_per_pixel=250,
                 max_depth=50, vertical_fov=40, background=(0, 0, 0),
                 max_contribution=2.0, defocus_angle=0.1,
                 regen_cadence=1)
    cam.position((10, 5, 10), (0, 0, 0), (0, 1, 0))
    return b.build(), cam


SCENES = {
    1: ("book1", book1),
    2: ("book2", book2),
    3: ("book3", book3),
    4: ("simpleLight", simple_light),
    5: ("quads", quads_scene),
    6: ("cornellBox", cornell_box),
    7: ("cornellSmoke", cornell_smoke),
    8: ("modelExample", model_example),
}


def get_scene(num_or_name):
    """Look up by the reference's -S number (main.go:449-476) or by name."""
    if isinstance(num_or_name, int) or str(num_or_name).isdigit():
        name, fn = SCENES[int(num_or_name)]
        return name, fn
    for _, (name, fn) in SCENES.items():
        if name.lower() == str(num_or_name).lower():
            return name, fn
    raise KeyError(f"unknown scene {num_or_name!r}")
