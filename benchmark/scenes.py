"""A configuration file's scene built through the program's public scene
compiler (`scene/builder.SceneBuilder`) and camera, so that each cell
renders the scene that users of `-S 6` or `-S 8` get: one builder call
per material and object, in the file's order. The statue's triangles
come from the benchmark's own copy of its formula
(`reference/statue.py`), the same triangles the reference reads.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.reference.pathtrace import mesh_vertices


def build(cfg: dict, camera_overrides: dict | None = None):
    """(scene, camera) of the program for configuration `cfg`."""
    from go_raytracer_tpu_torch.render.camera import Camera
    from go_raytracer_tpu_torch.scene.builder import SceneBuilder, Transform

    b = SceneBuilder(background=tuple(cfg["background"]))
    mats = {}
    for m in cfg["materials"]:
        if m["kind"] == "lambertian":
            mats[m["name"]] = b.lambertian(tuple(m["color"]))
        elif m["kind"] == "metal":
            mats[m["name"]] = b.metal(tuple(m["color"]), m["fuzz"])
        elif m["kind"] == "diffuse_light":
            mats[m["name"]] = b.diffuse_light(tuple(m["color"]))
        else:
            raise ValueError(f"unknown material kind {m['kind']!r}")
    lights = []
    for ob in cfg["objects"]:
        mat = mats[ob["material"]]
        tr = Transform(rotate_y_deg=float(ob.get("rotate_y_deg", 0.0)),
                       translate=tuple(ob.get("translate", (0.0, 0.0, 0.0))))
        if ob["kind"] == "quad":
            handle = b.quad(tuple(ob["q"]), tuple(ob["u"]), tuple(ob["v"]), mat)
        elif ob["kind"] == "box":
            handle = b.box(tuple(ob["a"]), tuple(ob["b"]), mat, transform=tr)
        elif ob["kind"] == "sphere":
            handle = b.sphere(tuple(ob["center"]), ob["radius"], mat)
        elif ob["kind"] == "mesh":
            # the object-space triangles, turned by the builder as the
            # loader's instance transform is
            v = mesh_vertices(cfg["mesh"], {})
            b.add_mesh(v, np.full(v.shape[0], mat, dtype=np.int32),
                       transform=tr)
            handle = None
        else:
            raise ValueError(f"unknown object kind {ob['kind']!r}")
        if ob.get("light"):
            lights.append(handle)
    for h in lights:
        b.add_light(h)
    cam_cfg = dict(cfg["camera"], **(camera_overrides or {}))
    names = {f.name for f in dataclasses.fields(Camera)}
    cam = Camera(**{k: (tuple(v) if isinstance(v, list) else v)
                    for k, v in cam_cfg.items() if k in names})
    return b.build(), cam
