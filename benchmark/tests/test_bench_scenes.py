"""Each configuration builds the scene the registry builds (so a cell
measures what `-S 6` and `-S 8` render), and the benchmark's copy of the
statue's formula makes the program's 65,536 triangles."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import scenes
from benchmark.reference import pathtrace as pt
from benchmark.reference.statue import statue_triangles
from go_raytracer_tpu_torch.scene import obj_loader
from go_raytracer_tpu_torch.scene.builder import SceneBuilder, Transform
from go_raytracer_tpu_torch.scenes import registry

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _same(a, b, path=""):
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path
    else:
        assert a == b, path


@pytest.mark.parametrize("name,fn", [("cornellBox", registry.cornell_box),
                                     ("modelExample", registry.model_example)])
def test_config_builds_the_registry_scene(name, fn):
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    scene, cam = scenes.build(cfg)
    want_scene, want_cam = fn()
    _same(scene, want_scene)
    assert cam == want_cam


def test_statue_copy_is_the_ports_statue():
    opts = obj_loader.LoadOptions(scale_factor=5.0, center=True,
                                  position=(0, 1.8, 0), default_material=0)
    b = SceneBuilder()
    b.metal((1, 1, 1), 0.5)
    obj_loader.procedural_statue(b, 0, opts)
    port = b._tri_blocks[0]["v"]
    ours = statue_triangles(256, 128, 5.0, True, (0, 1.8, 0))
    assert ours.shape == (65536, 3, 3)
    np.testing.assert_array_equal(ours, port)


def test_reference_triangles_are_the_programs():
    cfg = json.loads((CONFIGS / "modelExample.json").read_text())
    scene, _ = scenes.build(cfg)
    ob = next(o for o in cfg["objects"] if o["kind"] == "mesh")
    v = pt.mesh_vertices(cfg["mesh"], ob)
    tr = scene.triangles
    n = v.shape[0]
    assert n == 65536 and int(tr.active.sum()) == n
    assert len(pt.Scene(cfg, "cpu").tris["groups"]) == 64

    # the program keeps its triangles in its BVH's order: compare the two
    # sets of (v0, e0, e1) rows, each sorted
    def rows(v0, e0, e1):
        m = np.concatenate([np.asarray(v0), np.asarray(e0), np.asarray(e1)],
                           1).astype(np.float32)
        return m[np.lexsort(m.T[::-1])]

    np.testing.assert_array_equal(
        rows(v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]),
        rows(tr.v0[:n], tr.e0[:n], tr.e1[:n]))


def test_config_transform_is_the_builders():
    p = np.array([[1.0, 2.0, 3.0], [-4.0, 0.5, 9.0]])
    tr = Transform(rotate_y_deg=-18.0, translate=(130, 0, 65))
    want = np.stack([tr.point(x) for x in p])
    from benchmark.reference.statue import rotate_y
    np.testing.assert_allclose(rotate_y(p, -18.0) + [130, 0, 65], want, atol=1e-12)
    assert torch.is_tensor(pt.Scene(json.loads(
        (CONFIGS / "cornellBox.json").read_text()), "cpu").boxes["lo"])
