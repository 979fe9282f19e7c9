"""The port's mesh scene compiler against the JAX package: the binary BVH,
its 8-wide collapse, the cluster partition, the OBJ loader and scene 8's
tables must be identical (exact equality, same dtypes and shapes), and a
JAX scene carried across by `scene_from_numpy` must equal the port's own."""

import dataclasses
import os

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest
import torch

from go_raytracer_tpu.ops.pallas import bounce as jpb
from go_raytracer_tpu.scene import builder as jbuilder
from go_raytracer_tpu.scene import bvh as jbvh
from go_raytracer_tpu.scene import bvh8 as jbvh8
from go_raytracer_tpu.scene import clusters as jcl
from go_raytracer_tpu.scene import obj_loader as jobj
from go_raytracer_tpu.scenes import registry as jreg
from go_raytracer_tpu_torch.ops import bounce as tpb
from go_raytracer_tpu_torch.scene import builder as tbuilder
from go_raytracer_tpu_torch.scene import bvh as tbvh
from go_raytracer_tpu_torch.scene import bvh8 as tbvh8
from go_raytracer_tpu_torch.scene import clusters as tcl
from go_raytracer_tpu_torch.scene import obj_loader as tobj
from go_raytracer_tpu_torch.scene import types as TT
from go_raytracer_tpu_torch.scenes import registry as treg
from tests.test_bvh import random_mesh

torch.set_num_threads(2)

_ASSET = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "lanternhouse.obj")


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, \
        (what, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)   # NaN == NaN here


def assert_scenes_equal(js, ts):
    """Every table field of the port's Scene equals the other scene's
    (None where both have none), the finer `cl2_*` partition included."""
    for f in dataclasses.fields(TT.Scene):
        a, b = getattr(js, f.name), getattr(ts, f.name)
        if dataclasses.is_dataclass(b):
            for g in dataclasses.fields(b):
                x, y = getattr(a, g.name), getattr(b, g.name)
                if x is None or y is None:
                    assert x is None and y is None, (f.name, g.name)
                elif isinstance(y, (bool, int)):
                    assert x == y, (f.name, g.name, x, y)
                else:
                    _eq(x, y, f"{f.name}.{g.name}")
        elif isinstance(b, bool):
            assert a == b, f.name
        else:
            _eq(a, b, f.name)


def _statue_vertices():
    """The procedural statue at (64, 32) segments, as add_mesh receives it."""
    b = jbuilder.SceneBuilder()
    m = b.lambertian((1, 1, 1))
    jobj.procedural_statue(b, m, jobj.LoadOptions(scale_factor=5.0),
                           major_segments=64, minor_segments=32)
    return np.concatenate([blk["v"] for blk in b._tri_blocks])


@pytest.mark.parametrize("mesh", ["random", "statue"])
def test_bvh_bvh8_clusters_tables_identical(mesh):
    """bvh.build, bvh8.collapse (padded and line-packed nodes),
    clusters.partition and pack_cluster_boxes: exact."""
    v = random_mesh(1000, seed=7) if mesh == "random" else _statue_vertices()
    n = v.shape[0]
    jf, tf = jbvh.build(v, leaf_size=16), tbvh.build(v, leaf_size=16)
    for g in dataclasses.fields(tf):
        x, y = getattr(jf, g.name), getattr(tf, g.name)
        if isinstance(y, int):
            assert x == y, g.name
        else:
            _eq(x, y, f"bvh.{g.name}")
    vp = v[tf.order[:n]]
    v0, e0, e1 = vp[:, 0], vp[:, 1] - vp[:, 0], vp[:, 2] - vp[:, 0]
    for dense in (False, True):
        args = (tf.node_min, tf.node_max, tf.first, tf.count, tf.skip,
                v0, e0, e1)
        j8 = jbvh8.collapse(*args, max_leaf=16, dense_nodes=dense)
        t8 = tbvh8.collapse(*args, max_leaf=16, dense_nodes=dense)
        _eq(j8.node_lines, t8.node_lines, "nodes8")
        _eq(j8.tri_lines, t8.tri_lines, "tris8")
        assert (j8.n_nodes, j8.n_groups, j8.dense_nodes) == \
            (t8.n_nodes, t8.n_groups, t8.dense_nodes)
        # the walk's stack bound holds for a walk that visits everything
        assert 1 <= tbvh8.max_stack(t8.node_lines, dense) <= 7 * t8.n_nodes + 1
    jc = jcl.partition(jf, v0, e0, e1, max_tris=64)
    tc = tcl.partition(tf, v0, e0, e1, max_tris=64)
    for name in ("aabb_lo", "aabb_hi", "group_start", "tri_lines"):
        _eq(getattr(jc, name), getattr(tc, name), f"clusters.{name}")
    assert (jc.n_clusters, jc.n_groups) == (tc.n_clusters, tc.n_groups)
    _eq(jcl.pack_cluster_boxes(jc.aabb_lo, jc.aabb_hi),
        tcl.pack_cluster_boxes(tc.aabb_lo, tc.aabb_hi), "cl_boxes")


def test_entry_offsets_address_both_layouts():
    """bvh8.entry_offsets finds entry m, slot s, field f in the padded
    and the line-packed node table."""
    rs = np.random.default_rng(0)
    entries = rs.normal(size=(19, 8, 16)).astype(np.float32)
    m = np.arange(19)
    for dense, lines in ((True, tbvh8._pack_lines(entries)),
                         (False, tbvh8._pad_lines(entries))):
        flat = lines.reshape(-1)
        off = tbvh8.entry_offsets(m, dense)
        for s_, f_ in ((0, 0), (3, 7), (7, 15)):
            np.testing.assert_array_equal(flat[off + s_ * 128 + f_],
                                          entries[:, s_, f_])


def test_load_obj_identical(monkeypatch):
    """The OBJ + MTL fixture through both loaders and both compilers (BVH
    forced on, 64-triangle clusters): equal tables and light handles."""
    monkeypatch.setenv("GRT_CLUSTER_TRIS", "64")
    jb, tb = jbuilder.SceneBuilder(), tbuilder.SceneBuilder()
    jh = jobj.load_obj(jb, _ASSET, jobj.LoadOptions(
        scale_factor=2.0, center=True, position=(0, 1, 0),
        default_material=jb.lambertian((0.5, 0.5, 0.5))),
        transform=jbuilder.Transform(rotate_y_deg=30))
    th = tobj.load_obj(tb, _ASSET, tobj.LoadOptions(
        scale_factor=2.0, center=True, position=(0, 1, 0),
        default_material=tb.lambertian((0.5, 0.5, 0.5))),
        transform=tbuilder.Transform(rotate_y_deg=30))
    assert jh == th and len(th) > 0
    for h in th:
        jb.add_light(h)
        tb.add_light(h)
    js = jb.build(bvh_threshold=1)
    ts = tb.build(bvh_threshold=1, cluster_tris=64)
    assert ts.has_tri_bvh and ts.has_tri_lights
    assert_scenes_equal(js, ts)
    assert ts.lights.n == js.lights.n


@pytest.fixture(scope="module")
def model_scenes():
    return jreg.model_example(), treg.model_example()


def test_model_example_tables_identical(model_scenes):
    """Scene 8 (the 65,536-triangle statue): tables, statics, packing and
    camera are exact, and the ext-mode kernel carries it."""
    (js, jc), (ts, tc) = model_scenes
    assert_scenes_equal(js, ts)
    assert ts.triangles.count == 65536 and ts.tri_bvh.cl_lo.shape[0] == 128
    assert tpb.scene_statics(ts, ext=True) == jpb.scene_statics(js, ext=True)
    assert tpb.supported_ext(ts) and jpb.supported_ext(js)
    assert not tpb.supported(ts)
    for x, y in zip(jpb.pack_scene(js), tpb.pack_scene(ts)):
        _eq(x, y, "pack_scene")
    lay = tpb._mat_layout(tpb.scene_statics(ts, ext=True))
    _eq(np.stack([np.asarray(c) for c in jpb.join_mat_cols(
        js, lay, js.triangles.mat_id)]),
        tpb.tri_mat_table(ts, tpb.scene_statics(ts, ext=True)), "tri_mat")
    ja, ta = jc.derived(), tc.derived()
    for name in ("center", "pixel00", "du", "dv", "defocus_u", "defocus_v"):
        _eq(getattr(ja, name), getattr(ta, name), name)
    assert (tc.image_height, tc.spp_sqrt, tc.defocus_angle) == (337, 15, 0.1)


def test_scene_from_numpy_round_trip(model_scenes):
    """A JAX Scene carried across equals the port's own build, every
    TriBVH table and triangle array included, the finer cl2 partition
    (512 clusters of the statue) too."""
    (js, _), (ts, _) = model_scenes
    cs = TT.scene_from_numpy(js)
    assert_scenes_equal(cs, ts)
    assert isinstance(cs.tri_bvh.nodes8, np.ndarray)
    assert cs.tri_bvh.cl2_lines is not None \
        and ts.tri_bvh.cl2_gs.shape == (513,)
    assert (cs.tri_bvh.n_nodes, cs.tri_bvh.leaf_size, cs.tri_bvh.bvh8_dense) \
        == (ts.tri_bvh.n_nodes, ts.tri_bvh.leaf_size, ts.tri_bvh.bvh8_dense)
    back = TT.scene_from_numpy(cs)
    assert_scenes_equal(back, ts)
