"""The BVH8 stack walk of the port against the JAX package: the plain
version of the kernel against the Pallas kernel in interpret mode (the
cases of tests/test_traverse8.py), and the port's two routes against each
other."""

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_raytracer_tpu.ops.pallas import traverse8 as ptrav8
from go_raytracer_tpu.scene import bvh8 as jbvh8
from go_raytracer_tpu_torch.ops import trace as ttrace
from go_raytracer_tpu_torch.ops import traverse8 as ttrav8
from go_raytracer_tpu_torch.scene import bvh8 as tbvh8
from go_raytracer_tpu_torch.scene import types as TT
from tests.test_bvh import _scenes_with_and_without_bvh
from tests.test_torch_stream import mesh_pair, rays

torch.set_num_threads(2)


def both(js, o, d, cap, dense_nodes=None):
    """(t, idx) of the Pallas kernel (interpret mode) and of the port's
    plain version on the same tables and rays."""
    bvh = js.tri_bvh
    nodes, dense = bvh.nodes8, bvh.bvh8_dense
    if dense_nodes is not None and dense_nodes != dense:
        # re-pack the node table the other way
        e = ttrav8.node_entries(torch.from_numpy(np.asarray(nodes)), dense)
        pack = jbvh8._pack_lines if dense_nodes else jbvh8._pad_lines
        nodes, dense = pack(e.numpy().copy()), dense_nodes
    jt, ji = ptrav8.bvh8_closest(
        jnp.asarray(nodes), bvh.tris8, jnp.asarray(o), jnp.asarray(d),
        None if cap is None else jnp.asarray(cap), dense_nodes=dense,
        interpret=True)
    tt = torch.from_numpy
    pt, pi = ttrav8.bvh8_closest(
        tt(np.asarray(nodes)), tt(np.asarray(bvh.tris8)), tt(o), tt(d),
        None if cap is None else tt(cap), dense_nodes=dense)
    return (np.asarray(jt), np.asarray(ji)), (pt.numpy(), pi.numpy())


@pytest.mark.parametrize("dense_nodes", [False, True])
def test_bvh8_closest_ref_matches_pallas_kernel(dense_nodes, monkeypatch):
    """Padded and line-packed node tables, capped rays (cap pruning) and
    dead rays (cap 0): idx exact, t within rtol 1e-6; a miss returns the
    cap and -1."""
    js, _ = mesh_pair(3000, 33, monkeypatch)
    o, d, cap, alive = rays(2176, 34)
    cap0 = np.where(alive, cap, 0.0).astype(np.float32)
    (jt, ji), (pt, pi) = both(js, o, d, cap0, dense_nodes=dense_nodes)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pt, jt, rtol=1e-6)
    miss = pi < 0
    np.testing.assert_array_equal(pt[miss], cap0[miss])
    assert (pi[~alive] == -1).all() and (pi >= 0).sum() > 100
    # pruning: a capped ray never reports a hit beyond its cap
    assert (pt[pi >= 0] < cap0[pi >= 0]).all()
    assert ttrav8.launches == 0            # CPU tensors never launch


def test_single_leaf_tree(monkeypatch):
    """A mesh smaller than one leaf: the root's only slot is the leaf."""
    js, _ = _scenes_with_and_without_bvh(3, seed=5)
    assert js.tri_bvh.n_nodes == 1
    o, d, _, _ = rays(512, 6, caps=False)
    o = (o * 0.5).astype(np.float32)
    (jt, ji), (pt, pi) = both(js, o, d, None)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pt, jt, rtol=1e-6)


def test_max_stack_bounds_the_walk(monkeypatch):
    """bvh8.max_stack is an upper bound of the deepest stack the plain
    walk reaches (rays through the whole tree, no cap), and small."""
    js, ms = mesh_pair(3000, 33, monkeypatch)
    bound = ms.tri_bvh.max_stack
    assert bound == tbvh8.max_stack(np.asarray(js.tri_bvh.nodes8),
                                    js.tri_bvh.bvh8_dense)
    assert 8 <= bound <= ttrav8.STACK


def test_walk_and_binned_routes_agree_on_statue():
    """On the procedural statue (shared edges, so equal-t ties occur) the
    port's walk route and binned route return the same winners and the
    same t, bit for bit."""
    from go_raytracer_tpu_torch.scene import obj_loader
    from go_raytracer_tpu_torch.scene.builder import SceneBuilder

    b = SceneBuilder()
    obj_loader.procedural_statue(
        b, b.lambertian((1, 1, 1)), obj_loader.LoadOptions(scale_factor=5.0),
        major_segments=64, minor_segments=32)
    ms = ttrace.to_device(b.build(cluster_tris=64), "cpu")
    assert ms.has_tri_bvh and ms.tri_bvh.cl_lo.shape[0] > 32
    rs = np.random.default_rng(9)
    n = 3000
    o = torch.from_numpy(rs.uniform(-8, 8, (n, 3)).astype(np.float32))
    d = -o + torch.from_numpy(rs.normal(size=(n, 3)).astype(np.float32)) * 2
    cap = torch.from_numpy(np.where(rs.uniform(size=n) < 0.3, 9.0, np.inf)
                           .astype(np.float32))
    alive = torch.from_numpy(rs.uniform(size=n) < 0.9)
    bt, bi = ttrace.mesh_closest(ms, o, d, cap, alive, mesh="binned")
    wt, wi = ttrace.mesh_closest(ms, o, d, cap, alive, mesh="walk")
    assert (bi >= 0).sum() > 500
    assert torch.equal(bi, wi) and torch.equal(bt, wt)
    with pytest.raises(ValueError, match="binned"):
        ttrace.mesh_closest(ms, o, d, mesh="other")
