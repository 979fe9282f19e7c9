"""The port's device meshes, sharded render and sharded train step
(`parallel/mesh.py`, `parallel/distributed.py`) on four gloo ranks on the
CPU, against one rank, the one-device step and the JAX package
(tests/test_parallel.py's scenes and sizes).

The four ranks are spawned once for the file (tests/torch_dist_workers.py,
which loads no JAX) and hand their results back through files; the JAX
package runs here, in the test process, on its 8-device CPU mesh
(conftest.py)."""

import json
import os

import numpy as np
import pytest
import torch

import torch_dist_workers as W
from go_raytracer_tpu_torch.parallel import distributed, mesh as pmesh

torch.set_num_threads(2)

# The packages draw different random numbers, so the port's sharded render
# and JAX's agree only statistically. Measured on the CPU over 8 seeds of
# each package at this size (tiny_scene, 24 px, 4 spp, depth 4): a channel
# mean has a seed-to-seed standard deviation of at most 0.0022 (port) and
# 0.0029 (JAX), so their difference one of 0.0036. As in
# tests/test_torch_renderer.py (MEAN_TOL), the bound is four standard
# deviations of the difference of two renders.
MEAN_TOL = 0.015


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel")
    W.run_ranks("parallel_scenarios", out)
    return out


def _load(out, name):
    return np.load(os.path.join(out, name))


def _info(out, rank):
    with open(os.path.join(out, f"parallel_{rank}.json")) as fh:
        return json.load(fh)


def test_mesh_shape_matches_jax():
    """The factorisation of JAX's make_mesh for 1..8 devices; one axis is
    flat. No process group is needed."""
    from go_raytracer_tpu.parallel import mesh as jmesh

    for n in range(1, 9):
        assert pmesh.mesh_shape(n) == jmesh.make_mesh(n).devices.shape, n
        assert pmesh.mesh_shape(n, ("data",)) == (n,)
    with pytest.raises(ValueError):
        pmesh.mesh_shape(4, ("a", "b", "c"))


def test_make_mesh_over_the_group(ranks):
    """Four ranks make a 2 x 2 ("data", "sample") mesh, rank r at its
    row-major coordinate; a mesh of fewer ranks than the group raises; each
    rank folds its own host key."""
    infos = [_info(ranks, r) for r in range(4)]
    for r, info in enumerate(infos):
        assert info["shape"] == [2, 2]
        assert info["names"] == ["data", "sample"]
        assert info["coord"] == [r // 2, r % 2]
        assert info["smaller"].startswith("ValueError")
    assert len({i["host_key"] for i in infos}) == 4


def test_make_mesh_needs_a_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="initialize"):
        pmesh.make_mesh(1)


def test_render_sharded_is_independent_of_the_rank_count(ranks):
    """tiny_scene at 24 px, 4 spp, depth 4: four ranks and one rank give
    the same image within 1e-5 (every rank gets it), the same segments."""
    one = _load(ranks, "parallel_one.npz")
    for r in range(4):
        img = _load(ranks, f"parallel_{r}.npz")["img"]
        assert img.shape == (24, 24, 3) and np.isfinite(img).all()
        np.testing.assert_allclose(img, one["img"], atol=1e-5)
        assert _info(ranks, r)["segments"] == int(one["segments"])


def test_render_sharded_matches_jax_statistically(ranks):
    """Against JAX's render_sharded on its 8-device mesh (the same scene,
    camera and mode): channel means within MEAN_TOL."""
    import jax

    from go_raytracer_tpu.parallel import mesh as jmesh
    from go_raytracer_tpu.render.camera import Camera
    from tests.test_parallel import tiny_scene

    cam = Camera(width=24, aspect_ratio=1.0, samples_per_pixel=4, max_depth=4)
    cam.position((0, 2, 8), (0, 1, 0))
    ji, jst = jmesh.render_sharded(tiny_scene(), cam, jmesh.make_mesh(8),
                                   key=jax.random.key(W.RENDER_SEED))
    ti = _load(ranks, "parallel_0.npz")["img"]
    assert np.abs(ti.mean((0, 1)) - np.asarray(ji).mean((0, 1))).max() \
        <= MEAN_TOL
    seg = _info(ranks, 0)["segments"]
    assert abs(seg / jst["segments"] - 1) <= 0.05


def _one_device_step():
    step, params, _ = pmesh.make_train_step(
        W.tiny_scene(), W.train_cam(), device="cpu",
        generator=pmesh.KeyedUniforms(3), **W.TRAIN)
    ids = pmesh.pixel_ids(W.TRAIN["n_rays"], W.TRAIN["n_sample_batches"])
    target = torch.zeros((W.TRAIN["n_rays"], 3))
    return step, params, ids, target


def test_sharded_step_equals_the_one_device_step(ranks):
    """2 data x 2 sample ranks and the one-device step on the same
    KeyedUniforms: the same first loss (rel 1e-5) and every leaf's
    gradient within 1e-5 of the leaf's largest entry, on every rank."""
    step, params, ids, target = _one_device_step()
    loss = step(params, ids, target)
    for r in range(4):
        got = _load(ranks, f"parallel_{r}.npz")
        assert got["losses"][0] == pytest.approx(loss, rel=1e-5)
        for k, p in params.items():
            ref = p.grad.numpy()
            scale = max(float(np.abs(ref).max()), 1e-12)
            assert np.abs(got["grad_" + k] - ref).max() <= 1e-5 * scale, k
    assert float(params["tex_color"].grad.abs().max()) > 0


def test_sharded_step_runs_and_improves(ranks):
    """Five steps at test_train_step_runs_and_improves's sizes (64 rays, 2
    batches, depth 2, lr 5e-2, black target): finite losses, the last
    below the first, the same on every rank and as the one-device
    step's."""
    step, params, ids, target = _one_device_step()
    ref = [step(params, ids, target) for _ in range(W.TRAIN_STEPS)]
    for r in range(4):
        losses = _load(ranks, f"parallel_{r}.npz")["losses"]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
        np.testing.assert_allclose(losses, ref, rtol=1e-4)


def test_step_refuses_a_generator_on_a_mesh():
    """A torch.Generator cannot be split by position: a sharded step
    raises before touching the group (no mesh is needed to see it)."""
    class OneRank:
        ndim, shape, device_type = 2, (1, 1), "cpu"

    with pytest.raises(ValueError, match="KeyedUniforms"):
        pmesh.make_train_step(W.tiny_scene(), W.train_cam(), device="cpu",
                              mesh=OneRank(), generator=torch.Generator(),
                              **W.TRAIN)


def test_initialize_without_a_coordinator_is_single_process(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize() is False
    assert not torch.distributed.is_initialized()


def test_no_fallback_without_gpus(tmp_path):
    """NCCL asked for without CUDA raises before any group forms, and more
    ranks on a host than its visible GPUs raise."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed.initialize(f"file://{tmp_path}/rdzv", 1, 0, device="cuda")
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="one rank per GPU"):
        distributed.cuda_device_for(0, 2, 1)
    with pytest.raises(ValueError, match="one rank per GPU"):
        distributed.cuda_device_for(1, 1, 1)
    assert distributed.cuda_device_for(0, 1, 1) == torch.device("cuda", 0)


def test_a_group_missing_a_rank_raises(tmp_path):
    """A group of two whose second rank never comes fails after its
    timeout: no one-rank group goes on in its place."""
    with pytest.raises(RuntimeError):
        distributed.initialize(f"file://{tmp_path}/rdzv", 2, 0, device="cpu",
                               timeout=2)
    assert not torch.distributed.is_initialized()


def test_a_sum_that_a_rank_never_joins_times_out(tmp_path):
    """Two ranks; rank 0 sums a tensor rank 1 never sends: the sum raises
    after the group's timeout instead of hanging the run."""
    W.run_ranks("timeout_scenarios", tmp_path, n_ranks=2, timeout=60)
    with open(tmp_path / "timeout.json") as fh:
        got = json.load(fh)
    assert got["error"].startswith("RuntimeError")
    assert W.SUM_TIMEOUT_S * 0.9 <= got["seconds"] <= W.SUM_TIMEOUT_S + 10
