"""The port's `render_regen_sharded` (integrator/regen.py) on four gloo
ranks on the CPU, the kernels' plain versions in every schedule, against
the JAX package's sharded render (tests/test_regen.py's scenes and sizes)
and, on a one-rank group, against `render_regen` bit for bit.

The four ranks are spawned once for the file (tests/torch_dist_workers.py,
which loads no JAX) and hand their images and stats back through files;
the JAX package and the port's one-device renders run here, in the test
process."""

import functools
import json
import os

import numpy as np
import pytest
import torch

import torch_dist_workers as W
from go_raytracer_tpu_torch.integrator import regen

torch.set_num_threads(2)

BG = (0.25, 0.5, 0.75)
# modelExample at 32 px, 9 spp, depth 4 (W.model_cam): the image mean of a
# one-device render has a seed-to-seed standard deviation of 0.0048 (8
# seeds, CPU; mean 0.0945), so 0.1 of the mean, the JAX package's bound for
# its sharded render, is 1.4 standard deviations of the difference of two
# renders. The bound here is four, as tests/test_torch_renderer.py's.
MODEL_MEAN_TOL = 0.027


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("regen_sharded")
    W.run_ranks("regen_scenarios", out)
    return out


def _rank(out, r):
    with open(os.path.join(out, f"regen_{r}.json")) as fh:
        return json.load(fh), np.load(os.path.join(out, f"regen_{r}.npz"))


def _jax_sharded(scene_fn, cam_args, seed, **kw):
    """JAX's render_regen_sharded on a 4-device ("data",) mesh."""
    import jax

    from go_raytracer_tpu.integrator import regen as jregen
    from go_raytracer_tpu.parallel import mesh as jmesh
    from go_raytracer_tpu.render.camera import Camera

    pos, look = cam_args.pop("position")
    cam = Camera(**cam_args)
    cam.position(pos, look)
    return jregen.render_regen_sharded(
        scene_fn(), cam, jmesh.make_mesh(4, axes=("data",)),
        jax.random.key(seed), backend="xla", **kw)


@functools.lru_cache(maxsize=None)
def _jax_per_shard(width, aspect, spp, positional, **kw):
    from tests.test_regen import empty_scene

    _, st = _jax_sharded(
        lambda: empty_scene(bg=BG),
        dict(width=width, aspect_ratio=aspect, samples_per_pixel=spp,
             max_depth=4, position=((0, 0, 5), (0, 0, 0))),
        0, n_lanes=W.LANES, schedule="positional" if positional else "queue",
        **kw)
    return st["segments_per_shard"]


def _exact_background(img):
    for c in range(3):
        np.testing.assert_allclose(img[..., c], BG[c], atol=1e-6)


@pytest.mark.parametrize("name", list(W.SCHEDULES))
def test_exact_bookkeeping_in_every_schedule(ranks, name):
    """All-miss scene, 16 px, 9 spp, depth 4: every rank's image is exactly
    the background, one segment a path, over four devices, and each rank
    traces JAX's share of the segments (every item is one segment, so the
    split of items must match: ranks' item ranges, or under `positional`
    the global pool's lane blocks)."""
    st0, _ = _rank(ranks, 0)
    st = st0["miss_" + name]
    for r in range(4):
        _exact_background(_rank(ranks, r)[1]["miss_" + name])
    assert st["segments"] == st["paths"] == 16 * 16 * 9
    assert st["devices"] == 4
    assert st["nonfinite"] == 0
    assert st["segments_per_shard"] == _jax_per_shard(
        16, 1.0, 9, "positional" in name)
    assert st["backend"] == ("xla" if name.startswith("xla") else "pallas")
    assert st.get("direct_rec", False) == (name == "direct_rec")


@pytest.mark.parametrize("name", ["queue_ik", "queue", "positional", "xla"])
def test_ranks_that_finish_early_stay_in_lockstep(ranks, name):
    """1,025 items at refill_len 1 (W.lockstep_cam): ranks 0-2 need two
    windows, rank 3 (254 items) one, and it joins the second window's sum
    with an idle window. Exact image, one segment a path, JAX's split."""
    st = _rank(ranks, 0)[0]["step_" + name]
    for r in range(4):
        _exact_background(_rank(ranks, r)[1]["step_" + name])
    assert st["segments"] == 1025 and st["windows"] == 2
    assert st["segments_per_shard"] == _jax_per_shard(
        41, 41 / 25, 1, name == "positional", refill_len=1)


@pytest.mark.parametrize("name", ["queue_ik", "xla"])
def test_a_rank_without_items(ranks, name):
    """9 items over four ranks: rank 3 owns none and still joins every
    collective."""
    st = _rank(ranks, 0)[0]["empty_" + name]
    _exact_background(_rank(ranks, 3)[1]["empty_" + name])
    assert st["segments"] == 9 and st["segments_per_shard"] == [3, 3, 3, 0]


@functools.lru_cache(maxsize=None)
def _jax_box_means():
    from tests.test_regen import box_scene

    ji, _ = _jax_sharded(box_scene, dict(
        width=12, aspect_ratio=1.0, samples_per_pixel=25, max_depth=5,
        position=((0, 2, 6), (0, 1, 0))), W.BOX_SEED, n_lanes=W.LANES)
    return np.asarray(ji).mean((0, 1))


@pytest.mark.parametrize("name", ["queue_ik", "queue"])
def test_statistical_agreement(ranks, name):
    """The lit box at 12 px, 25 spp, depth 5: the port's four-rank render
    against JAX's sharded render (its XLA engine) and against the port's
    one-device render of another seed, channel means within JAX's bound
    for its sharded render (tests/test_regen.py: rtol 0.1, atol 5e-3)."""
    img = _rank(ranks, 0)[1]["box_" + name]
    one, _ = regen.render_regen(W.box_scene(), W.box_cam(),
                                seed=W.BOX_SEED + 1, n_lanes=4096,
                                device="cpu", **W.SCHEDULES[name])
    assert np.isfinite(img).all()
    for ref in (_jax_box_means(), one.mean((0, 1))):
        np.testing.assert_allclose(img.mean((0, 1)), ref, rtol=0.1,
                                   atol=5e-3)


def test_model_example_sharded(ranks):
    """modelExample at 32 px, 9 spp, depth 4 (its mesh on the external-hit
    bounce): finite, and its mean within MODEL_MEAN_TOL of the one-device
    render's."""
    from go_raytracer_tpu_torch.scenes import registry

    st, imgs = _rank(ranks, 0)
    img = imgs["model"]
    scene, cam = registry.model_example()
    one, _ = regen.render_regen(scene, W.model_cam(cam), seed=3,
                                n_lanes=4096, device="cpu")
    assert np.isfinite(img).all()
    assert abs(img.mean() - one.mean()) <= MODEL_MEAN_TOL
    assert st["model"]["devices"] == 4 and st["model"]["segments"] > 0
    assert st["model"]["bounce"] == "ext"


@pytest.fixture(scope="module")
def one_rank(ranks):
    with open(os.path.join(ranks, "regen_one.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("name", list(W.SCHEDULES) + ["model"])
def test_one_rank_equals_render_regen(one_rank, name):
    """A one-rank group's render_regen_sharded is render_regen with the
    same seed, image and segments bit for bit (rank 0 draws render_regen's
    streams), in every schedule and on the mesh path."""
    got = one_rank[name]
    assert got["equal"] and got["max_diff"] == 0.0
    assert got["segments"][0] == got["segments"][1]
    assert got["devices"] == 1 and got["per_shard"] == got["segments"][:1]


def test_reorder_true_raises(one_rank):
    """reorder=True through render_regen_sharded raises ValueError wherever
    render_regen refuses the lane coherence sort (under queue_ik,
    positional or direct_rec, and off the fused kernels), and elsewhere
    passes through: a one-rank group renders render_regen(reorder=True)'s
    image and segments bit for bit on the `queue` schedule (the "reorder"
    case of test_one_rank_equals_render_regen; four ranks in
    test_exact_bookkeeping_in_every_schedule). The name is kept from when
    the sharded entry refused the sort everywhere."""
    refusals = one_rank["reorder_refusals"]
    assert set(refusals) == {"queue_ik", "positional", "direct_rec", "xla"}
    for tag, err in refusals.items():
        assert err is not None and err.startswith("ValueError"), (tag, err)
        assert "reorder" in err
    got = one_rank["reorder"]
    assert got["equal"] and got["max_diff"] == 0.0
    assert got["segments"][0] == got["segments"][1]
    st = one_rank["reorder_schedule"]
    assert st["schedule"] == "queue" and st["reorder"] is True
