"""The mesh slice as a whole: scene 8 through the port's `render_regen`
on the CPU (plain versions of the kernels) against the JAX package's
`render_regen`, at the size of tests/test_mesh_ext.py (48 px, 4 spp, depth
6, 4096 lanes); exact path accounting, bit-exact checkpoint resume, and
`-S 8` through the CLI."""

import json
import shutil

import jax
import numpy as np
import pytest
import torch

from go_raytracer_tpu.integrator import regen as jregen
from go_raytracer_tpu.scenes import registry as jreg
from go_raytracer_tpu_torch import cli
from go_raytracer_tpu_torch.integrator import regen
from go_raytracer_tpu_torch.render.camera import Camera
from go_raytracer_tpu_torch.scene.builder import SceneBuilder
from go_raytracer_tpu_torch.scenes import registry
from tests.test_bvh import random_mesh

torch.set_num_threads(2)

# The two packages draw different random numbers, so renders agree only
# statistically. Measured at this size over 12 seeds each (CPU): a channel
# mean of one JAX render has a seed-to-seed standard deviation below 0.006
# and its segments/path one of 0.6%; the limits are about four standard
# deviations of the difference of two renders. (The JAX package's own
# ext-vs-shell test allows 0.06 and 20%.)
MEAN_TOL = 0.03
SEG_TOL = 0.03


def small(cam):
    cam.width, cam.samples_per_pixel, cam.max_depth = 48, 4, 6
    return cam


@pytest.fixture(scope="module")
def renders():
    js, jc = jreg.model_example()
    jimg, jst = jregen.render_regen(js, small(jc), jax.random.key(0),
                                    n_lanes=4096)
    ts, tc = registry.model_example()
    timg, tst = regen.render_regen(ts, small(tc), seed=0, n_lanes=4096,
                                   device="cpu", mesh="binned")
    return (np.asarray(jimg), jst), (timg, tst), (ts, tc)


def test_scene8_render_matches_jax_statistically(renders):
    (jimg, jst), (timg, tst), _ = renders
    assert tst["paths"] == jst["paths"] == 48 * 27 * 4
    assert tst["schedule"] == jst["schedule"] == "queue"
    assert tst["nonfinite"] == 0 and np.isfinite(timg).all()
    assert timg.shape == jimg.shape == (27, 48, 3)
    np.testing.assert_allclose(timg.mean(axis=(0, 1)), jimg.mean(axis=(0, 1)),
                               atol=MEAN_TOL)
    jr, tr = jst["segments"] / jst["paths"], tst["segments"] / tst["paths"]
    assert abs(tr - jr) / jr < SEG_TOL
    # the statue, lit by the sun, is in the picture: gold is red > blue
    assert timg[..., 0].mean() > 2 * timg[..., 2].mean() > 0
    # the same window walk as the JAX package's
    assert tst["windows"] == jst["windows"] == 1
    assert abs(tst["occupancy"] - jst["occupancy"]) < 0.01
    assert tst["lanes"] == 4096 and tst["device"] == "cpu"


def test_both_routes_render_the_same_image(renders):
    """The binned intersector and the BVH8 walk return the same winners,
    so with one seed the two routes render bit-identical images; the
    binned route's rounds and host reads are counted."""
    _, (timg, tst), (ts, tc) = renders
    wimg, wst = regen.render_regen(ts, tc, seed=0, n_lanes=4096,
                                   device="cpu", mesh="walk")
    np.testing.assert_array_equal(wimg, timg)
    assert wst["segments"] == tst["segments"]
    m = tst["mesh"]
    assert m["route"] == "binned" and wst["mesh"]["route"] == "walk"
    assert m["mesh_calls"] == tst["levels"] == wst["levels"]
    assert m["host_reads"] == m["rounds"] + m["mesh_calls"]
    assert 1 <= m["rounds"] / m["mesh_calls"] <= 128


def test_lane_cap_and_schedules(monkeypatch):
    """The mesh path caps the pool at MESH_MAX_LANES, 131,072 lanes
    (re-derived on the H100; the JAX package's cap is 65,536), runs
    cadence 1 with window = 5 * (max_depth + 1), refuses the in-kernel
    queue and runs `positional` on the reference engine's bounce. The
    capping is checked on a cap of 2,048 lanes, a size the CPU renders
    quickly."""
    assert regen.MESH_MAX_LANES == 1 << 17
    cap = 1 << 11
    monkeypatch.setattr(regen, "MESH_MAX_LANES", cap)
    ts, tc = registry.model_example()
    tc.width, tc.samples_per_pixel, tc.max_depth = 8, 1, 2
    _, st = regen.render_regen(ts, tc, n_lanes=2 * cap, device="cpu",
                               mesh="walk")
    assert st["lanes"] == cap
    assert st["paths"] == 8 * 4 and st["schedule"] == "queue"
    assert st["occupancy"] == st["segments"] / (15 * cap)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        regen.render_regen(ts, tc, n_lanes=4096, device="cpu",
                           schedule="queue_ik")
    _, sp = regen.render_regen(ts, tc, n_lanes=2 * cap, device="cpu",
                               schedule="positional")
    assert sp["lanes"] == cap and sp["paths"] == 8 * 4
    assert sp["schedule"] == "positional" and sp["bounce"] == "wavefront"


def far_mesh_scene(bg):
    """A BVH mesh behind the camera and a light sphere no camera ray
    reaches: every path is one segment that returns the background."""
    b = SceneBuilder(background=bg)
    m = b.lambertian((0.5, 0.5, 0.5))
    b.add_mesh(random_mesh(300, seed=3) + np.array([0.0, 0.0, 40.0]),
               np.full(300, m, np.int32))
    b.add_light(b.sphere((0, 0, 1e6), 1.0, b.diffuse_light((1, 1, 1))))
    return b.build(bvh_threshold=1, bvh_leaf_size=4, cluster_tris=64)


@pytest.mark.parametrize("defocus", [0.0, 2.0])
def test_exact_accounting(defocus):
    """Every item slot is written exactly once: with one window, and with
    the queue cursor chained over several windows, the image is exactly
    the background and segments == paths."""
    cam = Camera(width=32, aspect_ratio=1.0, samples_per_pixel=9, max_depth=4,
                 defocus_angle=defocus)
    cam.position((0, 0, 5), (0, 0, 0))
    img, st = regen.render_regen(far_mesh_scene((1.0, 1.0, 1.0)), cam, seed=0,
                                 n_lanes=4096, device="cpu")
    assert np.abs(img - 1.0).max() == 0.0
    assert st["segments"] == st["paths"] == 32 * 32 * 9
    img, st = regen.render_regen(far_mesh_scene((0.25, 0.5, 0.75)), cam,
                                 seed=1, n_lanes=1024, refill_len=2,
                                 device="cpu")
    assert st["windows"] >= 4
    assert np.abs(img - np.array([0.25, 0.5, 0.75], np.float32)).max() == 0.0
    assert st["segments"] == st["paths"]


def test_checkpoint_resume_bit_exact(tmp_path, monkeypatch):
    """Interrupting after a window and resuming reproduces the
    uninterrupted render bit for bit (each window's random stream is keyed
    by seed and window), and a completed checkpoint resumes with zero new
    segments; the accumulator format is the in-kernel-queue path's."""
    from go_raytracer_tpu_torch.render import checkpoint as ck

    ts, tc = registry.model_example()
    tc.width, tc.samples_per_pixel, tc.max_depth = 16, 4, 3
    kw = dict(seed=17, n_lanes=256, refill_len=1, device="cpu", mesh="walk")
    img_ref, st_ref = regen.render_regen(ts, tc, **kw)
    assert st_ref["windows"] >= 3

    ckpt = str(tmp_path / "r.npz")
    saved = []
    real_save = ck.save

    def capture_save(path, acc, next_item, meta):
        real_save(path, acc, next_item, meta)
        snap = str(tmp_path / f"snap{len(saved)}.npz")
        shutil.copy(path, snap)
        saved.append(snap)

    monkeypatch.setattr(ck, "save", capture_save)
    img_full, _ = regen.render_regen(ts, tc, checkpoint_path=ckpt,
                                     checkpoint_every=1, scene_name="m", **kw)
    np.testing.assert_array_equal(img_full, img_ref)
    assert len(saved) >= 3
    monkeypatch.setattr(ck, "save", real_save)

    shutil.copy(saved[0], ckpt)
    img_res, st_res = regen.render_regen(ts, tc, checkpoint_path=ckpt,
                                         scene_name="m", **kw)
    np.testing.assert_array_equal(img_res, img_ref)
    assert len(st_res["window_s"]) < st_ref["windows"]
    img_done, st_done = regen.render_regen(ts, tc, checkpoint_path=ckpt,
                                           scene_name="m", **kw)
    np.testing.assert_array_equal(img_done, img_ref)
    assert st_done["segments"] == 0


def test_cli_renders_scene_8(tmp_path, capsys):
    """`-S 8 --cpu` through cli.main: exit 0, one JSON stats line, a P3
    PPM at 16:9, on the walk route (the default); `--mesh binned` too."""
    for extra in ([], ["--mesh", "binned"]):
        out = tmp_path / "m.ppm"
        rc = cli.main(["-S", "8", "-o", str(out), "--cpu", "--width", "32",
                       "--spp", "1", "--max-depth", "3", "--lanes", "1024",
                       "--stats", "--quiet", *extra])
        assert rc == 0
        stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert stats["scene"] == "modelExample"
        assert stats["schedule"] == "queue" and stats["device"] == "cpu"
        assert stats["paths"] == 32 * 18 and stats["nonfinite"] == 0
        assert stats["mesh"]["route"] == (extra[-1] if extra else "walk")
        txt = out.read_text().split()
        assert txt[:4] == ["P3", "32", "18", "255"]


@pytest.mark.parametrize("extra,route,kernel", [
    ([], "walk", "bvh8_closest"),
    (["--b1-fused"], "binned+b1_fused", "stream_round_rows"),
    (["--mesh", "binned"], "binned", "stream_rows")])
def test_default_route_is_the_walk(tmp_path, capsys, monkeypatch, extra,
                                   route, kernel):
    """`-S 8` without `--mesh` takes the walk (`route_name` of the auto
    route), with every level's closest hit one call of `bvh8_closest` and
    none of the binned intersector's; `--b1-fused` alone still resolves to
    the binned route's fused rounds, and `--mesh binned` to the binned
    route."""
    from go_raytracer_tpu_torch.ops import stream, trace, traverse8

    calls = {}
    for mod, name in ((traverse8, "bvh8_closest"), (stream, "stream_rows"),
                      (stream, "stream_round_rows")):
        real = getattr(mod, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    out = tmp_path / "m.ppm"
    rc = cli.main(["-S", "8", "-o", str(out), "--cpu", "--width", "16",
                   "--spp", "1", "--max-depth", "2", "--lanes", "1024",
                   "--stats", "--quiet", *extra])
    assert rc == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["mesh"]["route"] == route == trace.route_name(
        "auto" if "--mesh" not in extra else extra[1],
        b1_fused="--b1-fused" in extra)
    assert list(calls) == [kernel] and calls[kernel] >= stats["levels"] > 0
    if kernel == "bvh8_closest":
        assert calls[kernel] == stats["mesh"]["mesh_calls"] \
            == stats["levels"]
        assert "rounds" not in stats["mesh"]


def test_auto_route_on_a_dense_scene():
    """On a scene without a mesh, mesh="auto" (the default) means nothing:
    cornellBox renders the same image with it named or not, and a named
    mesh route is refused."""
    scene, cam = registry.cornell_box()
    cam.width, cam.samples_per_pixel, cam.max_depth = 16, 1, 3
    kw = dict(seed=2, n_lanes=256, device="cpu")
    img_a, st_a = regen.render_regen(scene, cam, mesh="auto", **kw)
    img_d, st_d = regen.render_regen(scene, cam, **kw)
    np.testing.assert_array_equal(img_a, img_d)
    assert st_a["segments"] == st_d["segments"] > 0 and "mesh" not in st_a
    for route in ("binned", "binned2", "walk"):
        with pytest.raises(ValueError, match="no mesh"):
            regen.render_regen(scene, cam, mesh=route, **kw)
