"""The port's regen integrator (in-kernel queue) on the CPU: exact item
accounting, cursor chaining across windows, one cornellBox window against
the JAX package's `_window_impl` on the same per-call seeds, window sizing,
and bit-exact checkpoint resume."""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_raytracer_tpu.integrator import regen as jregen
from go_raytracer_tpu.render.camera import Camera as JCamera
from go_raytracer_tpu.scenes import registry as jreg
from go_raytracer_tpu_torch.integrator import regen
from go_raytracer_tpu_torch.ops import bounce as tpb
from go_raytracer_tpu_torch.render.camera import Camera
from go_raytracer_tpu_torch.scene import types as TT
from go_raytracer_tpu_torch.scene.builder import SceneBuilder
from go_raytracer_tpu_torch.scenes import registry

torch.set_num_threads(2)


def quad_scene(bg=(1.0, 1.0, 1.0)):
    """A lambertian quad and a light quad far behind the camera: every
    path misses and returns the background."""
    b = SceneBuilder(background=bg)
    m = b.lambertian((0.5, 0.5, 0.5))
    b.quad((0, 0, 1e8), (1, 0, 0), (0, 1, 0), m)
    b.add_light(b.quad((0, 0, 1e8), (1, 0, 0), (0, 1, 0),
                       b.diffuse_light((1, 1, 1))))
    return b.build()


def box_scene():
    b = SceneBuilder(background=(0, 0, 0))
    white = b.lambertian((0.73, 0.73, 0.73))
    b.quad((-4, 0, -4), (8, 0, 0), (0, 0, 8), white)
    b.quad((-4, 0, -4), (0, 4, 0), (0, 0, 8), b.lambertian((0.65, 0.05, 0.05)))
    lq = b.quad((-1, 3.9, -1), (2, 0, 0), (0, 0, 2), b.diffuse_light((10, 10, 10)))
    b.box((0, 0, 0), (1, 2, 1), white)
    b.add_light(lq)
    return b.build()


def test_every_item_contributes_exactly_once():
    cam = Camera(width=32, aspect_ratio=1.0, samples_per_pixel=9, max_depth=4)
    cam.position((0, 0, 5), (0, 0, 0))
    img, st = regen.render_regen(quad_scene(), cam, seed=0, n_lanes=4096,
                                 cadence=3, device="cpu")
    np.testing.assert_array_equal(img, 1.0)
    assert st["paths"] == st["segments"] == 32 * 32 * 9
    assert st["schedule"] == "queue_ik" and st["nonfinite"] == 0


def test_multi_window_cursor_chains_exactly():
    cam = Camera(width=64, aspect_ratio=1.0, samples_per_pixel=16, max_depth=3)
    cam.position((0, 0, 5), (0, 0, 0))
    img, st = regen.render_regen(quad_scene((0.25, 0.5, 0.75)), cam, seed=1,
                                 n_lanes=4096, cadence=2, refill_len=8,
                                 device="cpu")
    assert st["windows"] > 1
    np.testing.assert_array_equal(img[..., 0], 0.25)
    np.testing.assert_array_equal(img[..., 1], 0.5)
    np.testing.assert_array_equal(img[..., 2], 0.75)


def test_cornell_window_matches_jax_window():
    """cornellBox at 32 px, 16 spp, depth 50, 4096 lanes: one window of the
    port against the JAX window (Pallas kernels in interpret mode), fed the
    same per-call seeds. Both trace the same paths up to float rounding;
    a lane that branches the other way changes its path (and, through the
    queue ranks, later assignments), so a small fraction of items may
    differ. Measured: 2 of 16384 items."""
    js, jc = jreg.cornell_box()
    W, SPP, DEPTH, n, cad = 32, 16, 50, 4096, 8
    jc.width, jc.samples_per_pixel, jc.max_depth = W, SPP, DEPTH
    tc = Camera(**{f.name: getattr(jc, f.name)
                   for f in dataclasses.fields(Camera)})
    ts = TT.scene_from_numpy(js)
    npix, sq, total = W * W, 4, W * W * SPP
    refill = jregen._auto_refill(total, n, DEPTH + 1, cad, jc)
    window = -(-(refill + DEPTH + 1) // cad) * cad
    outer = window // cad
    key = jax.random.fold_in(jax.random.key(7), 0)
    seeds = np.asarray(jax.random.randint(
        key, (outer,), jnp.iinfo(jnp.int32).min, jnp.iinfo(jnp.int32).max,
        dtype=jnp.int32))
    jacc, _, jcur = jregen._window_impl(
        js, jc.derived(), jnp.zeros((total + n, 3), jnp.float32),
        jregen._init_state(n, jnp.float32), jnp.int32(0), key, jnp.int32(0),
        jnp.int32(total), width=W, npix=npix, sqrt_spp=sq, window=window,
        refill=refill, cadence=cad, n_u=9, max_depth=DEPTH,
        max_contribution=jc.max_contribution, use_pallas=True,
        interpret=True, inkernel=True, harvest="fused")
    tacc = torch.zeros((total + n, 3))
    _, _, tcur = regen._window_impl(
        tuple(torch.from_numpy(t) for t in tpb.pack_scene(ts)),
        tpb.scene_statics(ts), torch.from_numpy(tpb.pack_camera(tc.derived())),
        torch.from_numpy(np.array(ts.background)), tacc,
        regen._init_state(n, "cpu"), torch.zeros(1, dtype=torch.int32),
        torch.tensor(seeds), 0, total, width=W, npix=npix, sqrt_spp=sq,
        window=window, refill=refill, cadence=cad, max_depth=DEPTH,
        max_contribution=jc.max_contribution)
    jcur = np.asarray(jcur)
    assert tcur[0].item() == jcur[0] == total
    assert abs(tcur[1].item() - jcur[1]) <= 0.001 * jcur[1]
    a, b = np.asarray(jacc)[:total], tacc[:total].numpy()
    mismatched = (~np.isclose(a, b, rtol=1e-3, atol=1e-4)).any(axis=1).mean()
    print(f"mismatched items: {mismatched:.2e}")
    assert mismatched <= 0.01
    assert abs(a.mean() - b.mean()) <= 1e-3 * a.mean()


@pytest.mark.parametrize("total,n,d1,cadence,length", [
    (1000, 1 << 17, 51, 4, 0.0), (600 * 600 * 100, 1 << 17, 51, 8, 2.93),
    (600 * 600 * 10000, 1 << 17, 51, 4, 2.93), (32 * 32 * 16, 4096, 51, 8, 5.5),
    (800 * 800 * 100, 1 << 16, 41, 1, 5.08)])
def test_auto_refill_matches_jax(total, n, d1, cadence, length):
    jc = JCamera(regen_len=length)
    tc = Camera(regen_len=length)
    assert regen._auto_refill(total, n, d1, cadence, tc) \
        == jregen._auto_refill(total, n, d1, cadence, jc)
    assert regen._resolve_cadence(0, tc) == jregen._resolve_cadence(0, jc)
    assert regen._resolve_cadence(5, tc) == 5


def test_checkpoint_resume_bit_exact(tmp_path, monkeypatch):
    """Interrupting after any window and resuming reproduces the
    uninterrupted render bit for bit (same per-window seeds), and a
    completed checkpoint resumes with zero new segments."""
    from go_raytracer_tpu_torch.render import checkpoint as ck

    scene = box_scene()
    cam = Camera(width=16, aspect_ratio=1.0, samples_per_pixel=9, max_depth=3)
    cam.position((0, 2, 6), (0, 1, 0))
    # a small lane pool and short refill so the queue spans several windows
    kw = dict(seed=17, n_lanes=256, refill_len=2, cadence=1, device="cpu")
    img_ref, st_ref = regen.render_regen(scene, cam, **kw)
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
    img_full, _ = regen.render_regen(scene, cam, checkpoint_path=ckpt,
                                     checkpoint_every=1, scene_name="box",
                                     **kw)
    np.testing.assert_array_equal(img_full, img_ref)
    assert len(saved) >= 3
    monkeypatch.setattr(ck, "save", real_save)

    shutil.copy(saved[0], ckpt)
    img_res, st_res = regen.render_regen(scene, cam, checkpoint_path=ckpt,
                                         scene_name="box", **kw)
    np.testing.assert_array_equal(img_res, img_ref)
    assert len(st_res["window_s"]) < st_ref["windows"]

    img_done, st_done = regen.render_regen(scene, cam, checkpoint_path=ckpt,
                                           scene_name="box", **kw)
    np.testing.assert_array_equal(img_done, img_ref)
    assert st_done["segments"] == 0


def test_no_silent_fallbacks(monkeypatch):
    """No GPU and no CPU request: a clear error, on every schedule.
    Unported schedules and routes a scene cannot run (the direct-record
    path on a scene with image textures) raise, and a defocus camera
    renders; and a wrapper handed a CUDA tensor goes for its kernel (here,
    with no card, it fails) instead of taking its plain version."""
    scene, cam = registry.cornell_box()
    cam.width, cam.samples_per_pixel = 8, 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for schedule in ("auto", "queue", "positional"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            regen.render_regen(scene, cam, n_lanes=256, schedule=schedule)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            regen.render_regen(scene, cam, n_lanes=256, schedule=schedule,
                               device="cuda")
    with pytest.raises(NotImplementedError):
        regen.render_regen(scene, cam, n_lanes=256, schedule="reorder",
                           device="cpu")
    with pytest.raises(NotImplementedError):
        regen.render_regen(registry.model_example()[0], cam, n_lanes=256,
                           schedule="queue_ik", device="cpu")
    with pytest.raises(ValueError, match="image textures"):
        regen.render_regen(registry.quads_scene()[0], cam, n_lanes=256,
                           direct_rec=True, device="cpu")
    # a defocus camera renders on every schedule of the fused kernels
    cam.defocus_angle = 0.5
    cam.max_depth = 4
    for schedule in ("auto", "queue", "positional"):
        img, st = regen.render_regen(scene, cam, n_lanes=256,
                                     schedule=schedule, device="cpu")
        assert st["paths"] == 64 and np.isfinite(img).all()
    # no wrapper catches a failed build or launch to take its plain
    # version: the only way to it is the tensor's own `is_cuda` test
    import inspect
    from go_raytracer_tpu_torch.ops import harvest as tph
    for fn in (tpb.bounce_fused_q, tpb.bounce_fused, tpb.bounce_fused_pos,
               tpb.bounce, tph.harvest_levels_into, tph.reverse_harvest_into):
        src = inspect.getsource(fn)
        assert "is_cuda" in src and "try:" not in src \
            and "except" not in src, fn.__name__


def test_window_seeds_are_keyed_by_seed_and_window():
    a = regen.window_seeds(3, 0, 16)
    assert a.dtype == torch.int32 and a.shape == (16,)
    assert torch.equal(a, regen.window_seeds(3, 0, 16))
    assert not torch.equal(a, regen.window_seeds(3, 1, 16))
    assert not torch.equal(a, regen.window_seeds(4, 0, 16))
