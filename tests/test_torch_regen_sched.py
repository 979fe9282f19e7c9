"""The port's `queue` and `positional` schedules on dense scenes, on the CPU
(the kernels' plain versions): one cornellBox window of each against the
JAX package's window (Pallas kernels in interpret mode) on the same
per-call seeds and the same lane state, exact item accounting, the
positional pixel mapping, bit-exact checkpoint resume, and statistical
agreement between the schedules."""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_raytracer_tpu.integrator import regen as jregen
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


# ------------------------------------------------ one window against JAX

W, SPP, DEPTH, N, CAD = 32, 16, 50, 4096, 8
NPIX, SQ, TOTAL = W * W, 4, W * W * SPP
REFILL = 4 * (DEPTH + 1)
WINDOW = -(-(REFILL + DEPTH + 1) // CAD) * CAD
OUTER = WINDOW // CAD


def _cornell_pair():
    js, jc = jreg.cornell_box()
    jc.width, jc.samples_per_pixel, jc.max_depth = W, SPP, DEPTH
    tc = Camera(**{f.name: getattr(jc, f.name)
                   for f in dataclasses.fields(Camera)})
    ts = TT.scene_from_numpy(js)
    targs = (tuple(torch.from_numpy(t) for t in tpb.pack_scene(ts)),
             tpb.scene_statics(ts),
             torch.from_numpy(tpb.pack_camera(tc.derived())),
             torch.from_numpy(np.array(ts.background)))
    key = jax.random.fold_in(jax.random.key(7), 0)
    seeds = np.asarray(jax.random.randint(
        key, (OUTER,), jnp.iinfo(jnp.int32).min, jnp.iinfo(jnp.int32).max,
        dtype=jnp.int32))
    return js, jc, targs, key, torch.tensor(seeds)


def test_queue_window_matches_jax_window():
    """cornellBox at 32 px, 16 spp, depth 50, 4096 lanes, cadence 8: one
    `queue` window (refill 204, 256 levels, 26 refill rows) of the port
    against the JAX window with the fused harvest, from the JAX package's
    initial lane state and per-call seeds. Both trace the same paths up
    to float rounding; a lane that branches the other way changes its path
    and, through the refill's ranks, later assignments."""
    js, jc, targs, key, seeds = _cornell_pair()
    jstate = jregen._init_state(N, jnp.float32)
    jacc, _, jcur = jregen._window_impl(
        js, jc.derived(), jnp.zeros((TOTAL + N, 3), jnp.float32), jstate,
        jnp.int32(0), key, jnp.int32(0), jnp.int32(TOTAL), width=W, npix=NPIX,
        sqrt_spp=SQ, window=WINDOW, refill=REFILL, cadence=CAD, n_u=9,
        max_depth=DEPTH, max_contribution=jc.max_contribution,
        use_pallas=True, interpret=True, inkernel=False, harvest="fused")
    tacc = torch.zeros((TOTAL + N, 3))
    state = regen.queue_state_from_numpy([np.asarray(x) for x in jstate],
                                         "cpu")
    _, _, tcur = regen._queue_window(
        *targs, tacc, state, torch.tensor(0), seeds, 0, TOTAL, width=W,
        npix=NPIX, sqrt_spp=SQ, window=WINDOW, refill=REFILL, cadence=CAD,
        max_depth=DEPTH, max_contribution=jc.max_contribution)
    jcur = np.asarray(jcur)
    assert tcur[0].item() == jcur[0] == TOTAL
    assert tcur[2].item() == WINDOW
    assert abs(tcur[1].item() - jcur[1]) <= 0.001 * jcur[1]
    a, b = np.asarray(jacc)[:TOTAL], tacc[:TOTAL].numpy()
    mismatched = (~np.isclose(a, b, rtol=1e-3, atol=1e-4)).any(axis=1).mean()
    print(f"queue window: mismatched items {mismatched:.2e}")
    assert mismatched <= 2e-3
    assert abs(a.mean() - b.mean()) <= 1e-3 * a.mean()


def test_positional_window_matches_jax_window():
    """The same configuration under `positional`: the (3, G, N) slot
    accumulator, the per-lane start counts and the cursor pair against the
    JAX window, from the JAX package's `_init_state_pos`."""
    js, jc, targs, key, seeds = _cornell_pair()
    jq, jb, jf, jG = jregen._pos_tables(NPIX, SPP, N)
    quota, lane_base, first_pix, G = regen.pos_tables(NPIX, SPP, N)
    np.testing.assert_array_equal(quota, jq)
    np.testing.assert_array_equal(lane_base, jb)
    np.testing.assert_array_equal(first_pix, jf)
    assert G == jG
    jstate = jregen._init_state_pos(N, jnp.float32, True, jq, jb, SPP, W)
    state = regen.pos_state_from_numpy([np.asarray(x) for x in jstate], "cpu")
    fresh = regen._init_state_pos(N, "cpu", quota, lane_base, SPP, W)
    assert all(torch.equal(a, b) for a, b in zip(state, fresh))
    jB = [jnp.zeros((G, N), jnp.float32) for _ in range(3)]
    jBr, jBg, jBb, jstate2, jcur = jregen._window_impl_pos(
        js, jc.derived(), *jB, jstate, jnp.asarray(jq), jnp.asarray(jb),
        jnp.asarray(jf), key, width=W, npix=NPIX, sqrt_spp=SQ, n_strata=SPP,
        G=G, window=WINDOW, refill=REFILL, cadence=CAD, n_u=9,
        max_depth=DEPTH, max_contribution=jc.max_contribution,
        use_pallas=True, interpret=True)
    B = torch.zeros((3, G, N))
    _, state, tcur = regen._pos_window(
        *targs, B, state, torch.from_numpy(quota),
        torch.from_numpy(first_pix.astype(np.float32)), seeds, width=W,
        sqrt_spp=SQ, G=G, window=WINDOW, refill=REFILL, cadence=CAD,
        max_depth=DEPTH, max_contribution=jc.max_contribution)
    jcur = np.asarray(jcur)
    assert tcur[0].item() == jcur[0] == TOTAL
    assert abs(tcur[1].item() - jcur[1]) <= 0.001 * jcur[1]
    jk = jregen._pos_state_k(jstate2, jq, True)
    np.testing.assert_array_equal(regen._pos_state_k(state, quota), jk)
    a = np.stack([np.asarray(x) for x in (jBr, jBg, jBb)])
    b = B.numpy()
    mismatched = (~np.isclose(a, b, rtol=1e-3, atol=1e-4)).any(axis=0).mean()
    print(f"positional window: mismatched slots {mismatched:.2e}")
    assert mismatched <= 2e-3
    assert abs(a.sum() - b.sum()) <= 1e-3 * a.sum()
    # and the film of both accumulators
    fa = jregen._pos_film(*a, jf, NPIX, SPP, W, W)
    fb = regen.pos_film(b, first_pix, NPIX, SPP, W, W)
    assert (~np.isclose(fa, fb, rtol=1e-3, atol=1e-4)).any(-1).mean() <= 0.02


# ------------------------------------------------------ exact accounting

@pytest.mark.parametrize("schedule,lanes,width", [
    ("queue", 4096, 32), ("queue", 256, 16),
    ("positional", 256, 16),     # 9 items per lane
    ("positional", 4096, 16),    # lanes with no item at all
    ("positional", 256, 48)])    # blocks spanning several pixels
def test_every_item_contributes_exactly_once(schedule, lanes, width):
    """All-miss scene, background 1: the image is exactly 1.0 and every
    path is one segment — no item skipped, none delivered twice, under the
    queue's rank refill + row harvest and under the positional per-lane
    blocks + slot accumulation + film."""
    cam = Camera(width=width, aspect_ratio=1.0, samples_per_pixel=9,
                 max_depth=4)
    cam.position((0, 0, 5), (0, 0, 0))
    img, st = regen.render_regen(quad_scene(), cam, seed=0, n_lanes=lanes,
                                 cadence=3, schedule=schedule, device="cpu")
    np.testing.assert_array_equal(img, 1.0)
    assert st["paths"] == st["segments"] == width * width * 9
    assert st["schedule"] == schedule and st["nonfinite"] == 0


@pytest.mark.parametrize("schedule", ["queue", "positional"])
def test_multi_window_exact(schedule):
    """More items than one window can start: the cursor (queue) and the
    per-lane pointers (positional) carry across windows exactly."""
    cam = Camera(width=64, aspect_ratio=1.0, samples_per_pixel=16, max_depth=3)
    cam.position((0, 0, 5), (0, 0, 0))
    img, st = regen.render_regen(quad_scene((0.25, 0.5, 0.75)), cam, seed=1,
                                 n_lanes=4096, cadence=2, refill_len=4,
                                 schedule=schedule, device="cpu")
    assert st["windows"] > 1 and st["segments"] == 64 * 64 * 16
    for c, v in enumerate((0.25, 0.5, 0.75)):
        np.testing.assert_array_equal(img[..., c], np.float32(v))


def test_positional_pixel_mapping_matches_queue():
    """An emissive quad on a black background renders deterministically per
    ray (first hit -> emission), so away from the quad's silhouette the
    positional and queue schedules give IDENTICAL pixels: this pins the
    pointer advance, its retreat and the slot -> pixel film (a wrong carry
    would keep the means and move radiance to a neighbouring pixel). The
    non-square image and 256 lanes make blocks that wrap pixel rows."""
    b = SceneBuilder(background=(0, 0, 0))
    lq = b.quad((-2.0, -1.5, 0.0), (4, 0, 0), (0, 3, 0),
                b.diffuse_light((2.0, 1.0, 0.5)))
    b.add_light(lq)
    scene = b.build()
    cam = Camera(width=24, aspect_ratio=1.5, samples_per_pixel=4, max_depth=2)
    cam.position((0, 0, 4), (0, 0, 0))
    kw = dict(seed=0, n_lanes=256, cadence=2, device="cpu")
    iq, _ = regen.render_regen(scene, cam, schedule="queue", **kw)
    ip, _ = regen.render_regen(scene, cam, schedule="positional", **kw)
    ik, _ = regen.render_regen(scene, cam, **kw)
    mismatch = np.abs(iq - ip).max(axis=-1) > 1e-6
    assert mismatch.mean() < 0.25, f"{mismatch.mean():.2f} pixels differ"
    hit = (iq == np.array([2.0, 1.0, 0.5], np.float32)).all(axis=-1)
    interior = hit.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            interior &= np.roll(np.roll(hit, dy, 0), dx, 1)
    interior[0, :] = interior[-1, :] = False
    interior[:, 0] = interior[:, -1] = False
    assert interior.sum() > 10
    np.testing.assert_array_equal(ip[interior], iq[interior])
    np.testing.assert_array_equal(ik[interior], iq[interior])
    outside = ~hit
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            outside &= np.roll(np.roll(~hit, dy, 0), dx, 1)
    assert outside.sum() > 10 and not ip[outside].any()


# ------------------------------------------------------ checkpoint resume

@pytest.mark.parametrize("schedule", ["positional", "queue"])
def test_schedule_checkpoint_resume_bit_exact(tmp_path, monkeypatch,
                                              schedule):
    """Interrupting after any window and resuming reproduces the
    uninterrupted render bit for bit (the positional pointer planes are
    rebuilt from the stored start counts k), and a completed checkpoint
    resumes with zero new segments. A checkpoint of the other schedule is
    not taken for this one's."""
    from go_raytracer_tpu_torch.render import checkpoint as ck

    scene = box_scene()
    cam = Camera(width=16, aspect_ratio=1.0, samples_per_pixel=9, max_depth=3)
    cam.position((0, 2, 6), (0, 1, 0))
    kw = dict(seed=17, n_lanes=256, refill_len=4, cadence=2,
              schedule=schedule, device="cpu")
    img_ref, st_ref = regen.render_regen(scene, cam, **kw)
    assert st_ref["windows"] >= 3

    ckpt = str(tmp_path / "r.npz")
    saved = []
    real_save = ck.save

    def capture_save(path, acc, next_item, meta, extra=None):
        real_save(path, acc, next_item, meta, extra)
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
    if schedule == "positional":
        acc, _, meta = ck.load(saved[0])
        G = regen.pos_tables(16 * 16, 9, 256)[3]
        assert acc.shape == (3, G, 256)
        assert bytes(meta["schedule"]) == b"positional"
        assert ck.load_extra(saved[0])["k"].shape == (256,)

    for snap in (saved[0], saved[1]):
        shutil.copy(snap, ckpt)
        img_res, st_res = regen.render_regen(scene, cam, checkpoint_path=ckpt,
                                             scene_name="box", **kw)
        np.testing.assert_array_equal(img_res, img_ref)
        assert len(st_res["window_s"]) < st_ref["windows"]

    img_done, st_done = regen.render_regen(scene, cam, checkpoint_path=ckpt,
                                           scene_name="box", **kw)
    np.testing.assert_array_equal(img_done, img_ref)
    assert st_done["segments"] == 0

    other = "queue" if schedule == "positional" else "positional"
    img_o, st_o = regen.render_regen(scene, cam, checkpoint_path=ckpt,
                                     scene_name="box",
                                     **{**kw, "schedule": other})
    assert st_o["segments"] > 0 and st_o["schedule"] == other


# ------------------------------------------------- statistical agreement

def test_positional_statistically_matches_queue():
    """cornellBox at 16 px: the two schedules are different unbiased
    estimators of one image; their means agree within the measured
    seed-to-seed spread."""
    scene, cam = registry.cornell_box()
    cam.width, cam.aspect_ratio = 16, 1.0
    cam.samples_per_pixel, cam.max_depth = 16, 4
    mean = lambda s, k: float(regen.render_regen(
        scene, cam, seed=k, n_lanes=256, schedule=s, device="cpu")[0].mean())
    mq = [mean("queue", k) for k in range(2)]
    mp = [mean("positional", k) for k in range(2)]
    spread = max(mq) - min(mq) + max(mp) - min(mp) + 0.01
    assert abs(np.mean(mq) - np.mean(mp)) < 3 * spread


def test_queue_matches_queue_ik_statistically():
    """The same scene through `queue` (refill before each call) and
    `queue_ik` (refill inside the kernel): independent random streams, so
    the images agree statistically, tightly at this sample count."""
    cam = Camera(width=24, aspect_ratio=1.0, samples_per_pixel=36, max_depth=8)
    cam.position((0, 2, 8), (0, 1, 0))
    img_q, st_q = regen.render_regen(box_scene(), cam, seed=3, n_lanes=4096,
                                     schedule="queue", cadence=2,
                                     device="cpu")
    img_k, st_k = regen.render_regen(box_scene(), cam, seed=4, n_lanes=4096,
                                     schedule="queue_ik", cadence=2,
                                     device="cpu")
    assert st_q["paths"] == st_k["paths"]
    assert st_q["schedule"] == "queue" and st_k["schedule"] == "queue_ik"
    d = np.abs(img_q - img_k).mean()
    assert d / (np.abs(img_q).mean() + 1e-3) < 0.15


def test_queue_ik_occupancy_beats_queue_on_deep_queue():
    """A queue much deeper than the lane pool and short paths: refilling
    every level keeps clearly more lanes busy than refilling every
    `cadence` levels, on the same window; the totals agree closely."""
    cam = Camera(width=16, aspect_ratio=1.0, samples_per_pixel=256,
                 max_depth=8)
    cam.position((0, 2, 8), (0, 1, 0))
    kw = dict(seed=5, n_lanes=4096, cadence=4, refill_len=36, device="cpu")
    _, st_q = regen.render_regen(box_scene(), cam, schedule="queue", **kw)
    _, st_k = regen.render_regen(box_scene(), cam, schedule="queue_ik", **kw)
    assert st_k["occupancy"] > 1.5 * st_q["occupancy"]
    assert abs(st_k["segments"] - st_q["segments"]) < 0.02 * st_q["segments"]


def test_schedule_resolution_and_refusals():
    """`auto` stays queue_ik on a dense scene; a mesh scene runs
    `positional` on the reference engine's bounce, and an unknown schedule
    raises."""
    scene, cam = registry.cornell_box()
    cam.width, cam.samples_per_pixel, cam.max_depth = 8, 1, 2
    _, st = regen.render_regen(scene, cam, n_lanes=256, device="cpu")
    assert st["schedule"] == "queue_ik"
    mesh, mcam = registry.model_example()
    mcam.width, mcam.samples_per_pixel = 8, 1
    _, ms = regen.render_regen(mesh, mcam, n_lanes=256, schedule="positional",
                               device="cpu")
    assert ms["schedule"] == "positional" and ms["bounce"] == "wavefront"
    with pytest.raises(NotImplementedError):
        regen.render_regen(scene, cam, n_lanes=256, schedule="lifo",
                           device="cpu")
