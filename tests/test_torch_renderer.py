"""The reference engine's renderer (render/renderer.py) against the JAX
package's `renderer.render`, and the regen paths this engine opens: a
scene with triangle lights (lanternhouse) and the `positional` schedule
on a mesh scene, both on the reference engine's bounce; the CLI with
`--integrator wavefront` and `--backend xla` on the CPU.

The packages draw different random numbers, so renders agree only
statistically. Measured on the CPU over 6 seeds at 32 px, 16 spp, depth
6: a wavefront render's channel mean has a seed-to-seed standard
deviation of 0.0017 (cornellBox) and 0.0019 (book3); MEAN_TOL is four
standard deviations of the difference of two renders. Scene 8 at 32 px,
4 spp: 0.006 per render under `queue` and 0.005 under `positional`, so
MESH_MEAN_TOL is 0.03, tests/test_torch_regen_mesh.py's."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from go_raytracer_tpu.render import renderer as jrenderer
from go_raytracer_tpu.scenes import registry as jreg
from go_raytracer_tpu_torch import cli
from go_raytracer_tpu_torch.integrator import regen
from go_raytracer_tpu_torch.render import renderer
from go_raytracer_tpu_torch.scene import types as TT
from go_raytracer_tpu_torch.scenes import registry

torch.set_num_threads(2)

MEAN_TOL = 0.01
MESH_MEAN_TOL = 0.03
LANTERN = "assets/lanternhouse.obj"


def small(cam, width=32, spp=16, depth=6):
    cam.width, cam.samples_per_pixel, cam.max_depth = width, spp, depth
    return cam


def accounting(st, cam):
    paths = cam.width * cam.image_height * cam.spp_sqrt ** 2
    assert st["paths"] == paths
    assert paths <= st["segments"] <= paths * (cam.max_depth + 1)


@pytest.mark.parametrize("name", ["cornell_box", "book3"])
def test_render_matches_jax_render(name):
    """Port: the kernel backend (K3's plain version) and the tensor-code
    bounce, both in "while" mode; JAX: its XLA engine. Exact accounting,
    channel means within MEAN_TOL, segments per path within 5%."""
    js, jc = getattr(jreg, name)()
    small(jc)
    ji, jst = jrenderer.render(js, jc, key=jax.random.key(0), mode="while",
                               backend="xla", ray_batch=512)
    ji = np.asarray(ji)
    ts = TT.scene_from_numpy(js)
    _, tc = getattr(registry, name)()
    small(tc)
    for backend in ("auto", "xla"):
        ti, tst = renderer.render(ts, tc, seed=1, device="cpu",
                                  backend=backend, ray_batch=512)
        assert tst["backend"] == ("pallas" if backend == "auto" else "xla")
        assert ti.shape == ji.shape and np.isfinite(ti).all()
        accounting(tst, tc)
        assert np.abs(ti.mean((0, 1)) - ji.mean((0, 1))).max() <= MEAN_TOL
        assert abs(tst["segments"] / jst["segments"] - 1) <= 0.05


def test_render_scan_mode_chunks_and_checkpoint(tmp_path):
    """"scan" runs every level and renders what "while" renders on one
    seed, segments included (a dead ray traces nothing); chunks of 128 rays
    in strata groups of 2 render with exact accounting, and their finished
    checkpoint resumes with nothing left to do and the same image."""
    scene, cam = registry.cornell_box()
    small(cam, width=16, spp=4, depth=4)
    a, sa = renderer.render(scene, cam, device="cpu", mode="while")
    b, sb = renderer.render(scene, cam, device="cpu", mode="scan")
    np.testing.assert_array_equal(a, b)
    assert sa["segments"] == sb["segments"]
    ck = str(tmp_path / "ck.npz")
    c, sc = renderer.render(scene, cam, device="cpu", ray_batch=128,
                            strata_per_launch=2, checkpoint_path=ck,
                            checkpoint_every=1)
    accounting(sc, cam)
    d, sd = renderer.render(scene, cam, device="cpu", ray_batch=128,
                            strata_per_launch=2, checkpoint_path=ck)
    np.testing.assert_array_equal(c, d)
    assert sd["segments"] == 0


def test_lanternhouse_renders_through_regen():
    """Triangle lights and a mesh below the BVH threshold: no kernel
    carries the scene, so regen runs the reference engine's bounce with
    the dense triangle class (tests/test_obj_fixture.py's checks)."""
    scene, cam = registry.model_example(obj_path=LANTERN)
    assert scene.has_tri_lights and not scene.has_tri_bvh
    small(cam, width=48, spp=4)
    img, st = regen.render_regen(scene, cam, n_lanes=4096, device="cpu")
    assert st["bounce"] == "wavefront" and st["backend"] == "xla"
    assert np.isfinite(img).all() and img.max() > 0.05
    assert st["segments"] > 0 and st["paths"] == 48 * 27 * 4
    with pytest.raises(NotImplementedError, match="triangle lights"):
        regen.render_regen(scene, cam, n_lanes=4096, device="cpu",
                           backend="pallas")


def test_positional_on_scene8_matches_queue():
    """`positional` on a mesh scene (the reference engine's bounce, the
    JAX package's `_window_impl_pos` level) against `queue` (the ext-mode
    kernel): exact accounting, channel means within MESH_MEAN_TOL."""
    scene, cam = registry.model_example()
    small(cam, spp=4)
    q, sq = regen.render_regen(scene, cam, n_lanes=4096, device="cpu")
    p, sp = regen.render_regen(scene, cam, n_lanes=4096, device="cpu",
                               schedule="positional")
    assert sq["bounce"] == "ext" and sp["bounce"] == "wavefront"
    for st in (sq, sp):
        accounting(st, cam)
    assert np.isfinite(p).all()
    assert np.abs(p.mean((0, 1)) - q.mean((0, 1))).max() <= MESH_MEAN_TOL
    assert abs(sp["segments"] / sq["segments"] - 1) <= 0.05


@pytest.mark.parametrize("extra,backend", [
    (["-S", "7", "--integrator", "wavefront"], "pallas"),
    (["-S", "5", "--integrator", "wavefront", "--backend", "xla", "--mode",
      "scan"], "xla"),
    (["-S", "8", "--integrator", "wavefront", "--max-depth", "3"], "xla"),
    (["-S", "3", "--backend", "xla"], "xla")])
def test_cli_wavefront_and_xla_backend(tmp_path, capsys, extra, backend):
    """Each exits 0 and writes an image; the stats name the bounce: the
    K3 kernel where it carries the scene, else the tensor-code bounce."""
    out = str(tmp_path / "w.ppm")
    rc = cli.main(extra + ["-o", out, "--cpu", "--width", "16", "--spp", "1",
                           "--batch", "256", "--lanes", "1024", "--stats",
                           "--quiet"])
    assert rc == 0 and os.path.getsize(out) > 0
    st = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert st["paths"] > 0 and st["nonfinite"] == 0
    assert st["backend"] == backend
