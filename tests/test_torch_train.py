"""The port's scene parameters and training step (`parallel/mesh.py`)
against the JAX package's: the same leaves, a scene that carries new
parameters without touching its parent, Adam's update against optax's,
the one-device train step and the inverse-rendering example; and the
forward-only K3 kernel refusing to run where autograd needs its
derivative."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from go_raytracer_tpu.parallel import mesh as jmesh
from go_raytracer_tpu.scenes import registry as jreg
from go_raytracer_tpu_torch.integrator import wavefront as twf
from go_raytracer_tpu_torch.ops import trace as ttrace
from go_raytracer_tpu_torch.parallel import mesh as tmesh
from go_raytracer_tpu_torch.render import camera as tcam
from go_raytracer_tpu_torch.scene.builder import SceneBuilder
from go_raytracer_tpu_torch.scenes import registry as treg

torch.set_num_threads(2)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["cornell_box", "book1", "book3",
                                  "cornell_smoke", "simple_light",
                                  "quads_scene"])
def test_extract_params_equals_jax(name):
    """The port's registry scene on a device gives JAX's leaves, under
    JAX's names, value for value."""
    js, _ = getattr(jreg, name)()
    ts, _ = getattr(treg, name)()
    jp = jmesh.extract_params(js)
    tp = tmesh.extract_params(ttrace.to_device(ts, "cpu"))
    assert set(tp) == set(jp)
    for k in jp:
        assert tp[k].dtype == torch.float32 and tp[k].device.type == "cpu"
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]), k)


def test_params_from_numpy_round_trips():
    js, _ = jreg.book3()
    jp = {k: np.asarray(v) for k, v in jmesh.extract_params(js).items()}
    tp = tmesh.params_from_numpy(jp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].numpy(), jp[k])
    ts, _ = treg.book3()
    sc = tmesh.apply_params(ttrace.to_device(ts, "cpu"), tp)
    back = tmesh.extract_params(sc)
    assert all(back[k] is tp[k] for k in tp)
    with pytest.raises(ValueError):
        tmesh.params_from_numpy({"albedo": jp["tex_color"]})


def _cornell(n=1024, seed=0):
    scene, cam = treg.cornell_box()
    ds = ttrace.to_device(scene, "cpu")
    rs = np.random.default_rng(seed)
    npix = cam.width * cam.image_height
    pid = torch.from_numpy(rs.integers(0, npix, n))
    s = torch.zeros(n)
    u = torch.from_numpy(rs.uniform(0, 1, (n, 5)).astype(np.float32))
    o, d, t = tcam.generate_rays(cam.derived(), cam.width, pid, s, s, u)
    return scene, ds, o, d, t


def _render(ds, o, d, t, backend, seed=9, depth=6):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        return twf.radiance(ds, o, d, t, g, depth, 10.0, backend=backend)[0]


def test_apply_params_leaves_the_parent_unchanged_and_packs_its_own():
    """apply_params gives a new scene: the parent's tensors, tables and
    prepared K3 launch stay as they were, and K3 (its plain version on
    the CPU) renders the new scene with the new parameters, as the tensor
    bounce does; an in-place update is packed again."""
    scene, ds, o, d, t = _cornell()
    before = {k: (v, v.clone()) for k, v in tmesh.extract_params(ds).items()}
    tables = (ds.textures, ds.materials, ds.media)
    k3 = twf.kernel_launch(ds)
    k3_prims = k3.tables[0].clone()
    light = int(np.where(scene.materials.kind == 3)[0][0])
    light_tex = int(scene.materials.tex_id[light])
    p = {k: v.clone() for k, v in tmesh.extract_params(ds).items()}
    p["tex_color"][light_tex] *= 0.5
    p["background"] += 0.25
    new = tmesh.apply_params(ds, p)

    for k, (v, val) in before.items():
        assert tmesh.extract_params(ds)[k] is v
        assert torch.equal(v, val), k
    assert (ds.textures, ds.materials, ds.media) == tables
    assert twf.kernel_launch(ds) is k3 and torch.equal(k3.tables[0], k3_prims)
    assert tmesh.extract_params(new)["tex_color"] is p["tex_color"]

    base = _render(ds, o, d, t, "xla")
    for target in (new, ds):
        kernel = _render(target, o, d, t, "pallas")
        plain = _render(target, o, d, t, "xla")
        torch.testing.assert_close(kernel, plain, rtol=2e-3, atol=2e-3)
    assert not torch.allclose(_render(new, o, d, t, "pallas"), base,
                              rtol=1e-2, atol=1e-2)
    assert twf.kernel_launch(new) is not k3

    # an in-place update (as an optimizer makes) is seen by the next launch
    launch = twf.kernel_launch(new)
    with torch.no_grad():
        p["tex_color"][light_tex] *= 2.0
    assert twf.kernel_launch(new) is not launch
    torch.testing.assert_close(_render(new, o, d, t, "pallas"),
                               _render(new, o, d, t, "xla"), rtol=2e-3,
                               atol=2e-3)


def test_apply_params_refuses_another_shape():
    _, ds, *_ = _cornell(n=128)
    with pytest.raises(ValueError):
        tmesh.apply_params(ds, {"background": torch.zeros(4)})
    with pytest.raises(ValueError):
        tmesh.apply_params(ds, {"albedo": torch.zeros(3)})


@pytest.mark.parametrize("backend", ["pallas", "auto"])
def test_kernel_backend_refuses_a_gradient(backend):
    """K3 is forward-only: with a leaf that requires a gradient (or a ray
    tensor that does) it raises rather than give a zero gradient, and
    "auto" does not switch to the tensor bounce; under no_grad it runs."""
    _, ds, o, d, t = _cornell(n=256)
    p = {k: v.clone().requires_grad_(True)
         for k, v in tmesh.extract_params(ds).items()}
    sc = tmesh.apply_params(ds, p)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="forward-only"):
        twf.radiance(sc, o, d, t, g, 2, 10.0, backend=backend)
    with pytest.raises(ValueError, match="forward-only"):
        twf.radiance(ds, o.clone().requires_grad_(True), d, t, g, 2, 10.0,
                     backend=backend)
    with torch.no_grad():
        L, _ = twf.radiance(sc, o, d, t, g, 2, 10.0, backend=backend)
    assert torch.isfinite(L).all()
    L, _ = twf.radiance(sc, o, d, t, g, 2, 10.0, backend="xla")
    L.mean().backward()
    assert p["tex_color"].grad.abs().max() > 0


def test_adam_update_equals_optax():
    """torch.optim.Adam's update from the same gradients equals optax's
    adam within 1e-6, three steps (the bias corrections included)."""
    rs = np.random.default_rng(0)
    js, _ = jreg.cornell_smoke()
    p0 = {k: np.asarray(v) for k, v in jmesh.extract_params(js).items()}
    grads = [{k: rs.normal(0, 1, v.shape).astype(np.float32) * 10.0 ** -i
              for k, v in p0.items()} for i in range(3)]
    opt = optax.adam(0.05)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(jp)
    tp = {k: v.requires_grad_(True)
          for k, v in tmesh.params_from_numpy(p0).items()}
    topt = torch.optim.Adam(list(tp.values()), lr=0.05)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in tp.items():
            v.grad = torch.from_numpy(g[k])
        topt.step()
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=0, atol=1e-6)


def _tiny_scene():
    b = SceneBuilder(background=(0.1, 0.15, 0.2))
    b.quad((-5, 0, -5), (10, 0, 0), (0, 0, 10), b.lambertian((0.6, 0.5, 0.4)))
    b.sphere((0, 1, 0), 1.0, b.metal((0.9, 0.9, 0.9), 0.1))
    q = b.quad((-1, 5, -1), (2, 0, 0), (0, 0, 2), b.diffuse_light((4, 4, 4)))
    b.add_light(q)
    return b.build()


def test_train_step_runs_and_improves():
    """test_parallel.py's train step on one device: five steps toward a
    black target, finite losses, the last below the first; every leaf
    gets a gradient (zero where the render does not read it)."""
    cam = tcam.Camera(width=8, aspect_ratio=1.0, samples_per_pixel=1,
                      max_depth=2)
    cam.position((0, 2, 8), (0, 1, 0))
    train_step, params, opt = tmesh.make_train_step(
        _tiny_scene(), cam, n_rays=64, n_sample_batches=2, max_depth=2,
        learning_rate=5e-2, device="cpu",
        generator=torch.Generator().manual_seed(0))
    assert isinstance(opt, torch.optim.Adam)
    assert all(v.requires_grad for v in params.values())
    ids = tmesh.pixel_ids(64, 2)
    target = torch.zeros((64, 3))
    losses = [train_step(params, ids, target) for _ in range(5)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert all(v.grad is not None for v in params.values())
    with pytest.raises(ValueError):
        train_step(params, tmesh.pixel_ids(64, 3), target)


def test_inverse_rendering_example_fits_on_the_cpu(tmp_path):
    """examples/inverse_rendering_torch.py --cpu, 30 steps at a small
    width: the loss falls and both free parameters move toward the
    truth; the .npz has the JAX example's fields. 16 spp keeps the
    renders' noise in the loss (a step's standard deviation ~0.014 at the
    start, against a fall of ~0.02 in the mean of ten steps) from
    hiding the fit; at lr 0 the mean does not fall."""
    out = tmp_path / "ir.npz"
    r = subprocess.run(
        [sys.executable, os.path.join(_ROOT, "examples",
                                      "inverse_rendering_torch.py"),
         "--cpu", "--steps", "30", "--lr", "0.1", "--width", "16",
         "--spp", "16", "--out", str(out)],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-2000:]
    d = np.load(out)
    assert set(d.files) == {"losses", "albedo_err", "emit_err", "true_albedo",
                            "recovered_albedo", "true_emission",
                            "recovered_emission", "target", "final"}
    losses = d["losses"]
    assert np.isfinite(losses).all() and losses.shape == (30,)
    assert losses[-10:].mean() < losses[:10].mean()
    assert d["emit_err"][-1] < d["emit_err"][0]
    assert d["albedo_err"][-1] < d["albedo_err"][0]
    assert d["target"].shape == d["final"].shape == (256, 3)


def test_inverse_rendering_example_needs_a_gpu_without_cpu(tmp_path):
    r = subprocess.run(
        [sys.executable, os.path.join(_ROOT, "examples",
                                      "inverse_rendering_torch.py"),
         "--steps", "1", "--out", str(tmp_path / "x.npz")],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0 and "CUDA is not available" in r.stderr
