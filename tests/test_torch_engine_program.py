"""The reference engine and the gradient step as device programs
(integrator/wavefront.radiance on fixed buffers, render/renderer.render,
parallel/mesh.make_train_step), held on the CPU against the JAX package
and against the earlier host loops they replace.

On the CPU every level runs eagerly (stats "graph": false); the code is
the code the card captures as one CUDA graph a level or a step. The
radiance tolerances are tests/test_torch_wavefront.py's; the restructured
loops (the renderer's strata, the train step) must give the earlier
loops' bits, since they draw the same numbers in the same order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_raytracer_tpu.integrator import wavefront as jwf
from go_raytracer_tpu_torch.integrator import regen
from go_raytracer_tpu_torch.integrator import wavefront as twf
from go_raytracer_tpu_torch.ops import _cuda
from go_raytracer_tpu_torch.ops import trace as ttrace
from go_raytracer_tpu_torch.parallel import mesh as tmesh
from go_raytracer_tpu_torch.render import camera as tcam
from go_raytracer_tpu_torch.render import renderer
from go_raytracer_tpu_torch.scene.builder import SceneBuilder
from go_raytracer_tpu_torch.scenes import registry
from tests.test_torch_trace_dense import scene_rays
from tests.test_torch_wavefront import ATOL, FLAG_AGREE, RTOL, jax_uniforms

torch.set_num_threads(2)

N = 1024
DEPTH, MAX_C = 8, 10.0


def old_radiance(ds, o, d, time, gen, max_depth, max_contribution, mode,
                 backend="xla", uniforms=None):
    """The reference engine's radiance as a host loop over lists (the
    port's form before its levels ran on fixed buffers): one host read a
    level in mode "while"."""
    n = o.shape[0]
    kernel = twf.use_kernel(ds, n, backend)
    k3 = twf.kernel_launch(ds) if kernel else None
    n_u = twf.N_FIXED_U + ds.media.kind.shape[0]
    alive = torch.ones((n,), dtype=torch.bool)
    Es, Ws, CFs = [], [], []
    segments = 0
    for s in range(max_depth + 1):
        if mode == "while" and s > 0 and not bool(alive.any()):
            break
        u = uniforms[s] if uniforms is not None else torch.rand(
            (n, n_u), generator=gen, dtype=o.dtype)
        if kernel:
            E, W, cf, o_n, d_n, alive_n, _ = k3(o, d, time, alive, u)
        else:
            E, W, cf, o_n, d_n, alive_n = twf._bounce(ds, o, d, time, alive,
                                                      u)
        Es.append(torch.where(~alive[:, None], 0.0, E))
        Ws.append(torch.where(~alive[:, None], 0.0, W))
        CFs.append(cf & alive)
        segments += int(alive.sum())
        o, d, alive = o_n, d_n, alive_n
    L = torch.zeros((n, 3), dtype=o.dtype)
    for E, W, cf in zip(reversed(Es), reversed(Ws), reversed(CFs)):
        raw = E + W * L
        L = torch.where(cf[:, None],
                        twf.clamp_contribution(raw, max_contribution), raw)
    return L, segments, len(Es)


@pytest.mark.parametrize("name,mode,backend", [
    ("cornell_box", "scan", "xla"), ("cornell_box", "while", "pallas"),
    ("book3", "while", "xla"), ("cornell_smoke", "scan", "pallas")])
def test_fixed_buffer_radiance_matches_jax(name, mode, backend):
    """Levels on the fixed buffers (records written at a device level
    index, the reverse combine over the buffers), fed JAX's uniforms:
    JAX's L and segments within test_torch_wavefront.py's tolerances, in
    both modes, on the tensor bounce and on K3's plain version; the
    stats name the levels recorded and run, and say the levels did not
    replay as a graph."""
    js, ds, o, d, t = scene_rays(name, n=N, seed=5)
    key = jax.random.key(7)
    jl, jst = jwf.radiance(js, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
                           key, DEPTH, MAX_C, mode=mode)
    us = torch.from_numpy(jax_uniforms(key, DEPTH + 1, N, 9 + js.media.count))
    tl, st = twf.radiance(ds, *(torch.from_numpy(x) for x in (o, d, t)),
                          None, DEPTH, MAX_C, mode=mode, backend=backend,
                          uniforms=us)
    frac = FLAG_AGREE.get(name, 0.995)
    ok = np.isclose(np.asarray(jl), tl.numpy(), rtol=RTOL, atol=ATOL).all(-1)
    assert ok.mean() >= frac, ok.mean()
    js_seg = int(jst["segments"])
    assert isinstance(st["segments"], torch.Tensor) \
        and st["segments"].dim() == 0
    assert abs(int(st["segments"]) - js_seg) <= (1 - frac) * js_seg * DEPTH
    assert st["graph"] is False
    if mode == "scan":
        assert st["levels"] == st["levels_run"] == DEPTH + 1
    else:
        assert int(st["levels"]) == st["levels_run"] <= DEPTH + 1
    # the same bits as the list loop it replaces, on the same uniforms
    ol, oseg, olev = old_radiance(ds, *(torch.from_numpy(x) for x in (o, d, t)),
                                  None, DEPTH, MAX_C, mode, backend, us)
    assert torch.equal(tl, ol) and int(st["segments"]) == oseg
    assert mode == "scan" or int(st["levels"]) == olev


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_while_drained_late_matches_at_once(backend, monkeypatch):
    """Mode "while" with the drain seen three levels late, as the card's
    event-behind read may see it: the levels run past the drain record
    only dead lanes, so L and segments are those of the drain seen at
    once, bit for bit; `levels` stays the levels recorded and
    `levels_run` counts the extra ones."""
    _, ds, o, d, t = scene_rays("cornell_box", n=N, seed=8)
    args = [torch.from_numpy(x) for x in (o, d, t)]
    depth = 40
    ref, st_ref = twf.radiance(ds, *args, torch.Generator().manual_seed(3),
                               depth, MAX_C, mode="while", backend=backend)
    assert st_ref["levels_run"] == int(st_ref["levels"]) < depth + 1 - 3
    orig = _cuda.DrainWatch.drained
    late = {}

    def drained(self):
        seen = orig(self)
        if seen:
            late[id(self)] = late.get(id(self), 0) + 1
        return seen and late[id(self)] > 3
    monkeypatch.setattr(_cuda.DrainWatch, "drained", drained)
    L, st = twf.radiance(ds, *args, torch.Generator().manual_seed(3), depth,
                         MAX_C, mode="while", backend=backend)
    assert torch.equal(L, ref)
    assert int(st["segments"]) == int(st_ref["segments"])
    assert int(st["levels"]) == int(st_ref["levels"])
    assert st["levels_run"] == st_ref["levels_run"] + 3


def test_levels_replay_one_level_at_every_depth():
    """What the card captures: `Levels.level_body` (the bounce, the
    records at the device index `lvl`, the state update, lvl + 1) run
    again and again on the same buffers, and `combine_body` over every
    row, give the eager form's L, segments and levels recorded bit for
    bit; the rows past the drain stay 0."""
    _, ds, o, d, t = scene_rays("cornell_smoke", n=N, seed=4)
    args = [torch.from_numpy(x) for x in (o, d, t)]
    depth = 12
    n_u = twf.N_FIXED_U + ds.media.kind.shape[0]
    ref, st = twf.radiance(ds, *args, torch.Generator().manual_seed(6), depth,
                           MAX_C, mode="while")
    lv = twf.Levels(N, depth + 1, n_u, torch.float32, torch.device("cpu"),
                    (), kernel=False)
    lv.begin(*args)
    gen = torch.Generator().manual_seed(6)
    bounce = lambda *a: twf._bounce(ds, *a)
    for _ in range(st["levels_run"]):
        lv.u.uniform_(generator=gen)
        lv.level_body(bounce)
    assert int(lv.lvl) == st["levels_run"]
    lv.combine_body(MAX_C)
    assert torch.equal(lv.L, ref)
    assert int(lv.seg) == int(st["segments"])
    assert int(lv.rec_levels) == int(st["levels"])
    assert not lv.rec.E[st["levels_run"]:].any()


def test_uniform_draws_into_fixed_buffers_equal_torch_rand():
    """A buffer filled with `uniform_(generator=)` takes the numbers
    `torch.rand` of its shape takes from the same generator, draw after
    draw; `StepUniforms.draw` takes the camera's then each level's, as
    `render_batches` draws them, and from `KeyedUniforms` the numbers of
    the keyed stream."""
    n, n_u, levels = 300, 11, 4
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    uni = tmesh.StepUniforms.empty(n, levels, n_u, "cpu")
    uni.draw(g1)
    assert torch.equal(uni.camera, torch.rand((n, tcam.N_U_RAYGEN),
                                              generator=g2))
    for s in range(levels):
        assert torch.equal(uni.levels[s], torch.rand((n, n_u), generator=g2))
    buf = torch.empty((n, n_u))
    assert torch.equal(buf.uniform_(generator=g1),
                       torch.rand((n, n_u), generator=g2))
    # two draws into one buffer differ: a replayed step reads new numbers
    first = buf.clone()
    assert not torch.equal(buf.uniform_(generator=g1), first)
    keyed = tmesh.KeyedUniforms(5, stream=2)
    uni.draw(keyed)
    ray = keyed.rays(torch.arange(n), n_u, levels)
    assert torch.equal(uni.camera, ray.camera())
    assert all(torch.equal(uni.levels[s], ray[s]) for s in range(levels))


def old_render(scene, cam, seed, ray_batch, strata_per_launch, backend):
    """The renderer's stratum loop before this restructure: the camera's
    numpy vectors, the list-loop radiance, segments read every stratum."""
    ds = ttrace.to_device(scene, "cpu")
    arrays = cam.derived()
    h, w = cam.image_height, cam.width
    npix, sq = h * w, cam.spp_sqrt
    total = sq * sq
    chunk = min(ray_batch, -(-npix // 128) * 128)
    nchunks = -(-npix // chunk)
    k = min(strata_per_launch or total, total)
    acc = torch.zeros((nchunks * chunk, 3))
    segments = 0
    for group in range(-(-total // k)):
        for c in range(nchunks):
            gen = renderer.launch_generator(seed, group * nchunks + c, "cpu")
            ids = torch.arange(c * chunk, (c + 1) * chunk)
            for i in range(min(k, total - group * k)):
                stratum = group * k + i
                s_i = torch.full((chunk,), float(stratum // sq))
                s_j = torch.full((chunk,), float(stratum % sq))
                u_cam = torch.rand((chunk, tcam.N_U_RAYGEN), generator=gen)
                o, d, t = tcam.generate_rays(arrays, w, ids, s_i, s_j, u_cam)
                L, seg, _ = old_radiance(ds, o, d, t, gen, cam.max_depth,
                                         cam.max_contribution, "while",
                                         backend)
                acc[c * chunk:(c + 1) * chunk] += L
                segments += seg
    return (acc[:npix].reshape(h, w, 3) / total).numpy(), segments


@pytest.mark.parametrize("name,backend", [("cornell_box", "auto"),
                                          ("book3", "xla")])
def test_render_matches_the_stratum_loop(name, backend):
    """`render` (the camera on the device once, segments and levels added
    on the device and read once) against the stratum loop it replaces,
    over several groups and chunks: the same image and segments, bit for
    bit; stats "graph" false on the CPU, levels run = levels recorded."""
    scene, cam = getattr(registry, name)()
    cam.width, cam.samples_per_pixel, cam.max_depth = 24, 9, 6
    img, st = renderer.render(scene, cam, seed=3, ray_batch=256,
                              strata_per_launch=4, backend=backend,
                              device="cpu")
    ref, seg = old_render(scene, cam, 3, 256, 4, backend)
    assert np.array_equal(img, ref)
    assert st["segments"] == seg and isinstance(st["segments"], int)
    assert st["graph"] is False
    assert st["levels_run"] == st["levels"] > 0


def _tiny_scene():
    b = SceneBuilder(background=(0.1, 0.15, 0.2))
    b.quad((-5, 0, -5), (10, 0, 0), (0, 0, 10), b.lambertian((0.6, 0.5, 0.4)))
    b.sphere((0, 1, 0), 1.0, b.metal((0.9, 0.9, 0.9), 0.1))
    b.sphere((1.5, 0.6, 1), 0.6, b.dielectric(1.5))
    q = b.quad((-1, 5, -1), (2, 0, 0), (0, 0, 2), b.diffuse_light((4, 4, 4)))
    b.add_light(q)
    return b.build()


def old_train_steps(scene, cam, ids, target, steps, generator, lr):
    """The one-device train step before its uniforms went into fixed
    buffers: render_batches drawing from the generator as it goes,
    gradients set to None before each backward, a zero gradient for the
    leaves the render does not read, then Adam."""
    ds = ttrace.to_device(scene, "cpu")
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in tmesh.extract_params(ds).items()}
    opt = torch.optim.Adam(list(params.values()), lr=lr)
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        img, _ = tmesh.render_batches(tmesh.apply_params(ds, params),
                                      cam.derived(), cam.width, ids,
                                      cam.max_depth, cam.max_contribution,
                                      generator)
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        opt.step()
        if isinstance(generator, tmesh.KeyedUniforms):
            generator.stream += 1
        losses.append(loss.item())
    return params, losses


@pytest.mark.parametrize("keyed", [False, True])
def test_train_step_matches_the_earlier_eager_step(keyed):
    """Three steps of the restructured step (uniforms drawn into fixed
    buffers before the step, ids and target copied into its own,
    gradients zeroed in place) against the earlier eager step on the same
    generator: the same losses and the same params, bit for bit; every
    leaf has a gradient."""
    cam = tcam.Camera(width=8, aspect_ratio=1.0, samples_per_pixel=1,
                      max_depth=3)
    cam.position((0, 2, 8), (0, 1, 0))
    gen = (lambda: tmesh.KeyedUniforms(4)) if keyed else \
        (lambda: torch.Generator().manual_seed(4))
    ids = tmesh.pixel_ids(64, 2)
    target = torch.full((64, 3), 0.2)
    step, params, _ = tmesh.make_train_step(
        _tiny_scene(), cam, n_rays=64, n_sample_batches=2, max_depth=3,
        learning_rate=5e-2, device="cpu", generator=gen())
    losses = [step(params, ids, target) for _ in range(3)]
    ref, ref_losses = old_train_steps(_tiny_scene(), cam, ids, target, 3,
                                      gen(), 5e-2)
    assert losses == ref_losses
    for k in params:
        assert torch.equal(params[k].detach(), ref[k].detach()), k
        assert params[k].grad is not None


def test_graph_refused_where_nothing_can_be_captured():
    """graph=True raises where no CUDA graph can capture the levels or
    the step (on the CPU here), rather than running eagerly."""
    _, ds, o, d, t = scene_rays("cornell_box", n=128, seed=1)
    args = [torch.from_numpy(x) for x in (o, d, t)]
    with pytest.raises(ValueError, match="graph=True"):
        twf.radiance(ds, *args, torch.Generator(), 2, MAX_C, graph=True)
    cam = tcam.Camera(width=8, aspect_ratio=1.0, samples_per_pixel=1,
                      max_depth=2)
    with pytest.raises(ValueError, match="graph=True"):
        tmesh.make_train_step(_tiny_scene(), cam, 64, 1, 2, device="cpu",
                              graph=True)
    scene, cam = registry.cornell_box()
    cam.width, cam.samples_per_pixel, cam.max_depth = 16, 1, 2
    with pytest.raises(ValueError, match="graph=True"):
        regen.render_regen(scene, cam, n_lanes=1024, backend="xla",
                           device="cpu", graph=True)
    # a render with the levels asked eager gives the default's image
    a, st_a = regen.render_regen(scene, cam, n_lanes=1024, backend="xla",
                                 device="cpu")
    b, st_b = regen.render_regen(scene, cam, n_lanes=1024, backend="xla",
                                 device="cpu", graph=False)
    assert np.array_equal(a, b) and st_a["graph"] is st_b["graph"] is False


def test_fixed_buffer_records_write_rows_by_device_index():
    """`Records.write` puts a level in the row its (1,) index names, a
    dead lane's E and W as 0 and its flag off, [alive, alive after] in
    cnt; the combine over more rows than were written adds nothing."""
    rec = twf.Records.zeros(4, 3, torch.float32, "cpu")
    E = torch.tensor([[1.0, 2, 3], [4, 5, 6], [7, 8, 9]])
    alive = torch.tensor([True, False, True])
    rec.write(torch.tensor([2]), E, E * 0.5, torch.ones(3, dtype=torch.bool),
              alive, torch.tensor([False, False, True]))
    assert torch.equal(rec.E[2], torch.where(alive[:, None], E, 0.0))
    assert torch.equal(rec.cf[2], alive)
    assert rec.cnt[2].tolist() == [2, 1] and not rec.E[:2].any()
    assert torch.equal(rec.combine(4, MAX_C), rec.combine(3, MAX_C))


def test_cli_stats_say_graph_and_levels_run(capsys, tmp_path):
    """The stats JSON of `--integrator wavefront` says `graph` (false on
    the CPU) and `levels_run`, and regen's unfused window (`--backend
    xla`) says `graph`."""
    import json

    from go_raytracer_tpu_torch import cli

    for extra in (["--integrator", "wavefront", "--batch", "256"],
                  ["--backend", "xla", "--lanes", "1024"]):
        rc = cli.main(["-S", "6", "-o", str(tmp_path / "w.ppm"), "--cpu",
                       "--width", "16", "--spp", "1", "--max-depth", "3",
                       "--stats", "--quiet", *extra])
        assert rc == 0
        st = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert st["graph"] is False and st["levels_run"] >= st["levels"] > 0
