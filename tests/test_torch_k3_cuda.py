"""K3 `bounce` (csrc/bounce.cu) on the card against its plain version,
on every feature set in dense mode and on the ext meshes, and the
reference engine's radiance on the kernel against the tensor-code
bounce. Marked `gpu`: they skip on a machine without one (the CPU tests
hold the plain versions against the JAX package). Run on a GPU machine
with `python -m pytest --noconftest -m gpu tests/test_torch_k3_cuda.py`;
chip_smoke.py phase 25 runs the same comparisons at full width."""

import numpy as np
import pytest
import torch

from go_raytracer_tpu_torch.integrator import regen, wavefront
from go_raytracer_tpu_torch.ops import bounce, intersect, trace
from go_raytracer_tpu_torch.render import camera as camera_mod
from go_raytracer_tpu_torch.scene import builder as builder_mod
from go_raytracer_tpu_torch.scenes import registry, synthetic

pytestmark = pytest.mark.gpu

RTOL = ATOL = 2e-3     # FMA / rsqrtf / __sincosf rounding, as chip_smoke
# the flip fraction of each feature set (chip_smoke's K3_MISMATCH_FRAC,
# DIEL_MISMATCH_FRAC, TEX_MISMATCH_FRAC, IMG_MISMATCH_FRAC)
FLIP = {"cornell_box": 1e-3, "book3": 5e-3, "cornell_smoke": 1e-3,
        "simple_light": 2e-3, "book1": 5e-3, "quads_scene": 2e-3,
        "book2": 2e-2}
N = 1 << 15


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _rays(dev, cam, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    pid = torch.randint(0, cam.width * cam.image_height, (n,), generator=g,
                        device=dev)
    s0 = torch.zeros(n, device=dev)
    o, d, t = camera_mod.generate_rays(
        cam.derived(), cam.width, pid, s0, s0,
        torch.rand((n, camera_mod.N_U_RAYGEN), generator=g, device=dev))
    alive = torch.rand(n, generator=g, device=dev) > 0.1
    return o.contiguous(), d.contiguous(), t.contiguous(), alive, g


def _hold(k, p, alive, frac):
    flags = (k[5] == p[5]) & (k[2] == p[2])
    assert (~flags).float().mean() <= frac
    for a, b in ((k[0], p[0]), (k[1], p[1])):
        off = ~torch.isclose(a, b, rtol=RTOL, atol=ATOL, equal_nan=True)
        assert (off.any(-1) & flags).float().mean() <= frac
    go = flags & k[5]
    for a, b in ((k[3], p[3]), (k[4], p[4])):
        off = ~torch.isclose(a[go], b[go], rtol=RTOL, atol=ATOL)
        assert off.any(-1).float().sum() <= frac * alive.numel()
    assert not k[5][~alive].any() and not k[1][~alive].any()


@pytest.mark.parametrize("name", list(FLIP))
def test_k3_dense_mode_every_feature_set(cuda, name):
    scene, cam = getattr(registry, name)()
    st = bounce.scene_statics(scene)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    tables = tuple(to(x) for x in bounce.pack_scene(scene))
    bg = to(np.asarray(scene.background, np.float32))
    o, d, t, alive, g = _rays(cuda, cam, N, 1)
    before = bounce.launches_bounce
    for _ in range(2):
        u = torch.rand((N, bounce.N_U + st["n_media"]), generator=g,
                       device=cuda)
        k = bounce.bounce(tables, st, o, d, t, alive, u, bg)
        torch.cuda.synchronize()
        _hold(k, bounce.bounce_ref(tables, st, o, d, t, alive, u, bg), alive,
              FLIP[name])
        o, d, alive = k[3].contiguous(), k[4].contiguous(), k[5].clone()
    assert bounce.launches_bounce == before + 2


@pytest.mark.parametrize("which", ["glass_fog", "image_mesh"])
def test_k3_ext_mode_meshes(cuda, which):
    from go_raytracer_tpu_torch.scene import obj_loader

    b = builder_mod.SceneBuilder(background=(0.1, 0.1, 0.1))
    if which == "glass_fog":
        look = synthetic.glass_fog_statue(b, obj_loader,
                                          builder_mod.Transform)
        scene = b.build()
    else:
        synthetic.image_mesh(b)
        look = ((0, 4, 12), (0, 0, 0))
        scene = b.build(bvh_threshold=1)
    cam = camera_mod.Camera(aspect_ratio=16 / 9, width=300,
                            samples_per_pixel=1, vertical_fov=40)
    cam.position(*look, (0, 1, 0))
    ctx = regen.MeshContext.build(scene, cam, cuda)
    o, d, t, alive, g = _rays(cuda, cam, N, 2)
    cap = intersect.sphere_ts(ctx.ms.spheres, o, d, t, 1e-3,
                              float("inf")).amin(dim=1)
    if ctx.ms.has_quads:
        cap = torch.minimum(cap, intersect.quad_ts(
            ctx.ms.quads, o, d, 1e-3, float("inf")).amin(dim=1))
    ext = bounce.mesh_ext_planes(ctx.ms, ctx.statics, ctx.tri_mat, o, d, cap,
                                 alive)
    assert len(ext) == bounce.n_ext_planes(ctx.statics)
    u = torch.rand((N, ctx.n_u), generator=g, device=cuda)
    k = bounce.bounce(ctx.tables, ctx.statics, o, d, t, alive, u, ctx.bg,
                      ext=ext)
    torch.cuda.synchronize()
    p = bounce.bounce_ref(ctx.tables, ctx.statics, o, d, t, alive, u, ctx.bg,
                          ext=ext)
    _hold(k, p, alive, 1e-3)


def test_radiance_on_k3_matches_the_tensor_bounce(cuda):
    """One random stream, the kernel backend against the tensor-code
    bounce on book3: the same paths but for the flips of grazing rays."""
    scene, cam = registry.book3()
    ds = trace.to_device(scene, cuda)
    o, d, t, _, _ = _rays(cuda, cam, N, 3)
    out = {}
    for be in ("pallas", "xla"):
        g = torch.Generator(device=cuda).manual_seed(4)
        before = bounce.launches_bounce
        out[be] = wavefront.radiance(ds, o, d, t, g, 8, 10.0, backend=be)
        launched = bounce.launches_bounce - before
        assert launched == (out[be][1]["levels"] if be == "pallas" else 0)
    ok = torch.isclose(out["pallas"][0], out["xla"][0], rtol=RTOL,
                       atol=ATOL).all(-1)
    assert ok.float().mean() >= 1 - 5e-3
