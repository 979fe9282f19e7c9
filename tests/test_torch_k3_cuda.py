"""K3 `bounce` (csrc/bounce.cu) on the card against its plain version,
on every feature set in dense mode and on the ext meshes, and the
reference engine's radiance on the kernel against the tensor-code
bounce; the bounce core's 0 / 0 weight rule on K3 and K1. Marked `gpu`: they skip on a machine without one (the CPU tests
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


def _ext_scene(which):
    from go_raytracer_tpu_torch.scene import obj_loader

    if which == "scene8":
        return registry.model_example()[0], ((10, 5, 10), (0, 0, 0))
    b = builder_mod.SceneBuilder(background=(0.1, 0.1, 0.1))
    if which == "glass_fog":
        look = synthetic.glass_fog_statue(b, obj_loader,
                                          builder_mod.Transform)
        return b.build(), look
    synthetic.image_mesh(b)
    return b.build(bvh_threshold=1), ((0, 4, 12), (0, 0, 0))


def _ext_ctx(cuda, which):
    scene, look = _ext_scene(which)
    cam = camera_mod.Camera(aspect_ratio=16 / 9, width=300,
                            samples_per_pixel=1, vertical_fov=40)
    cam.position(*look, (0, 1, 0))
    return regen.MeshContext.build(scene, cam, cuda), cam


@pytest.mark.parametrize("which", ["glass_fog", "image_mesh"])
def test_k3_ext_mode_meshes(cuda, which):
    """K3 from the walk's winner (gathered in the kernel) against the plain
    gather and bounce on the same (t, idx)."""
    ctx, cam = _ext_ctx(cuda, which)
    o, d, t, alive, g = _rays(cuda, cam, N, 2)
    cap = intersect.sphere_ts(ctx.ms.spheres, o, d, t, 1e-3,
                              float("inf")).amin(dim=1)
    if ctx.ms.has_quads:
        cap = torch.minimum(cap, intersect.quad_ts(
            ctx.ms.quads, o, d, 1e-3, float("inf")).amin(dim=1))
    hit = bounce.MeshHit(*trace.mesh_closest(ctx.ms, o, d, cap, alive))
    assert len(bounce.ext_planes_from_hit(ctx.statics, ctx.tri, o, d, hit)) \
        == bounce.n_ext_planes(ctx.statics)
    u = torch.rand((N, ctx.n_u), generator=g, device=cuda)
    k = ctx.k3(o, d, t, alive, u, ext=hit)
    torch.cuda.synchronize()
    p = bounce.bounce_ref(ctx.tables, ctx.statics, o, d, t, alive, u, ctx.bg,
                          ext=hit, tri=ctx.tri)
    _hold(k, p, alive, 1e-3)


@pytest.mark.parametrize("which", ["scene8", "glass_fog", "image_mesh"])
def test_k3_cap_matches_the_tensor_cap(cuda, which):
    """The dense cap entry (one launch) against the tensor cap: the same
    t but for rounding (2e-3 relative), and inf on the same lanes but on
    1e-3 of them (a ray grazing a sphere)."""
    ctx, cam = _ext_ctx(cuda, which)
    o, d, t, _, _ = _rays(cuda, cam, N, 5)
    before = bounce.launches_cap
    k = ctx.k3.cap(ctx.ms, o, d, t)
    torch.cuda.synchronize()
    assert bounce.launches_cap == before + 1
    p = bounce.dense_cap_ref(ctx.ms, o, d, t)
    fin = torch.isfinite(k) & torch.isfinite(p)
    assert (torch.isfinite(k) != torch.isfinite(p)).float().mean() <= 1e-3
    assert fin.any()
    assert (~torch.isclose(k[fin], p[fin], rtol=RTOL, atol=ATOL)
            ).float().mean() <= 1e-3


# the 0 / 0 weight's planted lanes (tests/test_torch_zero_pdf.py holds the
# plain rule to the JAX package on the CPU): ZZ_N lanes, the first PLANTED
# straight down onto a floor at y = 0 beside a quad light in its plane
ZZ_N = 1024
PLANTED = ZZ_N // 2


def floor_scene(builder):
    """A diffuse floor quad at y = 0 (x, z in [-3, 3]), a quad light in the
    same plane beside it (x in [5, 7]) and a quad light above (y = 4),
    built with `builder` (the port's SceneBuilder or the JAX package's)."""
    b = builder(background=(0.1, 0.2, 0.3))
    b.quad((-3, 0, -3), (6, 0, 0), (0, 0, 6), b.lambertian((0.5, 0.6, 0.7)))
    b.add_light(b.quad((5, 0, -1), (2, 0, 0), (0, 0, 2),
                       b.diffuse_light((4, 4, 4))))
    b.add_light(b.quad((-1, 4, -1), (2, 0, 0), (0, 0, 2),
                       b.diffuse_light((3, 3, 3))))
    return b.build()


def planted_lanes(seed, n_u):
    """PLANTED lanes from (x, 1, z) straight down, then lanes from random
    points above the floor in random downward directions; every lane
    alive, uniforms from the seed (slot 3 < 0.5: the light sample, slot 4
    the light: < 0.5 the one in the floor's plane, which only the planted
    lanes pick)."""
    rs = np.random.default_rng(seed)
    o = np.zeros((ZZ_N, 3), np.float32)
    d = np.zeros((ZZ_N, 3), np.float32)
    o[:PLANTED, 0] = rs.uniform(-2.5, 2.5, PLANTED)
    o[:PLANTED, 1] = 1.0
    o[:PLANTED, 2] = rs.uniform(-2.5, 2.5, PLANTED)
    d[:PLANTED, 1] = -1.0
    rest = ZZ_N - PLANTED
    o[PLANTED:] = rs.uniform((-2, 0.5, -2), (2, 3, 2), (rest, 3))
    d[PLANTED:] = rs.normal(size=(rest, 3))
    d[PLANTED:, 1] = -np.abs(d[PLANTED:, 1]) - 0.2
    tm = np.zeros(ZZ_N, np.float32)
    alive = np.ones(ZZ_N, bool)
    u = rs.uniform(0, 1, (ZZ_N, n_u)).astype(np.float32)
    # the other lanes sample the light above: a sample towards the light in
    # the floor's plane grazes it, where the two packages' hit points part
    # by a rounding (the port's lies on the plane, so it is 0 / 0 too)
    u[PLANTED:, 4] = 0.5 + 0.5 * u[PLANTED:, 4]
    return o, d, tm, alive, u


def zero_zero_lanes(u):
    """The planted lanes that sample the light in the floor's plane: both
    of their pdfs are 0."""
    pick = np.zeros(ZZ_N, bool)
    pick[:PLANTED] = (u[:PLANTED, 3] < 0.5) & (u[:PLANTED, 4] < 0.5)
    return pick


def test_k3_weighs_zero_zero_lanes_zero(cuda):
    """K3 on the planted lanes: weight 0 where both pdfs are 0, finite
    everywhere, and the plain version's weight on every lane."""
    ts = floor_scene(builder_mod.SceneBuilder)
    st = bounce.scene_statics(ts)
    o, d, tm, alive, u = (torch.from_numpy(x).to(cuda) for x in
                          planted_lanes(5, bounce.N_U + st["n_media"]))
    tabs = tuple(torch.from_numpy(t).to(cuda) for t in bounce.pack_scene(ts))
    bg = torch.tensor(ts.background, dtype=torch.float32, device=cuda)
    k = bounce.bounce(tabs, st, o, d, tm, alive, u, bg)
    p = bounce.bounce_ref(tabs, st, o, d, tm, alive, u, bg)
    torch.cuda.synchronize()
    zz = torch.from_numpy(zero_zero_lanes(u.cpu().numpy())).to(cuda)
    assert torch.isfinite(k[1]).all()
    assert (k[1][zz] == 0).all() and (k[4][zz, 1] == 0).all()
    torch.testing.assert_close(k[1], p[1], rtol=2e-3, atol=2e-3)


def test_fused_kernel_weighs_zero_zero_lanes_zero(cuda):
    """K1 (`bounce_fused_q`), one level without refill on the planted
    lanes alone (its own uniforms pick the light: on the other lanes,
    whose floor hit lies off the plane by a rounding, a sample towards the
    light in the plane grazes it, and the kernel's rounding is not the
    plain version's): the lanes whose light sample has dy = 0 weigh 0,
    every weight is finite and the plain version's."""
    ts = floor_scene(builder_mod.SceneBuilder)
    st = bounce.scene_statics(ts)
    o, d, tm, alive, _ = (x[:PLANTED] for x in planted_lanes(5, bounce.N_U))
    n = o.shape[0]
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    tabs = tuple(to(t) for t in bounce.pack_scene(ts))
    cam = camera_mod.Camera(aspect_ratio=1.0, width=32,
                            samples_per_pixel=1, max_depth=50)
    cam.position((0, 2, 6), (0, 0, 0), (0, 1, 0))
    cam_row = to(bounce.pack_camera(cam.derived()))
    bg = to(np.asarray(ts.background, np.float32))
    state = [to(o[:, 0]), to(o[:, 1]), to(o[:, 2]), to(d[:, 0]), to(d[:, 1]),
             to(d[:, 2]), to(tm), to(alive.astype(np.int32)),
             to(np.zeros(n, np.int32))]
    seed4 = torch.tensor([777, 0, 0, 32 * 32], dtype=torch.int32,
                         device=cuda)
    kw = dict(has_defocus=False, max_depth=50, n_inner=1, width=32,
              sqrt_spp=1, npix=32 * 32)
    k = bounce.bounce_fused_q(tabs, st, cam_row, bg, seed4, *state, **kw)
    p = bounce.bounce_fused_q_ref(tabs, st, cam_row, bg, seed4, *state, **kw)
    torch.cuda.synchronize()
    v_k = torch.stack([k[0][c][0] for c in range(3)], dim=-1)
    v_p = torch.stack([p[0][c][0] for c in range(3)], dim=-1)
    flat = (k[4 + 4] == 0) & (k[4 + 7] > 0)
    assert flat.sum() > 20
    assert torch.isfinite(v_k).all()
    assert (v_k[flat] == 0).all()
    torch.testing.assert_close(v_k, v_p, rtol=2e-3, atol=2e-3)


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
