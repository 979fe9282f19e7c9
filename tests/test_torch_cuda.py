"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: they skip on a machine without one (the CPU tests hold the
plain versions against the JAX package). Run on a GPU machine with
`python -m pytest tests/test_torch_cuda.py -m gpu`; chip_smoke.py runs the
same comparisons at the flagship's shapes."""

import numpy as np
import pytest
import torch

from go_raytracer_tpu_torch.integrator import regen
from go_raytracer_tpu_torch.ops import bounce, harvest
from go_raytracer_tpu_torch.render.camera import Camera
from go_raytracer_tpu_torch.scene.builder import SceneBuilder
from go_raytracer_tpu_torch.scenes import registry

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _cornell(dev, n, seed=0):
    scene, cam = registry.cornell_box()
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    tables = tuple(to(t) for t in bounce.pack_scene(scene))
    rs = np.random.default_rng(seed)
    o = rs.uniform(50, 500, (n, 3)).astype(np.float32)
    d = (rs.normal(size=(n, 3)) * 300).astype(np.float32)
    state = [to(o[:, k]) for k in range(3)] + [to(d[:, k]) for k in range(3)] \
        + [to(rs.uniform(0, 1, n).astype(np.float32)),
           to((rs.uniform(size=n) < 0.6).astype(np.int32)),
           to(rs.integers(0, 50, n).astype(np.int32))]
    return (scene, cam, tables, bounce.scene_statics(scene),
            to(bounce.pack_camera(cam.derived())),
            to(np.asarray(scene.background, np.float32)), state)


RTOL = ATOL = 2e-3     # FMA / rsqrtf / __sincosf rounding, as chip_smoke
MISMATCH_FRAC = 2e-3   # lanes whose ray grazes an edge may branch the other way


def _started_ranks_are_a_prefix(fl, take):
    """Per level, the started lanes' ranks (FL bits 3..) are exactly
    0 .. take-1: no item is skipped or given to two lanes."""
    s, n = fl.shape
    started = (fl & 4) != 0
    lvl = torch.arange(s, device=fl.device)[:, None].expand(s, n)[started]
    hits = torch.zeros(s * n, dtype=torch.int32, device=fl.device)
    hits.index_add_(0, lvl * n + (fl[started] >> 3).long(),
                    torch.ones_like(lvl, dtype=torch.int32))
    want = torch.arange(n, device=fl.device)[None, :] < take[:, None]
    return torch.equal(hits.view(s, n), want.to(torch.int32))


def test_bounce_kernel_matches_plain(cuda):
    """Starts at level 0 only, 8 levels, 512 blocks (so each block sums
    the dead counts of the blocks before it over more than one pass):
    exact takes and starts; level-0 V within rtol = atol = 2e-3 wherever
    the flags agree; over all levels, at most 0.2% of the flags, alive
    bits, V values and alive lanes' origins beyond that tolerance (a lane
    that branched the other way at one level carries a different path
    from then on)."""
    n, n_inner = 512 * bounce.BLOCK, 8
    scene, cam, tables, st, cam_row, bg, state = _cornell(cuda, n)
    seed4 = torch.tensor([12345, 1, 0, 360000 * 100], dtype=torch.int32,
                         device=cuda)
    kw = dict(has_defocus=False, max_depth=50, n_inner=n_inner, width=600,
              sqrt_spp=10, npix=360000)
    k = bounce.bounce_fused_q(tables, st, cam_row, bg, seed4, *state, **kw)
    p = bounce.bounce_fused_q_ref(tables, st, cam_row, bg, seed4, *state, **kw)
    torch.cuda.synchronize()
    assert torch.equal(k[3], p[3])
    assert torch.equal(k[0][3][0] & ~3, p[0][3][0] & ~3)
    assert _started_ranks_are_a_prefix(k[0][3], k[3])
    assert ((k[0][3] & 7) != (p[0][3] & 7)).float().mean() <= MISMATCH_FRAC
    assert (k[4 + 7] != p[4 + 7]).float().mean() <= MISMATCH_FRAC
    agree0 = k[0][3][0] == p[0][3][0]
    for a, b in zip(k[0][:3], p[0][:3]):
        torch.testing.assert_close(a[0][agree0], b[0][agree0], rtol=RTOL,
                                   atol=ATOL)
        off = ~torch.isclose(a, b, rtol=RTOL, atol=ATOL, equal_nan=True)
        assert off.float().mean() <= MISMATCH_FRAC
    alive = (k[4 + 7] > 0) & (p[4 + 7] > 0)
    for a, b in zip(k[4:7], p[4:7]):
        off = ~torch.isclose(a[alive], b[alive], rtol=RTOL, atol=ATOL)
        assert off.float().mean() <= MISMATCH_FRAC


def test_bounce_kernel_ranks_every_refill_level(cuda):
    """Refill at every level, 512 blocks: each level's starts take the
    items base .. base+take-1 once each, and the bases chain the cursor."""
    n, n_inner = 512 * bounce.BLOCK, 8
    scene, cam, tables, st, cam_row, bg, state = _cornell(cuda, n, seed=1)
    seed4 = torch.tensor([99, n_inner, 1000, 360000 * 100],
                         dtype=torch.int32, device=cuda)
    out = bounce.FusedQOut.empty(n, n_inner, cuda)
    bounce.bounce_fused_q(tables, st, cam_row, bg, seed4, *state, out=out,
                          has_defocus=False, max_depth=50, n_inner=n_inner,
                          width=600, sqrt_spp=10, npix=360000)
    torch.cuda.synchronize()
    assert _started_ranks_are_a_prefix(out.rec[3], out.take)
    base, take = out.base.tolist(), out.take.tolist()
    assert base[0] == 1000
    assert all(base[j + 1] == base[j] + take[j] for j in range(n_inner - 1))
    assert int(out.cursor) == base[-1] + take[-1]


def test_harvest_kernel_matches_plain(cuda):
    n, n_inner = 512 * bounce.BLOCK, 8
    scene, cam, tables, st, cam_row, bg, state = _cornell(cuda, n)
    seed4 = torch.tensor([777, n_inner, 50, 360000 * 100], dtype=torch.int32,
                         device=cuda)
    out = bounce.FusedQOut.empty(n, n_inner, cuda)
    bounce.bounce_fused_q(tables, st, cam_row, bg, seed4, *state, out=out,
                          has_defocus=False, max_depth=50, n_inner=n_inner,
                          width=600, sqrt_spp=10, npix=360000)
    end = int(out.cursor)
    acc_k = torch.zeros((end - 50 + n, 3), device=cuda)
    acc_p = torch.zeros_like(acc_k)
    kw = dict(item_base=50, s_run=n_inner, refill_levels=n_inner,
              max_contribution=cam.max_contribution)
    harvest.harvest_levels_into(acc_k, *out.rec, out.base, **kw)
    rows = harvest.reverse_harvest_levels_ref(
        *out.rec, refill_levels=n_inner,
        max_contribution=cam.max_contribution)
    harvest.write_rows_ref(acc_p, rows, out.base, item_base=50,
                           n_rows=n_inner)
    assert torch.equal(acc_k[:end - 50], acc_p[:end - 50])


def test_exact_accounting_on_kernels(cuda):
    b = SceneBuilder(background=(1.0, 1.0, 1.0))
    m = b.lambertian((0.5, 0.5, 0.5))
    b.quad((0, 0, 1e8), (1, 0, 0), (0, 1, 0), m)
    b.add_light(b.quad((0, 0, 1e8), (1, 0, 0), (0, 1, 0),
                       b.diffuse_light((1, 1, 1))))
    cam = Camera(width=32, aspect_ratio=1.0, samples_per_pixel=9, max_depth=4)
    cam.position((0, 0, 5), (0, 0, 0))
    bounce.launches = harvest.launches = 0
    img, st = regen.render_regen(b.build(), cam, n_lanes=4096, cadence=3,
                                 device=cuda)
    np.testing.assert_array_equal(img, 1.0)
    assert st["segments"] == 32 * 32 * 9
    assert bounce.launches > 0 and harvest.launches > 0
