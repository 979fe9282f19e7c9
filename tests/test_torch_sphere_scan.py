"""The closest-hit scan on a synthetic dense scene (scenes/synthetic.py):
603 spheres (moving ones, a hollow glass sphere, inactive rows cleared to
kind -1, padding rows), 5 quads and 3 rotated boxes, and two spheres at
the same place with different materials, where the first declared must
win. More rows than any registry scene but book2; the same scene at
MAX_PRIMS rows, past the CUDA kernels' staging budget, runs on the card.

The port's plain versions against the JAX package's Pallas kernels in
interpret mode on the CPU, on the same numpy-seeded inputs, with the
tolerances of tests/test_torch_bounce.py and tests/test_torch_fused.py:
integer planes exact at one level; over three levels at most
MISMATCH_FRAC of the lanes flip (glass and a rounding at a grazing edge
turn a lane another way), and records within rtol = atol = 2e-3 on the
lanes whose flags agree. The CUDA kernels are held to these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_raytracer_tpu.ops.pallas import bounce as jpb
from go_raytracer_tpu.render.camera import Camera as JCamera
from go_raytracer_tpu.scene.builder import SceneBuilder as JBuilder
from go_raytracer_tpu.scene.builder import Transform as JTransform
from go_raytracer_tpu_torch.ops import bounce as tpb
from go_raytracer_tpu_torch.render.camera import Camera
from go_raytracer_tpu_torch.scene import types as TT
from go_raytracer_tpu_torch.scenes import synthetic as syn

torch.set_num_threads(2)

N = 4096
N_SPH, N_QUAD, N_BOX = 603, 5, 3
# the glass sphere (book3's bound, tests/test_torch_fused.py)
MISMATCH_FRAC = 5e-3
# Of the lanes alive in both after three levels (370 of 4,096), those whose
# new ray leaves the tolerances: the rays leave the radius-1000 ground
# sphere with its f32 acne, as book1's do (tests/test_torch_fused.py's
# BOTH_FRAC). Measured: 8 lanes (2.2e-2 of them, 2.0e-3 of all lanes).
BOTH_FRAC = 3e-2


def _scene():
    """The JAX and port arguments of the scan scene with its inactive rows
    cleared, its statics, and the packed table's inactive rows."""
    js = syn.scan_scene(JBuilder(background=syn.CAMERA["background"]),
                        JTransform, N_SPH, N_QUAD, N_BOX)
    ts = TT.scene_from_numpy(js)
    st = tpb.scene_statics(ts)
    rows = syn.inactive_rows(st)
    jtab = [np.asarray(x) for x in jpb.pack_scene(js)]
    jtab[0] = syn.clear_rows(jtab[0], rows)
    ttab = tuple(torch.from_numpy(t) for t in tpb.pack_scene(ts))
    ttab = (torch.from_numpy(syn.clear_rows(ttab[0].numpy(), rows)),) \
        + ttab[1:]
    jc = JCamera(**{k: v for k, v in syn.CAMERA.items()
                    if k not in ("look_from", "look_at")})
    jc.position(syn.CAMERA["look_from"], syn.CAMERA["look_at"], (0, 1, 0))
    tc = Camera(**{f.name: getattr(jc, f.name)
                   for f in dataclasses.fields(Camera)})
    jargs = (tuple(jnp.asarray(t) for t in jtab), jpb.scene_statics(js),
             jpb.pack_camera(jc.derived()), js.background)
    targs = (ttab, st, torch.from_numpy(tpb.pack_camera(tc.derived())),
             torch.from_numpy(np.array(ts.background)))
    return jargs, targs, st, rows


@pytest.fixture(scope="module")
def scan_runs():
    """`bounce_fused_q` of JAX (interpret mode) and of the port's plain
    version on the scan scene at 1 and 3 levels, the queue refilling at
    the first two."""
    jargs, targs, st, rows = _scene()
    state = syn.lane_state(N)
    npix = syn.CAMERA["width"] ** 2
    seed4 = np.array([-123456789, 2, 100, npix * 16], np.int32)
    runs = {}
    for n_inner in (1, 3):
        kw = dict(has_defocus=False, max_depth=50, n_inner=n_inner,
                  width=syn.CAMERA["width"], sqrt_spp=4, npix=npix)
        jout = jpb.bounce_fused_q(*jargs, jnp.asarray(seed4),
                                  *[jnp.asarray(x) for x in state],
                                  interpret=True, **kw)
        tout = tpb.bounce_fused_q(*targs, torch.from_numpy(seed4),
                                  *[torch.from_numpy(x) for x in state],
                                  **kw)
        runs[n_inner] = (jax.tree.map(np.asarray, jout), tout)
    return dict(runs=runs, statics=st, rows=rows, state=state)


def test_scan_scene_tables():
    """Both packages build the scan scene's packed tables equal, column for
    column, with inactive rows (kind -1, every column -1) cleared in
    every section and padding rows after each; the coincident pair shares
    its geometry columns and not its material, one sphere is hollow and
    more than 100 move."""
    js = syn.scan_scene(JBuilder(background=syn.CAMERA["background"]),
                        JTransform, N_SPH, N_QUAD, N_BOX)
    from go_raytracer_tpu_torch.scene.builder import SceneBuilder, Transform
    ts = syn.scan_scene(SceneBuilder(background=syn.CAMERA["background"]),
                        Transform, N_SPH, N_QUAD, N_BOX)
    for a, b in zip(jpb.pack_scene(js), tpb.pack_scene(ts)):
        np.testing.assert_array_equal(np.asarray(a), b)
    st = tpb.scene_statics(ts)
    assert (st["n_sph"], st["n_quad"], st["n_box"]) == (N_SPH, N_QUAD, N_BOX)
    assert st["quad_base"] > st["n_sph"] and st["box_base"] > st["quad_base"] \
        + st["n_quad"] - 1
    rows = syn.inactive_rows(st)
    raw = tpb.pack_scene(ts)[0]
    prims = syn.clear_rows(raw, rows)
    assert len(rows) > 50 and (prims[rows] == -1.0).all()
    assert all(any(lo <= r < lo + c for r in rows) for lo, c in (
        (0, N_SPH), (st["quad_base"], N_QUAD), (st["box_base"], N_BOX)))
    pads = [r for base, c, nxt in ((0, N_SPH, st["quad_base"]),
                                   (st["quad_base"], N_QUAD, st["box_base"]),
                                   (st["box_base"], N_BOX, st["n_rows"]))
            for r in range(base + c, nxt)]
    assert len(pads) > 8 and (prims[pads, 0] == -1.0).all()
    # the coincident pair: same geometry, different materials; a hollow
    # glass sphere (negative radius) and moving spheres
    np.testing.assert_array_equal(prims[0, :13], prims[1, :13])
    assert not np.array_equal(prims[0, 13:], prims[1, 13:])
    assert (raw[:N_SPH, 7] < 0).sum() == 1
    assert (raw[:N_SPH, 4:7] != 0).any(axis=1).sum() > 100


@pytest.mark.parametrize("n_inner", [1, 3])
def test_bounce_fused_q_ref_matches_pallas_on_scan_scene(scan_runs, n_inner):
    """The plain `bounce_fused_q` against the JAX kernel on the scan scene:
    takes and starts exact; at one level every flag, seg count and alive
    bit exact and every record within rtol = atol = 2e-3; over three
    levels within MISMATCH_FRAC of the lanes."""
    (jrec, _, jseg, jtc, *jst), tout = scan_runs["runs"][n_inner]
    trec, _, tseg, ttc, *tst = tout
    trec = [x.numpy() for x in trec]
    tst = [x.numpy() for x in tst]
    np.testing.assert_array_equal(ttc.numpy(), jtc)
    fl_t = trec[3] & 7
    np.testing.assert_array_equal(fl_t[0], jrec[3][0])
    started = (jrec[3][0] & 4) != 0
    np.testing.assert_array_equal(trec[3][0][started] >> 3,
                                  np.arange(started.sum()))
    frac = 0.0 if n_inner == 1 else MISMATCH_FRAC
    if n_inner == 1:
        np.testing.assert_array_equal(tseg.numpy(), jseg)
        np.testing.assert_array_equal(tst[7], jst[7])
    assert np.all(np.abs(tseg.numpy() - jseg) <= frac * N)
    assert (fl_t != jrec[3]).mean() <= frac
    assert (tst[7] != jst[7]).mean() <= frac
    agree = fl_t == jrec[3]
    for k in range(3):
        a, b = jrec[k][agree], trec[k][agree]
        assert (np.isnan(a) == np.isnan(b)).all()
        bad = ~np.isclose(b, a, rtol=2e-3, atol=2e-3, equal_nan=True)
        assert bad.mean() <= frac
    both = (tst[7] > 0) & (jst[7] > 0)
    for k, rtol in ((0, 2e-4), (1, 2e-4), (2, 2e-4), (3, 2e-3), (4, 2e-3),
                    (5, 2e-3)):
        bad = ~np.isclose(tst[k][both], jst[k][both], rtol=rtol, atol=2e-3)
        assert bad.sum() <= frac * N
        assert bad.mean() <= (0.0 if n_inner == 1 else BOTH_FRAC)
    np.testing.assert_array_equal(tst[8][both], jst[8][both])
    np.testing.assert_array_equal(tst[6], jst[6])


@pytest.mark.parametrize("impl", ["jax", "port"])
def test_coincident_spheres_first_declared_wins(scan_runs, impl):
    """The level-0 camera rays meet the coincident pair (rows 0 and 1, one
    geometry): every one that does emits the first row's colour, in the
    JAX kernel and in the port's plain version (the strict `<` keeps the
    first root found)."""
    (jrec, *_), tout = scan_runs["runs"][1]
    rec = jrec if impl == "jax" else [x.numpy() for x in tout[0]]
    started = (rec[3][0] & 4) != 0
    emit = started & ((rec[3][0] & 2) != 0)
    v = np.stack([rec[k][0] for k in range(3)], axis=1)
    first = np.all(v == np.float32(syn.TIE_FIRST), axis=1)
    second = np.all(v == np.float32(syn.TIE_SECOND), axis=1)
    assert first[emit].sum() > 100
    assert not second.any()


def test_inactive_rows_never_win(scan_runs):
    """A row cleared to kind -1 is skipped: the port's plain version on the
    table with those rows cleared equals it on a table with the same rows
    moved far out of every ray's reach, bit for bit."""
    _, targs, st, rows = _scene()
    state = [torch.from_numpy(x) for x in scan_runs["state"]]
    npix = syn.CAMERA["width"] ** 2
    seed4 = torch.tensor([7, 1, 0, npix * 16], dtype=torch.int32)
    kw = dict(has_defocus=False, max_depth=50, n_inner=1,
              width=syn.CAMERA["width"], sqrt_spp=4, npix=npix)
    cleared = tpb.bounce_fused_q(*targs, seed4, *state, **kw)
    tables = targs[0]
    far = tables[0].clone()
    sph = [r for r in rows if r < st["quad_base"]]
    far[sph] = torch.from_numpy(tpb.pack_scene(TT.scene_from_numpy(
        syn.scan_scene(JBuilder(background=syn.CAMERA["background"]),
                       JTransform, N_SPH, N_QUAD, N_BOX)))[0][sph])
    far[sph, 1:4] = torch.tensor([1e6, 1e6, 1e6])
    far[sph, 4:7] = 0.0
    moved = tpb.bounce_fused_q((far,) + tables[1:], *targs[1:], seed4,
                               *state, **kw)
    for a, b in zip(cleared[0], moved[0]):
        assert torch.equal(a, b)
    for a, b in zip(cleared[4:], moved[4:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("schedule", ["queue", "positional"])
def test_fused_schedules_match_pallas_on_scan_scene(schedule):
    """One level of `bounce_fused` (the refill planes of a queue refill) and
    of `bounce_fused_pos` (per-lane item pointers), plain version against
    the JAX kernel on the scan scene: every integer plane and the alive
    counts exact, every float record and the new rays within the
    tolerances above on every lane."""
    jargs, targs, _, _ = _scene()
    state = syn.lane_state(N, seed=3)
    w, sq = syn.CAMERA["width"], 4
    rs = np.random.default_rng(4)
    if schedule == "queue":
        dead = state[7] == 0
        item = 100 + np.cumsum(dead) - 1
        take = dead & (item < 100 + int(dead.sum()) - 29)
        stratum, pid = item // (w * w), item % (w * w)
        extra = [take.astype(np.int32)] + [x.astype(np.float32) for x in (
            pid % w, pid // w, stratum // sq, stratum % sq)]
        seed = np.array([-123456789], np.int32)
        kw = dict(has_defocus=False, max_depth=50, n_inner=1)
        jfn, tfn = jpb.bounce_fused, tpb.bounce_fused
        jseed = jnp.int32(seed[0])
    else:
        extra = [rs.integers(0, w, N).astype(np.float32),
                 rs.integers(0, w - 1, N).astype(np.float32),
                 rs.integers(0, sq, N).astype(np.float32),
                 rs.integers(0, sq, N).astype(np.float32),
                 rs.choice([0, 1, 2, 40], N).astype(np.float32)]
        seed = np.array([987654321, 1], np.int32)
        kw = dict(has_defocus=False, max_depth=50, n_inner=1, width=w,
                  sqrt_spp=sq)
        jfn, tfn = jpb.bounce_fused_pos, tpb.bounce_fused_pos
        jseed = jnp.asarray(seed)
    jout = jax.tree.map(np.asarray, jfn(
        *jargs, jseed, *[jnp.asarray(x) for x in state],
        *[jnp.asarray(x) for x in extra], interpret=True, **kw))
    tout = tfn(*targs, torch.from_numpy(seed),
               *[torch.from_numpy(x) for x in state],
               *[torch.from_numpy(x) for x in extra], **kw)
    jrec, _, jseg, *jst = jout
    trec, _, tseg, *tst = tout
    np.testing.assert_array_equal(tseg.numpy(), jseg)
    for a, b in zip(trec, jrec):
        a = a.numpy()
        if a.dtype == np.int32:
            np.testing.assert_array_equal(a, b)
        else:
            assert (np.isnan(a) == np.isnan(b)).all()
            assert np.isclose(a, b, rtol=2e-3, atol=2e-3, equal_nan=True).all()
    np.testing.assert_array_equal(tst[7].numpy(), jst[7])
    np.testing.assert_array_equal(tst[8].numpy(), jst[8])
    alive = tst[7].numpy() > 0
    for k, rtol in ((0, 2e-4), (1, 2e-4), (2, 2e-4), (3, 2e-3), (4, 2e-3),
                    (5, 2e-3)):
        assert np.isclose(tst[k].numpy()[alive], jst[k][alive], rtol=rtol,
                          atol=2e-3).all()
    for a, b in zip(tst[9:], jst[9:]):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("pad,exact", [(None, True), ("1e-5", False)])
def test_sphere_cull_changes_no_winner_on_host(pad, exact):
    """scripts/check_cull_host.py: the CUDA core's bounce with the cull on
    the kernels' scan table against it without on the declaration-order
    one, compiled for the host, on random and grazing rays over book1,
    book2 and the scan scene: bit for bit with the header's CULL_PAD; with
    a pad far below the one it derives, some rays differ (so the check sees
    a wrong cull)."""
    if not (shutil.which("c++") or shutil.which("g++")):
        pytest.skip("needs a host C++ compiler")
    script = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "check_cull_host.py")
    cmd = [sys.executable, script, "--rays", "60000"] \
        + (["--pad", pad] if pad else [])
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    lines = [ln for ln in run.stdout.splitlines() if "differ" in ln]
    assert len(lines) == 3, run.stdout + run.stderr
    assert all(ln.endswith(" 0 differ") for ln in lines) == exact
    assert run.returncode == (0 if exact else 1)
