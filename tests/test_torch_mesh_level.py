"""The mesh window's level glue (`ops/mesh_level`) and the window that runs
it (`integrator/regen._mesh_window`) on the CPU.

* The plain `refill` and `record` against the JAX package's `fwd_step`
  (integrator/regen.py there: `refill_assign`, `camera_mod.generate_rays`
  and the V/FL merge), captured from its window and fed the same state,
  the same uniforms and the same bounce outputs: takes, ranks, pixels,
  strata, flag bits and counts exact; rays and V within 1e-6 relative.
* `_mesh_window`, whose counts stay on the device, against the window loop
  it replaced (one host read a level), reproduced here: the same
  accumulator, cursor, segments and levels, bit for bit, however late the
  drain is seen."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_raytracer_tpu.integrator import regen as jregen
from go_raytracer_tpu.integrator import wavefront as jwave
from go_raytracer_tpu.scenes import registry as jreg
from go_raytracer_tpu_torch.integrator import regen
from go_raytracer_tpu_torch.ops import harvest
from go_raytracer_tpu_torch.ops import mesh_level as ml
from go_raytracer_tpu_torch.render import camera as camera_mod
from go_raytracer_tpu_torch.scenes import registry as treg

torch.set_num_threads(2)

N = 1024
N_U = 9
# the camera's sin and cos of the lens sample come from two libraries
RTOL = 1e-6


class _Captured(Exception):
    pass


def _jax_fwd_step(scene, cam, monkeypatch, n, item_end, refill, bounce):
    """The JAX package's `fwd_step` of its unfused window (use_pallas and
    use_ext off), taken from the `jax.lax.scan` that would run it, with
    `bounce` as its `bounce_fn`."""
    monkeypatch.setattr(jwave, "_bounce", lambda _scene, *a: bounce(*a))
    real_scan = jax.lax.scan
    got = {}

    def scan(f, init, xs, *a, **k):
        if f.__name__ == "fwd_step":
            got["f"] = f
            raise _Captured
        return real_scan(f, init, xs, *a, **k)

    monkeypatch.setattr(jax.lax, "scan", scan)
    npix = cam.width * cam.image_height
    state = tuple(jnp.zeros(n, jnp.float32) for _ in range(7)) \
        + (jnp.zeros(n, bool), jnp.zeros(n, jnp.int32),
           jnp.zeros(n, jnp.int32))
    with pytest.raises(_Captured):
        jregen._window_impl(
            scene, cam.derived(), jnp.zeros((item_end + n, 3)), state,
            jnp.int32(0), jax.random.key(0), jnp.int32(0), jnp.int32(item_end),
            width=cam.width, npix=npix, sqrt_spp=cam.spp_sqrt, window=8,
            refill=refill, cadence=1, n_u=N_U, max_depth=cam.max_depth,
            max_contribution=cam.max_contribution, use_pallas=False,
            interpret=True)
    monkeypatch.setattr(jax.lax, "scan", real_scan)
    return got["f"]


def _inputs(pool, n, seed):
    """A lane pool (o, d, t, alive, depth) and one level's uniforms and
    bounce outputs, from numpy: `pool` "mixed" (60% alive, depths up to
    the cap), "all_dead" or "all_alive"."""
    rs = np.random.default_rng(seed)
    alive = {"mixed": rs.random(n) < 0.6, "all_dead": np.zeros(n, bool),
             "all_alive": np.ones(n, bool)}[pool]
    f32 = lambda a: np.asarray(a, np.float32)
    lanes = dict(o=f32(rs.normal(size=(n, 3)) * 5),
                 d=f32(rs.normal(size=(n, 3))), t=f32(rs.random(n)),
                 alive=alive,
                 depth=rs.integers(0, 8, n).astype(np.int32))
    emit = rs.random(n) < 0.3
    E = f32(np.where(emit[:, None], rs.random((n, 3)) * 4, 0.0))
    E[rs.random(n) < 0.05, 1] = np.nan      # a NaN emission counts as emitted
    W = f32(np.where(emit[:, None], 0.0, rs.random((n, 3))))
    draws = dict(u_cam=f32(rs.random((n, 5))), u=f32(rs.random((n, N_U))),
                 E=E, W=W, cf=rs.random(n) < 0.5, na=rs.random(n) < 0.7)
    return lanes, draws


# (scene, pool, where the cursor stands): "open" leaves room for every
# dead lane, "cross" lets half of them take before item_end, "past" is a
# level past the refill
CASES = [("modelExample", "mixed", "cross"),
         ("modelExample", "all_dead", "open"),
         ("modelExample", "all_alive", "open"),
         ("cornellBox", "mixed", "open"), ("cornellBox", "all_dead", "cross"),
         ("book1", "mixed", "cross"), ("book1", "mixed", "past")]


@pytest.mark.parametrize("scene,pool,where", CASES)
def test_glue_matches_jax_fwd_step(scene, pool, where, monkeypatch):
    """Defocus on (modelExample, book1) and off (cornellBox), the time
    plane, a refill that crosses item_end, a level past the refill, all-
    dead and all-alive pools."""
    js, jc = jreg.get_scene(scene)[1]()
    ts, tc = treg.get_scene(scene)[1]()
    assert (tc.defocus_angle > 0) == (scene != "cornellBox")
    n, s, refill = N, 3, 6
    npix = tc.width * tc.image_height
    lanes, dr = _inputs(pool, n, seed=len(scene) + len(pool) + len(where))
    n_dead = int((~lanes["alive"]).sum())
    item_end = tc.spp_sqrt ** 2 * npix
    cursor = item_end - n_dead // 2 if where == "cross" else item_end // 3
    if where == "past":
        s = refill
    uniforms = {(n, 5): dr["u_cam"], (n, N_U): dr["u"]}
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, dtype=None:
                        jnp.asarray(uniforms[tuple(shape)]))

    def jbounce(o, d, t, alive, u):
        # the rays after the refill come back as the new rays
        return (jnp.asarray(dr["E"]), jnp.asarray(dr["W"]),
                jnp.asarray(dr["cf"]), o, d, jnp.asarray(dr["na"]) & alive)

    fwd = _jax_fwd_step(js, jc, monkeypatch, n, item_end, refill, jbounce)
    L = lanes
    jstate = tuple(jnp.asarray(L["o"][:, k]) for k in range(3)) \
        + tuple(jnp.asarray(L["d"][:, k]) for k in range(3)) \
        + (jnp.asarray(L["t"]), jnp.asarray(L["alive"]),
           jnp.full(n, -1, jnp.int32), jnp.asarray(L["depth"]))
    (js2, jnext), ((jV, jfl, jtake, jni), jseg) = fwd(
        (jstate, jnp.int32(cursor)),
        (jax.random.key(1), jnp.asarray(s < refill)))
    js2 = [np.asarray(x) for x in js2]
    jtake, jitem = np.asarray(jtake), js2[8]

    # the port: the plain glue on the same lanes, uniforms and bounce
    lv = ml.MeshLevel.empty(n, 8, N_U, "cpu")
    lv.begin([torch.from_numpy(L[k]) for k in ("o", "d", "t", "alive",
                                                "depth")], 0)
    lv.lvl.fill_(s)
    lv.cnt[s, ml.CURSOR] = cursor
    lv.u_cam.copy_(torch.from_numpy(dr["u_cam"]))
    lv.u.copy_(torch.from_numpy(dr["u"]))
    base = torch.full((8,), -7, dtype=torch.int32)
    arrays = tc.derived().to("cpu")
    ml.refill(lv, arrays, ml.pack_camera(arrays, "cpu"), base,
              item_end=item_end, refill=refill, cadence=1, width=tc.width,
              npix=npix, sqrt_spp=tc.spp_sqrt)
    rays = [x.clone().numpy() for x in (lv.o, lv.d, lv.t)]
    start = lv.start.numpy().copy()
    rec = [torch.full((8, n), -5.0) for _ in range(3)] \
        + [torch.full((8, n), -5, dtype=torch.int32)]
    na = torch.from_numpy(dr["na"]) & lv.alive
    ml.record(lv, rec, torch.from_numpy(dr["E"]), torch.from_numpy(dr["W"]),
              torch.from_numpy(dr["cf"]), lv.o.clone(), lv.d.clone(), na,
              max_depth=tc.max_depth)

    # takes, ranks, pixels and strata exact
    take = (start & 4) != 0
    np.testing.assert_array_equal(take, jtake)
    rank = start >> 3
    np.testing.assert_array_equal(rank[take] + cursor, jitem[take])
    assert not rank[~take].any()
    n_take = int(take.sum())
    if where == "past" or pool == "all_alive":
        assert n_take == 0
    elif where == "cross":
        assert 0 < n_take == item_end - cursor < n_dead
    else:
        assert n_take == n_dead
    t_, _, pid, s_i, s_j = ml.refill_assign(
        torch.tensor(cursor, dtype=torch.int64), torch.from_numpy(L["alive"]),
        s < refill, item_end, npix=npix, sqrt_spp=tc.spp_sqrt)
    stratum = jitem[take] // npix
    np.testing.assert_array_equal(pid.numpy()[take], jitem[take] % npix)
    np.testing.assert_array_equal(s_i.numpy()[take], stratum // tc.spp_sqrt)
    np.testing.assert_array_equal(s_j.numpy()[take], stratum % tc.spp_sqrt)
    # rays: the camera's (taken lanes) or the lane's own, within 1e-6
    for mine, theirs in ((rays[0], np.stack(js2[0:3], 1)),
                         (rays[1], np.stack(js2[3:6], 1)), (rays[2], js2[6])):
        np.testing.assert_allclose(mine, theirs, rtol=RTOL,
                                   atol=RTOL * np.abs(theirs).max())
    np.testing.assert_array_equal(rays[2][take], dr["u_cam"][take, 4])
    # records: V within 1e-6, flag bits exact, the start and its rank
    V = np.stack([r[s].numpy() for r in rec[:3]], 1)
    np.testing.assert_allclose(V, np.asarray(jV), rtol=RTOL, atol=0)
    fl = rec[3][s].numpy()
    np.testing.assert_array_equal(fl & 3, np.asarray(jfl))
    np.testing.assert_array_equal(fl >> 2, start >> 2)
    assert all((r[:s] == -5).all() and (r[s + 1:] == -5).all() for r in rec)
    # the lane state after the level and its counts
    np.testing.assert_array_equal(lv.alive.numpy(), js2[7])
    np.testing.assert_array_equal(lv.depth.numpy(), js2[9])
    assert lv.cnt[s + 1].tolist() == [int(jseg), int(js2[7].sum()),
                                      int(jnext), n_take]
    assert int(base[s]) == int(jni) == cursor and int(lv.lvl[0]) == s + 1
    assert (base[:s] == -7).all() and (base[s + 1:] == -7).all()


# ---------------------------------------------------------------------------
# the window against the loop it replaced
# ---------------------------------------------------------------------------

def _refill_lanes(arrays, state, cursor, gen, do_refill: bool,
                  item_end: int, *, width, npix, sqrt_spp):
    """The window's refill as it ran before the glue: the dead lanes of
    `state` (o, d, t, alive, depth) take the next queue items from
    `cursor` on (`refill_assign`) and start on fresh camera rays drawn
    from `gen`. Returns the new (o, d, t, alive, depth) and (take, rank)."""
    o, d, t, alive, depth = state
    take, rank, pid, s_i, s_j = ml.refill_assign(
        cursor, alive, do_refill, item_end, npix=npix, sqrt_spp=sqrt_spp)
    u_cam = torch.rand((o.shape[0], camera_mod.N_U_RAYGEN), generator=gen,
                       dtype=torch.float32, device=o.device)
    o_n, d_n, t_n = camera_mod.generate_rays(arrays, width, pid, s_i, s_j,
                                             u_cam)
    return (torch.where(take[:, None], o_n, o),
            torch.where(take[:, None], d_n, d), torch.where(take, t_n, t),
            alive | take, torch.where(take, torch.zeros_like(depth), depth),
            take, rank)


def _host_read_window(ctx, acc, state, next_item, gen, item_end, *, width,
                      npix, sqrt_spp, window, refill, max_depth,
                      max_contribution, bufs):
    """The mesh window as it ran before its counts stayed on the device:
    tensor code a level and three counts read back to the host at every
    level. Returns (state, next item, segments, levels)."""
    o, d, t, alive, depth = state
    n = o.shape[0]
    cursor = torch.tensor(next_item, dtype=torch.int64)
    out = regen.bounce_mod.bounce_out(n, "cpu")
    segments = s_run = 0
    for s in range(window):
        o, d, t, alive, depth, take, rank = _refill_lanes(
            ctx.arrays, (o, d, t, alive, depth), cursor, gen, s < refill,
            item_end, width=width, npix=npix, sqrt_spp=sqrt_spp)
        bufs.base[s, 0] = cursor
        cursor = cursor + take.sum()
        u = torch.rand((n, ctx.n_u), generator=gen, dtype=torch.float32)
        E, W, cf, o, d, alive_out = ctx.bounce_level(o, d, t, alive, u, out)
        dead = ~alive
        E = torch.where(dead[:, None], 0.0, E)
        W = torch.where(dead[:, None], 0.0, W)
        alive_out = alive_out & (depth < max_depth)
        depth = torch.where(alive, depth + 1, depth)
        emit = (E != 0.0).any(dim=-1)
        V = torch.where(emit[:, None], E, W)
        for c in range(3):
            bufs.rec[c][s] = V[:, c]
        bufs.rec[3][s] = ((cf & alive).to(torch.int64)
                          | (emit.to(torch.int64) << 1)
                          | (take.to(torch.int64) << 2)
                          | torch.where(take, rank << 3,
                                        torch.zeros_like(rank))) \
            .to(torch.int32)
        counts = torch.stack([alive.sum(), alive_out.sum(), cursor]).tolist()
        segments += counts[0]
        alive = alive_out
        s_run = s + 1
        if counts[1] == 0 and (s + 1 >= refill or counts[2] >= item_end):
            break
    harvest.harvest_levels_into(
        acc, *(r[:s_run] for r in bufs.rec), bufs.base.reshape(-1),
        item_base=0, s_run=s_run, refill_levels=refill,
        max_contribution=max_contribution)
    return [o, d, t, alive, depth], int(cursor), segments, s_run


@pytest.fixture(scope="module")
def scene8():
    scene, cam = treg.model_example()
    cam.width, cam.samples_per_pixel, cam.max_depth = 32, 4, 6
    return scene, cam, regen.MeshContext.build(scene, cam, "cpu")


@pytest.mark.parametrize("case", ["drained", "undrained", "drained_late"])
def test_window_matches_the_host_read_loop(scene8, case, monkeypatch):
    """32x18 px, 4 spp, 4,096 lanes, depth 6. "drained": the window (35
    levels, refill 28) ends early once every path has ended; "undrained":
    5 levels, refill 3, paths alive at its end; "drained_late": the drain
    seen two levels late, as the card's watch may see it. Accumulator,
    cursor, segments, levels recorded and the lane state as the loop
    gives them, bit for bit."""
    scene, cam, ctx = scene8
    n = 4096
    assert cam.image_height == 18
    npix, sqrt_spp = cam.width * cam.image_height, cam.spp_sqrt
    total = npix * sqrt_spp ** 2
    d1 = cam.max_depth + 1
    window, refill = (5, 3) if case == "undrained" else (5 * d1, 4 * d1)
    kw = dict(width=cam.width, npix=npix, sqrt_spp=sqrt_spp, window=window,
              refill=refill, max_depth=cam.max_depth,
              max_contribution=cam.max_contribution)

    def run(fn, late_by=0):
        bufs = regen.WindowBuffers.empty(n, window, 1, "cpu")
        acc = torch.zeros((total + n, 3))
        res = fn(ctx, acc, regen._init_state_mesh(n, "cpu"), 0,
                 regen.window_generator(7, 0, "cpu"), total, bufs=bufs, **kw)
        return res, acc

    (st_p, nxt_p, seg_p, lev_p), acc_p = run(_host_read_window)
    late = 2 if case == "drained_late" else 0
    orig = regen._DrainWatch.drained
    seen = {}

    def watch(self):
        if "at" not in seen and orig(self):
            seen["at"] = self.last
        return "at" in seen and self.last >= seen["at"] + late

    monkeypatch.setattr(regen._DrainWatch, "drained", watch)
    (st_n, cur, n_run), acc_n = run(regen._mesh_window)
    if case == "undrained":
        assert lev_p == window and n_run == window and not seen
        assert bool(st_p[3].any())
    else:
        assert lev_p < window and n_run == lev_p + late <= window
        assert nxt_p == total
    assert cur.dtype == torch.int64
    assert cur.tolist() == [nxt_p, seg_p, lev_p]
    assert torch.equal(acc_n, acc_p)
    # past the drain every lane is dead, and a dead lane's ray is a
    # don't-care that the levels run late may move
    for a, b in zip(st_n[2 if late else 0:], st_p[2 if late else 0:]):
        assert torch.equal(a, b)


def test_count_adds_now_or_at_each_replay(monkeypatch):
    """`_cuda.count`, which every kernel wrapper counts its launches with:
    outside a capture it adds one to the counter; while a CUDA graph is
    captured it only notes the counter, which `Graph.replay` then adds at
    every replay."""
    from go_raytracer_tpu_torch.ops import _cuda
    counters = {}
    _cuda.count(counters, "calls")
    _cuda.count(counters, "calls")
    assert counters == {"calls": 2}
    noted = []
    monkeypatch.setattr(_cuda, "_noting", noted)
    _cuda.count(counters, "calls")
    _cuda.count(vars(ml), "launches_refill")
    assert counters == {"calls": 2}
    assert noted == [(counters, "calls"), (vars(ml), "launches_refill")]
