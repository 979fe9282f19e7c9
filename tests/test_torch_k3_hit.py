"""K3's ext mode from the mesh walk's winner: the plain versions of what the
kernel now does itself, the gather of the winning triangle
(`ops/bounce.ext_planes_from_hit` on the walk's (t, idx)) and the dense cap
(`dense_cap_ref`, the cap entry's plain version), against the composition
they replace (the tensor cap, the walk pruned by it, and `bounce_ref` on
the planes of its winner) exactly, and against the JAX package's
`mesh_ext_planes` + `bounce` in interpret mode within the repo's
tolerances. Cases: scene 8, the
glass-and-fog statue and the image-textured mesh of `scenes/synthetic.py`.

Tolerances against JAX: alive' and the clamp flag equal, and E, W and the
continuing rays within RTOL relative and ATOL absolute
(tests/test_pallas_bounce.py's bound), on at least EXT_AGREE of the lanes
(the W bound of tests/test_mesh_ext.py: the JAX package's CPU walk is its
unpruned skip-link walk, the port's the BVH8 walk pruned by the cap, so an
edge-grazing ray may meet another triangle)."""

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_raytracer_tpu.ops import intersect as jix
from go_raytracer_tpu.ops.pallas import bounce as jpb
from go_raytracer_tpu.scene import builder as jbuilder, obj_loader as jol
from go_raytracer_tpu.scenes import registry as jreg
from go_raytracer_tpu_torch.integrator import regen
from go_raytracer_tpu_torch.ops import bounce as tpb
from go_raytracer_tpu_torch.ops import intersect as tix
from go_raytracer_tpu_torch.ops import trace as ttrace
from go_raytracer_tpu_torch.render import camera as tcam
from go_raytracer_tpu_torch.scene import types as TT
from go_raytracer_tpu_torch.scenes import synthetic as syn

torch.set_num_threads(2)
RTOL = ATOL = 2e-3
EXT_AGREE = 0.995
CASES = ("scene8", "glass_fog", "image_mesh")


def jax_scene(which):
    """(the JAX package's scene, (eye, target)) of a case."""
    if which == "scene8":
        return jreg.model_example()[0], ((10.0, 5.0, 10.0), (0.0, 0.0, 0.0))
    if which == "glass_fog":
        b = jbuilder.SceneBuilder()
        look = syn.glass_fog_statue(b, jol, jbuilder.Transform)
        return b.build(), look
    b = jbuilder.SceneBuilder(background=(0.1, 0.1, 0.1))
    syn.image_mesh(b)
    return b.build(bvh_threshold=1), ((0.0, 0.0, 9.0), (0.0, 0.0, 0.0))


def rays(look, n, seed, n_u):
    """Rays from near the eye towards the target, a tenth dead."""
    rs = np.random.default_rng(seed)
    o = (np.asarray(look[0], np.float32)
         + rs.normal(size=(n, 3)).astype(np.float32))
    d = (np.asarray(look[1], np.float32) - o
         + 3 * rs.normal(size=(n, 3))).astype(np.float32)
    t = rs.uniform(0, 1, n).astype(np.float32)
    alive = rs.uniform(size=n) > 0.1
    u = rs.uniform(0, 1, (n, n_u)).astype(np.float32)
    return o, d, t, alive, u


def tensor_cap(ms, o, d, t):
    """The mesh path's dense cap as the tensor code wrote it before the cap
    entry (integrator/regen.mesh_bounce)."""
    cap = torch.full((o.shape[0],), float("inf"), dtype=o.dtype)
    if ms.has_spheres:
        cap = torch.minimum(cap, tix.sphere_ts(
            ms.spheres, o, d, t, ttrace.T_MIN, float("inf")).amin(dim=1))
    if ms.has_quads:
        cap = torch.minimum(cap, tix.quad_ts(
            ms.quads, o, d, ttrace.T_MIN, float("inf")).amin(dim=1))
    if ms.has_boxes:
        cap = torch.minimum(cap, tix.box_ts(
            ms.boxes, o, d, ttrace.T_MIN, float("inf")).amin(dim=1))
    return cap


@pytest.fixture(scope="module", params=CASES)
def case(request):
    js, look = jax_scene(request.param)
    ts = TT.scene_from_numpy(js)
    st = tpb.scene_statics(ts, ext=True)
    ms = ttrace.to_device(ts, "cpu")
    tt = torch.from_numpy
    tabs = tuple(tt(x) for x in tpb.pack_scene(ts))
    tri_mat = tt(tpb.tri_mat_table(ts, st))
    bg = tt(np.array(ts.background, np.float32))
    return dict(name=request.param, js=js, ts=ts, st=st, ms=ms, tabs=tabs,
                tri_mat=tri_mat, tri=tpb.TriTable.build(ms.triangles, tri_mat),
                bg=bg, look=look)


def test_cap_plain_version_is_the_tensor_cap(case):
    ms = case["ms"]
    o, d, t, _, _ = (torch.from_numpy(x) for x in rays(
        case["look"], 2048, 1, tpb.N_U))
    cap = tpb.dense_cap_ref(ms, o, d, t)
    assert torch.equal(cap, tensor_cap(ms, o, d, t))
    assert torch.isfinite(cap).any()
    # the prepared launch on CPU tensors takes the plain version
    k3 = tpb.K3Launch(case["tabs"], case["st"], case["bg"], case["tri"])
    assert torch.equal(k3.cap(ms, o, d, t), cap)


def test_ext_from_hit_equals_the_planes_path(case):
    """The gather on the walk's (t, idx) gives the planes of the same
    gather gated on the cap, as the JAX package's `mesh_ext_planes` gates
    (the walk already prunes by it), bit for bit, and the
    plain bounce from the hit the one from those planes; `mesh_bounce`
    (cap, walk, K3 from the hit) the tensor cap + planes + bounce_ref
    composition."""
    st, ms, tri = case["st"], case["ms"], case["tri"]
    n_u = tpb.N_U + st["n_media"]
    o, d, t, alive, u = (torch.from_numpy(x) for x in rays(
        case["look"], 2048, 2, n_u))
    cap = tensor_cap(ms, o, d, t)
    hit = tpb.MeshHit(*ttrace.mesh_closest(ms, o, d, cap, alive))
    planes = tpb.ext_planes_from_hit(st, tri, o, d, hit, t_cap=cap)
    assert (hit.idx >= 0).any()
    from_hit = tpb.ext_planes_from_hit(st, tri, o, d, hit)
    assert len(from_hit) == len(planes) == tpb.n_ext_planes(st)
    for a, b in zip(from_hit, planes):
        assert torch.equal(a, b)
    args = (case["tabs"], st, o, d, t, alive, u, case["bg"])
    ref = tpb.bounce_ref(*args, ext=planes)
    for a, b in zip(tpb.bounce_ref(*args, ext=hit, tri=tri)[:6], ref[:6]):
        assert torch.equal(a, b)
    for a, b in zip(tpb.bounce(*args, ext=hit, tri=tri)[:6], ref[:6]):
        assert torch.equal(a, b)
    cam = tcam.Camera(aspect_ratio=16 / 9, width=64, samples_per_pixel=1,
                      vertical_fov=40)
    cam.position(*case["look"], (0, 1, 0))
    ctx = regen.MeshContext.build(case["ts"], cam, "cpu")
    for a, b in zip(regen.mesh_bounce(ctx, o, d, t, alive, u), ref[:6]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tpb.bounce_ref(*args, ext=hit)       # a MeshHit needs its tables


def test_ext_from_hit_matches_jax(case):
    js, st, ms = case["js"], case["st"], case["ms"]
    n = 512
    n_u = tpb.N_U + st["n_media"]
    o, d, t, alive, u = rays(case["look"], n, 3, n_u)
    t = np.zeros(n, np.float32)
    tt = torch.from_numpy
    k3 = tpb.K3Launch(case["tabs"], st, case["bg"], case["tri"])
    cap = k3.cap(ms, tt(o), tt(d), tt(t))
    hit = tpb.MeshHit(*ttrace.mesh_closest(ms, tt(o), tt(d), cap,
                                           tt(alive)))
    tout = k3(tt(o), tt(d), tt(t), tt(alive), tt(u), ext=hit)
    jst = jpb.scene_statics(js, ext=True)
    jst["cull"] = False
    jcap = jix.sphere_ts(js.spheres, jnp.asarray(o), jnp.asarray(d),
                         jnp.asarray(t), 1e-3, jnp.inf).min(axis=1)
    if js.has_quads:
        jcap = jnp.minimum(jcap, jix.quad_ts(js.quads, jnp.asarray(o),
                                             jnp.asarray(d), 1e-3,
                                             jnp.inf).min(axis=1))
    jext = jpb.mesh_ext_planes(js, jst, jnp.asarray(o), jnp.asarray(d), jcap,
                               jnp.asarray(alive), interpret=True)
    jout = jpb.bounce(jpb.pack_scene(js), jst, jnp.asarray(o), jnp.asarray(d),
                      jnp.asarray(t), jnp.asarray(alive), jnp.asarray(u),
                      js.background, interpret=True, ext=jext)
    jW = jpb.patch_image_weight(js, jout[1], jout[6])
    jE, jW, jcf, jno, jnd, jna = (np.asarray(x) for x in
                                  (jout[0], jW) + tuple(jout[2:6]))
    tE, tW, tcf, tno, tnd, tna = (x.numpy() for x in tout[:6])
    flags = (jna == tna) & (jcf == tcf)
    ok = flags & np.isclose(jE, tE, rtol=RTOL, atol=ATOL).all(-1) \
        & np.isclose(jW, tW, rtol=RTOL, atol=ATOL).all(-1)
    go = flags & tna
    ok[go] &= np.isclose(jno[go], tno[go], rtol=RTOL, atol=ATOL).all(-1) \
        & np.isclose(jnd[go], tnd[go], rtol=RTOL, atol=ATOL).all(-1)
    assert ok.mean() >= EXT_AGREE, ok.mean()
    assert (hit.idx.numpy()[alive] >= 0).mean() > 0.02   # the mesh is hit
    assert not tna[~alive].any() and not tE[~alive].any()
