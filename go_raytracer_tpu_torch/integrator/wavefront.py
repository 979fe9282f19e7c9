"""The reference engine: the reference's recursive `rayColor`
(camera/camera.go:293-331) as a fixed-shape forward pass over bounce
levels and a reverse combine (the JAX package's `integrator/wavefront.py`).

Per bounce, each live ray gives an (emission, weight, clamp?) triple:

  miss             -> E = background, terminate           (camera.go:300-302)
  diffuse light    -> E = emitted (front face only),      (materials.go:146-155)
                      terminate                           (camera.go:312-314)
  metal/dielectric -> W = attenuation, no clamp           (camera.go:315-317)
  lambertian/iso   -> W = atten * scatterPdf / mixPdf,    (camera.go:319-328)
                      the clamp applies at this level     (camera.go:330)

The recursion L(depth) = clamp(E + W * L(depth - 1)) is then evaluated
backwards over the recorded levels, which reproduces the per-level firefly
clamp (camera.go:334-341) exactly, where a forward throughput could not.
The forward pass runs a fixed number of levels (mode "scan") or stops once
every ray has terminated (mode "while", one host read a level).

Depth: the recursion stops at depth < 0 (camera.go:294), so max_depth + 1
surface interactions occur and the deepest child contributes black.

Everything is out-of-place tensor code, with the score-function factors
of the dielectric choice and the media transit (value 1), so autograd can
run through it: the gradient of a render with respect to the scene's
parameters (`parallel/mesh.extract_params`) or the camera's vectors is
the JAX package's `jax.grad` of mode "scan" on backend "xla". A BVH
mesh's closest-hit distance carries no gradient (`ops/trace.trace`).
`backend="pallas"` runs the bounce as the K3 kernel (`ops/bounce.bounce`,
forward only) instead, and refuses to run where autograd would need its
derivative.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from go_raytracer_tpu_torch.core import onb, rng, vecmath as vm
from go_raytracer_tpu_torch.integrator import sampling
from go_raytracer_tpu_torch.ops import _cuda
from go_raytracer_tpu_torch.ops import trace as trace_mod
from go_raytracer_tpu_torch.scene import types as T

INV_4PI = 1.0 / (4.0 * math.pi)
# uniform slots per ray per bounce; medium m draws slot N_FIXED_U + m
U_METAL_A, U_METAL_B, U_DIEL, U_MIX, U_PICK, U_LA, U_LB, U_MA, U_MB = range(9)
N_FIXED_U = 9


def clamp_contribution(color: torch.Tensor, max_value) -> torch.Tensor:
    """Firefly clamp (camera.go:334-341): rescale so the component sum does
    not exceed max_value. A NaN sum compares false and passes unscaled, as
    in Go."""
    intensity = torch.sum(color, dim=-1, keepdim=True)
    over = intensity > max_value
    # divide only on the taken branch, so the derivative stays finite
    scale = torch.where(over, max_value / torch.where(over, intensity, 1.0),
                        1.0)
    return color * scale


def _bounce(ds, o, d, time, alive, u, *, route=None, counters=None):
    """One bounce of every ray: the closest hit (`ops/trace.trace`), the
    emission, and the scattered direction with its weight. ds =
    `ops/trace.to_device(scene, device)`; u (N, N_FIXED_U + media) holds
    the level's uniforms; `route` (a dict of `mesh_closest`'s route
    arguments) picks a BVH mesh's closest-hit route. Returns (E, W,
    clamp flag, new_o, new_d, alive')."""
    n_med = ds.media.kind.shape[0]
    hit = trace_mod.trace(ds, o, d, time, u[:, N_FIXED_U:N_FIXED_U + n_med],
                          alive=alive, counters=counters, **(route or {}))
    mats = ds.materials
    kind = mats.kind[hit.mat_id]
    tex_val = sampling.texture_value(ds, mats.tex_id[hit.mat_id].to(torch.int64),
                                     hit.u, hit.v, hit.p)
    fuzz = sampling.param_rows(mats.fuzz, hit.mat_id)
    ref_idx = sampling.param_rows(mats.ref_idx, hit.mat_id)

    miss = alive & ~hit.hit
    lit = alive & hit.hit
    false1 = torch.zeros_like(lit)
    is_light = lit & (kind == T.MAT_DIFFUSE_LIGHT)
    is_metal = (lit & (kind == T.MAT_METAL)) if ds.has_metal else false1
    is_diel = (lit & (kind == T.MAT_DIELECTRIC)) if ds.has_dielectric \
        else false1
    is_iso = (lit & (kind == T.MAT_ISOTROPIC)) if ds.has_isotropic else false1
    diffuse = (lit & (kind == T.MAT_LAMBERTIAN)) | is_iso

    # emission: the background on a miss, the texture on a light's front
    # face (materials.go:150-155: back faces emit black)
    zero3 = torch.zeros_like(tex_val)
    E = torch.where(miss[:, None], ds.background[None, :].to(o.dtype), zero3)
    E = torch.where((is_light & hit.front_face)[:, None], tex_val, E)

    # diffuse: the 50/50 mixture of the light pdf and the material pdf
    # (camera.go:319-328, pdf.go:58-74)
    cos_dir = onb.transform(onb.build(hit.normal),
                            rng.cosine_direction(u[:, U_MA], u[:, U_MB]))
    if ds.has_isotropic:
        iso_dir = rng.unit_vector(u[:, U_MA], u[:, U_MB])
        mat_dir = torch.where(is_iso[:, None], iso_dir, cos_dir)
    else:
        mat_dir = cos_dir
    if ds.lights.n > 0:
        light_dir = sampling.lights_sample(ds, hit.p, u[:, U_PICK],
                                           u[:, U_LA], u[:, U_LB])
        gen_dir = torch.where((u[:, U_MIX] < 0.5)[:, None], light_dir, mat_dir)
        l_pdf = sampling.lights_pdf_value(ds, hit.p, gen_dir)
    else:
        # No lights list: the reference would panic (rand.Intn(0),
        # hittable.go:101); a user scene degrades to pure material
        # sampling, so no 0/0 weight poisons half the diffuse samples.
        gen_dir = mat_dir
        l_pdf = None
    cos_theta = vm.dot(vm.normalize(gen_dir), hit.normal)
    cosine_pdf = torch.clamp(cos_theta, min=0.0) / math.pi  # pdf.go:33-36
    mat_pdf = torch.where(is_iso, INV_4PI, cosine_pdf) if ds.has_isotropic \
        else cosine_pdf
    pdf_value = mat_pdf if l_pdf is None else 0.5 * l_pdf + 0.5 * mat_pdf
    scatter_pdf = mat_pdf                          # materials.go:51-57,161-163
    # pdf_value == 0 (or NaN, from inside a sphere light): the reference
    # divides by it (camera.go:328), and the inf or NaN that follows is
    # always zeroed downstream (the clamp turns an inf sum into NaN
    # components, and PrintColor's NaN guard, color.go:28-36, zeroes the
    # vertex's whole triple), so the path's subtree contributes 0. That
    # limit is taken explicitly here (E and W of the vertex set to 0
    # below) instead of dividing: the film value is the same, and a real
    # x / 0 would poison gradients through inf * 0 products (GRAD.md).
    ok_div = diffuse & (pdf_value > 0)
    bad_pdf = diffuse & ~ok_div
    ratio = torch.where(ok_div, scatter_pdf, 0.0) \
        / torch.where(ok_div, pdf_value, 1.0)
    W = torch.where(diffuse[:, None], tex_val * ratio[:, None], zero3)
    new_d = gen_dir

    if ds.has_metal:
        # metal (materials.go:70-79): the raw direction reflected,
        # normalised, plus fuzz times a unit vector
        fuzz_vec = rng.unit_vector(u[:, U_METAL_A], u[:, U_METAL_B])
        d_metal = vm.normalize(vm.reflect(d, hit.normal)) \
            + fuzz[:, None] * fuzz_vec
        W = torch.where(is_metal[:, None], tex_val, W)
        new_d = torch.where(is_metal[:, None], d_metal, new_d)

    if ds.has_dielectric:
        # dielectric (materials.go:94-130)
        ud = vm.normalize(d)
        ri = torch.where(hit.front_face, 1.0 / ref_idx, ref_idx)
        cos_t = torch.clamp(vm.dot(-ud, hit.normal), max=1.0)
        # Schlick takes the material's index whichever way the ray
        # travels (materials.go:126-130), a reference quirk kept here
        r0 = ((1.0 - ref_idx) / (1.0 + ref_idx)) ** 2
        schlick = r0 + (1.0 - r0) * (1.0 - cos_t) ** 5
        # total internal reflection on squares: ri sin > 1 <=> ri^2 (1 -
        # cos^2) > 1, which avoids sqrt(0)'s infinite derivative
        must_reflect = ri * ri * (1.0 - cos_t * cos_t) > 1.0
        do_reflect = must_reflect | (schlick > u[:, U_DIEL])
        d_diel = torch.where(do_reflect[:, None], vm.reflect(ud, hit.normal),
                             vm.refract(ud, hit.normal, ri[:, None]))
        # score-function factor of the reflect/refract choice: value 1,
        # derivative d(log p_branch)/d(ref_idx) times the path's value;
        # the refraction's pathwise term covers the rest
        p_sel = torch.where(must_reflect, 1.0,
                            torch.where(do_reflect, schlick, 1.0 - schlick))
        sur_d = p_sel / torch.clamp(p_sel, min=1e-12).detach()
        W = torch.where(is_diel[:, None], sur_d[:, None].expand_as(tex_val), W)
        new_d = torch.where(is_diel[:, None], d_diel, new_d)

    if ds.has_media:
        # score-function factor of the media transit (value 1, derivative
        # d(med_logp)/d(density)), on this vertex's emission and on
        # everything after it
        sur_m = torch.exp(hit.med_logp - hit.med_logp.detach())[:, None]
        E = E * sur_m
        W = W * sur_m

    # the bad-mixture-pdf vertex contributes nothing, and its lane ends
    E = torch.where(bad_pdf[:, None], 0.0, E)
    W = torch.where(bad_pdf[:, None], 0.0, W)
    new_o = torch.where(lit[:, None], hit.p, o)
    alive_next = (is_metal | is_diel | diffuse) & ~bad_pdf
    return E, W, diffuse, new_o, new_d, alive_next


def use_kernel(ds, n: int, backend: str) -> bool:
    """Whether `radiance` runs the bounce as the K3 kernel: "pallas"
    always, "auto" when the kernel carries the scene and n is a multiple
    of 128 (the JAX package's rule), "xla" never. Whether the kernel
    carries a scene rests on its flags and table shapes, which
    `parallel/mesh.apply_params` keeps."""
    from go_raytracer_tpu_torch.ops import bounce as bounce_mod

    if backend not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend == "pallas" or (
        backend == "auto" and bounce_mod.supported(ds.host) and n % 128 == 0)


def kernel_launch(ds):
    """The K3 kernel's launch (`ops/bounce.K3Launch`: the packed tables on
    ds's device and the dense statics). Its tables are packed from ds's
    own parameter tensors (`ops/trace.host_scene`), and packed again when
    one of them was replaced or updated in place since, so the kernel
    never renders with stale parameters."""
    from go_raytracer_tpu_torch.ops import bounce as bounce_mod

    stamp = tuple((t, t._version)
                  for t in trace_mod.param_tensors(ds).values())
    if ds.k3 is None or any(a is not b or va != vb for (a, va), (b, vb)
                            in zip(ds.k3_stamp, stamp)):
        scene = trace_mod.host_scene(ds)
        if not bounce_mod.supported(scene):
            raise NotImplementedError(
                "backend 'pallas': the bounce kernel does not carry this "
                "scene (" + ", ".join(bounce_mod.refused_features(scene))
                + ")")
        ds.k3 = bounce_mod.K3Launch(
            tuple(torch.from_numpy(t).to(ds.device)
                  for t in bounce_mod.pack_scene(scene)),
            bounce_mod.scene_statics(scene), ds.background.detach())
        ds.k3_stamp = stamp
    return ds.k3


@dataclasses.dataclass
class Records:
    """A radiance call's per-level records on fixed buffers (the JAX
    package's "while" buffers): E, W (steps, N, 3), the clamp flag cf
    (steps, N) bool and cnt (steps, 2) int32, [lanes alive at the level's
    start (its segments), lanes alive after it]. Level s writes row s
    through a device index (`write`), so one captured level serves every
    depth; a row no level wrote stays 0 and adds nothing to the combine."""

    E: torch.Tensor
    W: torch.Tensor
    cf: torch.Tensor
    cnt: torch.Tensor

    @staticmethod
    def zeros(steps: int, n: int, dtype, device) -> "Records":
        z = lambda shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)
        return Records(E=z((steps, n, 3)), W=z((steps, n, 3)),
                       cf=z((steps, n), torch.bool),
                       cnt=z((steps, 2), torch.int32))

    def write(self, idx, E, W, cf, alive, alive_next):
        """Row idx (a (1,) int64 tensor on the records' device) from one
        bounce: a dead lane's E and W as 0, its clamp flag off."""
        dead = ~alive[:, None]
        self.E.index_copy_(0, idx, torch.where(dead, 0.0, E)[None])
        self.W.index_copy_(0, idx, torch.where(dead, 0.0, W)[None])
        self.cf.index_copy_(0, idx, (cf & alive)[None])
        self.cnt.index_copy_(0, idx, torch.stack(
            [alive.sum(), alive_next.sum()]).to(torch.int32)[None])

    def combine(self, levels: int, max_contribution) -> torch.Tensor:
        """The reverse combine over rows [0, levels): L = clamp?(E + W *
        L_child), the deepest child black. Rows past the last level that
        had a live lane are 0 and leave L at 0."""
        E, W, cf = self.E.unbind(0), self.W.unbind(0), self.cf.unbind(0)
        L = torch.zeros_like(E[0])
        for s in reversed(range(levels)):
            raw = E[s] + W[s] * L
            L = torch.where(cf[s][:, None],
                            clamp_contribution(raw, max_contribution), raw)
        return L


# Levels a "while" call keeps in flight on the card before it polls the
# oldest one's drain count: enough to keep the device fed (a replay is
# ~20 us of host work against 0.1-2 ms of device work), few enough that
# the levels run past a drain stay few.
RUN_AHEAD = 4


def _level(bounce, rec: Records, idx, o, d, time, alive, u):
    """One level: the bounce, its records in row idx; returns the next (o,
    d, alive)."""
    E, W, cf, o_n, d_n, alive_n = bounce(o, d, time, alive, u)
    rec.write(idx, E, W, cf, alive, alive_n)
    return o_n, d_n, alive_n


class Levels:
    """The reference engine's levels on fixed buffers, for the card: the
    lane state (o, d, t, alive), the level's uniforms u, the level index
    `lvl` (a device tensor), the records (`Records`) and the combine's
    outputs (L, segments `seg`, levels recorded `rec_levels`). `level` is
    one CUDA graph (`ops/_cuda.Graph`) of a level: the bounce, its record
    writes, the state update and lvl + 1; it is captured at the second
    level the buffers run (the first runs eagerly and loads every
    kernel). `combine` is one graph of the reverse combine over every
    row, captured at the buffers' second call. `key`: what the graphs
    read, objects compared by identity (`radiance` keeps one Levels in the
    device scene's ds.engine["levels"])."""

    def __init__(self, n: int, steps: int, n_u: int, dtype, device, key,
                 kernel: bool):
        z = lambda shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)
        self.key, self.steps = key, steps
        self.o, self.d, self.t = z((n, 3)), z((n, 3)), z((n,))
        self.alive = z((n,), torch.bool)
        self.u = z((n, n_u))
        self.lvl = z((1,), torch.int64)
        self.rec = Records.zeros(steps, n, dtype, device)
        self.out = None
        if kernel:
            from go_raytracer_tpu_torch.ops import bounce as bounce_mod

            self.out = bounce_mod.bounce_out(n, device)
        self.L = z((n, 3))
        self.seg, self.rec_levels = z((), torch.int64), z((), torch.int64)
        self.level = self.combine = None
        self.ran = self.combined = False

    def made_for(self, key) -> bool:
        plain = (int, float, str, tuple, torch.dtype)
        return len(key) == len(self.key) and all(
            a is b or (isinstance(a, plain) and a == b)
            for a, b in zip(key, self.key))

    def begin(self, o, d, time):
        self.o.copy_(o)
        self.d.copy_(d)
        self.t.copy_(time)
        self.alive.fill_(True)
        self.lvl.zero_()

    def level_body(self, bounce):
        o_n, d_n, alive_n = _level(bounce, self.rec, self.lvl, self.o, self.d,
                                   self.t, self.alive, self.u)
        self.o.copy_(o_n)
        self.d.copy_(d_n)
        self.alive.copy_(alive_n)
        self.lvl.add_(1)

    def step(self, bounce, counters):
        """Run the next level: eagerly the first time, then as the
        captured graph (a capture or replay that fails raises)."""
        if self.level is None and self.ran:
            graph = _cuda.Graph()
            graph.capture(lambda: self.level_body(bounce))
            self.level = graph
        if self.level is not None:
            self.level.replay()
            if counters is not None:
                counters["replays"] = counters.get("replays", 0) + 1
        else:
            self.level_body(bounce)
            self.ran = True

    def combine_body(self, max_contribution):
        self.L.copy_(self.rec.combine(self.steps, max_contribution))
        alive0 = self.rec.cnt[:, 0]
        self.seg.copy_(alive0.sum(dtype=torch.int64))
        self.rec_levels.copy_((alive0 > 0).sum())

    def finish(self, n_run: int, max_contribution):
        """Zero the rows no level of this call wrote, then the combine (a
        graph from the second call on)."""
        if n_run < self.steps:
            for r in (self.rec.E, self.rec.W, self.rec.cf, self.rec.cnt):
                r[n_run:].zero_()
        if self.combine is None and self.combined:
            graph = _cuda.Graph()
            graph.capture(lambda: self.combine_body(max_contribution))
            self.combine = graph
        if self.combine is not None:
            self.combine.replay()
        else:
            self.combine_body(max_contribution)
            self.combined = True


def graph_route(ds, route=None) -> bool:
    """Whether `_bounce` on ds reads nothing back to the host, so that a
    CUDA graph can capture a level of it: always but on a BVH mesh's
    binned routes (`ops/trace.GRAPH_ROUTES`)."""
    if not ds.has_tri_bvh:
        return True
    route = route or {}
    return trace_mod.resolve_route(route.get("mesh", "auto"),
                                   route.get("b1_fused", False)) \
        in trace_mod.GRAPH_ROUTES


def radiance(ds, o, d, time, gen, max_depth: int, max_contribution: float,
             mode: str = "scan", backend: str = "xla", uniforms=None,
             route=None, counters=None, graph=None):
    """Radiance (N, 3) of camera rays (o, d, time). Returns (L, stats):
    stats["segments"] the number of traced ray segments, a 0-d int64
    tensor on the rays' device (no host read: a caller that needs the
    int reads it once, as `render/renderer.render` does at the end of a
    render); stats["levels"] the levels recorded (JAX's count: levels
    with a live lane at their start), steps in mode "scan" and a 0-d
    device tensor in mode "while"; stats["levels_run"] (int) the levels
    run, which in mode "while" on the card may pass the drain;
    stats["graph"] whether the levels replayed as a CUDA graph.

    ds = `ops/trace.to_device(scene, device)`; gen: the torch.Generator on
    the rays' device that draws each level's (N, N_FIXED_U + media)
    uniforms, or `uniforms` (max_depth + 1, N, ...) given in its place.
    The levels write their records into fixed buffers (`Records`) at a
    device level index, and the reverse combine runs over them. mode
    "scan" runs max_depth + 1 levels; "while" stops once no ray is alive,
    seen through `ops/_cuda.DrainWatch`: on the CPU at once, on the card
    behind an event, so the host never makes a synchronizing call; it runs
    at most RUN_AHEAD levels past the last it has seen, and the levels it
    runs past the drain record only dead lanes, which add nothing. So that the
    draws do not follow the host's pace, a "while" call on the card then
    moves gen on as if it had drawn every level (the generator's offset).
    backend: "xla" the tensor-code bounce (`_bounce`), "pallas" the K3
    kernel (`ops/bounce.bounce`; on CPU tensors its plain version),
    "auto" the kernel where `use_kernel` allows it; where the kernel
    would run while autograd is on and a parameter tensor of ds or a ray
    tensor requires a gradient, it raises ValueError (no switch to
    "xla"). `route` and `counters` go to a BVH mesh's closest hit.

    `graph`: None replays each level as one CUDA graph (`Levels`, kept in
    ds.engine) wherever it can: on the card, off the binned routes
    (`graph_route`), with no autograd to record and outside another
    capture; elsewhere the same levels run eagerly. False always runs
    them eagerly; True raises ValueError where they cannot be captured.
    A graphed call and an eager one on the same inputs and draws give
    the same bits."""
    if mode not in ("scan", "while"):
        raise ValueError(f"unknown mode {mode!r}")
    n = o.shape[0]
    dev = o.device
    kernel = use_kernel(ds, n, backend)
    wants = []
    if torch.is_grad_enabled():
        wants = [k for k, v in trace_mod.param_tensors(ds).items()
                 if v.requires_grad]
        wants += [k for k, v in (("o", o), ("d", d), ("time", time))
                  if v.requires_grad]
    if kernel and wants:
        raise ValueError(
            f"backend {backend!r} runs the bounce as the K3 kernel, "
            f"which is forward-only, but {', '.join(wants)} require a "
            "gradient: use backend 'xla', or torch.no_grad()")
    capturable = (dev.type == "cuda" and not wants and graph_route(ds, route)
                  and not torch.cuda.is_current_stream_capturing())
    if graph is None:
        graph = capturable
    elif graph and not capturable:
        raise ValueError(
            "graph=True: these levels cannot be captured (not on the card, "
            "a binned mesh route, autograd recording, or inside a capture)")
    k3 = kernel_launch(ds) if kernel else None
    n_u = N_FIXED_U + ds.media.kind.shape[0]
    steps = max_depth + 1
    skip = mode == "while" and uniforms is None and dev.type == "cuda"
    offsets = []

    def draw(s, out=None):
        if uniforms is not None:
            return uniforms[s] if out is None else out.copy_(uniforms[s])
        if skip and s == 0:
            offsets.append(gen.get_offset())
        u = out.uniform_(generator=gen) if out is not None else torch.rand(
            (n, n_u), generator=gen, dtype=o.dtype, device=dev)
        if skip and s == 0:
            offsets.append(gen.get_offset())
        return u

    if graph:
        # the graphs hold the addresses of what they read: the K3 launch's
        # tables, the parameter tensors, the counters dict
        key = (n, steps, n_u, o.dtype, str(dev), float(max_contribution),
               tuple(sorted((route or {}).items())), k3, counters,
               *trace_mod.param_tensors(ds).values())
        lv = ds.engine.get("levels")
        if lv is None or not lv.made_for(key):
            lv = ds.engine["levels"] = Levels(n, steps, n_u, o.dtype, dev,
                                              key, kernel)
        rec = lv.rec
        lv.begin(o, d, time)
    else:
        if kernel:
            o, d, time = o.contiguous(), d.contiguous(), time.contiguous()
        rec = Records.zeros(steps, n, o.dtype, dev)
        index = torch.arange(steps, device=dev)
        alive = torch.ones((n,), dtype=torch.bool, device=dev)
    def bounce(o_, d_, t_, alive_, u_):
        if k3 is None:
            return _bounce(ds, o_, d_, t_, alive_, u_, route=route,
                           counters=counters)
        return k3(o_, d_, t_, alive_, u_, out=lv.out if graph else None)[:6]

    watch = _cuda.DrainWatch(rec.cnt, lambda row, s: row[1] == 0,
                             ahead=RUN_AHEAD) if mode == "while" else None
    n_run = 0
    for s in range(steps):
        if graph:
            draw(s, lv.u)
            lv.step(bounce, counters)
        else:
            o, d, alive = _level(bounce, rec, index[s:s + 1], o, d, time,
                                 alive, draw(s))
        n_run = s + 1
        if watch is not None:
            watch.record(s)
            if watch.drained():
                break
    if skip and n_run < steps:
        gen.set_offset(offsets[0] + steps * (offsets[1] - offsets[0]))
    if graph:
        lv.finish(n_run, max_contribution)
        L, segments, recorded = (lv.L.clone(), lv.seg.clone(),
                                 lv.rec_levels.clone())
    else:
        L = rec.combine(n_run, max_contribution)
        segments = rec.cnt[:, 0].sum(dtype=torch.int64)
        recorded = (rec.cnt[:, 0] > 0).sum()
    return L, {"segments": segments,
               "levels": steps if mode == "scan" else recorded,
               "levels_run": n_run, "graph": bool(graph)}
