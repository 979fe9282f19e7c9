"""A plain path tracer in PyTorch: the benchmark's reference for the scenes
of `benchmark/configs`.

It reads a configuration file's scene (quads, boxes turned about y,
spheres, a triangle mesh; lambertian, metal and diffuse-light materials;
the lights list sampled by a 50/50 mixture with the cosine pdf) and
renders it with the semantics of the upstream renderer (nsp5488/
go_raytracer, camera.go's rayColor): max_depth + 1 surface interactions,
the deepest child black, emission from a light's front face only, the
firefly clamp applied at each diffuse vertex of the recursion
L = clamp(E + W * L_child), evaluated backwards over the recorded levels.

Each level's random numbers come from the caller, nine a ray in the
slots [metal a, metal b, dielectric, mixture, light pick, light a, light
b, material a, material b] and five a camera ray [jitter x, jitter y,
disk a, disk b, time], so a caller can hand it the numbers a program
under test drew and follow the same paths. Plain tensor code, out of
place, so autograd runs through it; `dtype` sets the precision of every
float (the benchmark's control runs it in bfloat16). It imports nothing
of the program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.statue import rotate_y, statue_triangles

T_MIN = 1e-3
PARALLEL_EPS = 1e-8
SMALL_LEVEL = 2048
N_U = 9
N_U_CAMERA = 5
U_METAL_A, U_METAL_B, U_DIEL, U_MIX, U_PICK, U_LA, U_LB, U_MA, U_MB = range(9)
KINDS = {"lambertian": 0, "metal": 1, "diffuse_light": 2}


def _dot(a, b):
    return (a * b).sum(-1)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _unit(v):
    n2 = _dot(v, v)[..., None]
    pos = n2 > 0
    length = torch.where(pos, torch.sqrt(torch.where(pos, n2, 1.0)), 0.0)
    return v / torch.clamp(length, min=torch.finfo(v.dtype).tiny)


def _sqrt0(x):
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


class Scene:
    """A configuration file's scene as tensors on `device` in `dtype`."""

    def __init__(self, cfg: dict, device, dtype=torch.float32):
        self.device, self.dtype = torch.device(device), dtype
        f = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),
                                      dtype=dtype, device=self.device)
        mats = cfg["materials"]
        index = {m["name"]: i for i, m in enumerate(mats)}
        self.mat_names = [m["name"] for m in mats]
        self.kind = torch.tensor([KINDS[m["kind"]] for m in mats],
                                 device=self.device)
        self.colors = f([m["color"] for m in mats])
        self.fuzz = f([m.get("fuzz", 0.0) for m in mats])
        self.background = f(cfg["background"])
        quads, boxes, spheres, lights = [], [], [], []
        tris = None
        for ob in cfg["objects"]:
            mat = index[ob["material"]]
            if ob["kind"] == "quad":
                quads.append((ob["q"], ob["u"], ob["v"], mat))
                if ob.get("light"):
                    lights.append(("quad", len(quads) - 1))
            elif ob["kind"] == "box":
                boxes.append((np.minimum(ob["a"], ob["b"]),
                              np.maximum(ob["a"], ob["b"]),
                              math.radians(ob.get("rotate_y_deg", 0.0)),
                              ob.get("translate", (0, 0, 0)), mat))
            elif ob["kind"] == "sphere":
                spheres.append((ob["center"], ob["radius"], mat))
                if ob.get("light"):
                    lights.append(("sphere", len(spheres) - 1))
            elif ob["kind"] == "mesh":
                tris = (mesh_vertices(cfg["mesh"], ob), mat)
            else:
                raise ValueError(f"unknown object kind {ob['kind']!r}")
        self.quads = None
        if quads:
            q, u, v = (f([x[i] for x in quads]) for i in range(3))
            n = _cross(u, v)
            normal = _unit(n)
            w = n / _dot(n, n)[:, None]
            self.quads = dict(q=q, u=u, v=v, normal=normal,
                              d=_dot(normal, q), cvw=_cross(v, w),
                              cwu=_cross(w, u), area=torch.sqrt(_dot(n, n)),
                              mat=torch.tensor([x[3] for x in quads],
                                               device=self.device))
        self.boxes = None
        if boxes:
            self.boxes = dict(
                lo=f([b[0] for b in boxes]), hi=f([b[1] for b in boxes]),
                cos=f([math.cos(b[2]) for b in boxes]),
                sin=f([math.sin(b[2]) for b in boxes]),
                offset=f([b[3] for b in boxes]),
                mat=torch.tensor([b[4] for b in boxes], device=self.device))
        self.spheres = None
        if spheres:
            self.spheres = dict(
                center=f([s[0] for s in spheres]),
                radius=f([s[1] for s in spheres]),
                mat=torch.tensor([s[2] for s in spheres], device=self.device))
        self.tris = None
        if tris is not None:
            v, mat = tris
            groups = _median_groups((v[:, 0] + v[:, 1] + v[:, 2]) / 3.0)
            v = v[np.concatenate(groups)]
            v0, e0, e1 = f(v[:, 0]), f(v[:, 1] - v[:, 0]), f(v[:, 2] - v[:, 0])
            cn = _cross(e0, e1)
            zero = torch.zeros_like(cn)
            # det, u det, v det and t det of Moller-Trumbore as one product
            # of [d, o x d, o] with a (9, 4T) matrix (k subtracted after)
            gemm = torch.stack([   # (T, [d, o x d, o], xyz, 4)
                torch.stack([-cn, -_cross(e1, v0), -_cross(v0, e0), zero], -1),
                torch.stack([zero, e1, -e0, zero], -1),
                torch.stack([zero, zero, zero, cn], -1)], 1).reshape(-1, 9, 4)
            k = _dot(cn, v0)
            box, start = [], 0
            for g in groups:
                sl = slice(start, start + len(g))
                corners = v[sl].reshape(-1, 3)
                box.append(dict(lo=f(corners.min(0)), hi=f(corners.max(0)),
                                start=start, k=k[sl],
                                gemm=gemm[sl].permute(1, 2, 0)
                                .reshape(9, -1).contiguous()))
                start += len(g)
            self.tris = dict(normal=_unit(cn), mat=mat, groups=box,
                             whole=dict(start=0, k=k, gemm=gemm.permute(1, 2, 0)
                                        .reshape(9, -1).contiguous()))
        self.lights = lights


def _median_groups(centroids: np.ndarray, leaf: int = 1024) -> list:
    """Triangle indices split at the median of the widest axis of their
    centroids until each group holds at most `leaf`."""
    out, todo = [], [np.arange(len(centroids))]
    while todo:
        idx = todo.pop()
        if len(idx) <= leaf:
            out.append(idx)
            continue
        c = centroids[idx]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        order = idx[np.argsort(c[:, axis], kind="stable")]
        todo += [order[len(order) // 2:], order[:len(order) // 2]]
    return out


def mesh_vertices(mesh: dict, ob: dict) -> np.ndarray:
    """World-space (T, 3, 3) float64 vertices of a mesh object."""
    if mesh["kind"] != "procedural_statue":
        raise ValueError(f"unknown mesh kind {mesh['kind']!r}")
    v = statue_triangles(mesh["major_segments"], mesh["minor_segments"],
                         mesh["scale_factor"], mesh["center"],
                         mesh["position"])
    return rotate_y(v, ob.get("rotate_y_deg", 0.0)) \
        + np.asarray(ob.get("translate", (0, 0, 0)), dtype=np.float64)


# --------------------------------------------------------------- camera

def camera_frame(cam: dict) -> dict:
    """The thin-lens camera's vectors (camera.go's initialize) in float64."""
    width = cam["width"]
    height = max(1, int(width / cam["aspect_ratio"]))
    lf, la, vup = (np.asarray(cam[k], dtype=np.float64)
                   for k in ("look_from", "look_at", "vup"))
    focus = cam["focus_distance"]
    vp_h = 2.0 * math.tan(math.radians(cam["vertical_fov"]) / 2.0) * focus
    vp_w = vp_h * (width / height)
    w = (lf - la) / np.linalg.norm(lf - la)
    u = np.cross(vup, w)
    u /= np.linalg.norm(u)
    v = np.cross(w, u)
    du, dv = u * vp_w / width, -v * vp_h / height
    top_left = lf - w * focus - u * vp_w / 2 + v * vp_h / 2
    radius = focus * math.tan(math.radians(cam["defocus_angle"] / 2.0))
    return dict(width=width, height=height, center=lf,
                pixel00=top_left + 0.5 * (du + dv), du=du, dv=dv,
                defocus_u=u * radius, defocus_v=v * radius,
                defocus=cam["defocus_angle"] > 0,
                sqrt_spp=int(math.sqrt(cam["samples_per_pixel"])))


def camera_rays(frame: dict, pixel, s_i, s_j, u, dtype):
    """Rays (origin, direction) for flat pixel ids at strata (s_i, s_j),
    from the (n, 5) camera numbers u: the stratified jitter of the pixel
    footprint, and the defocus disk's origin."""
    dev = u.device
    vec = lambda k: torch.as_tensor(frame[k].astype(np.float32),
                                    device=dev).to(dtype)
    i = (pixel % frame["width"]).to(dtype)
    j = torch.div(pixel, frame["width"], rounding_mode="floor").to(dtype)
    r = 1.0 / frame["sqrt_spp"]
    off_x = (s_i + u[:, 0]) * r - 0.5
    off_y = (s_j + u[:, 1]) * r - 0.5
    target = vec("pixel00") + (i + off_x)[:, None] * vec("du") \
        + (j + off_y)[:, None] * vec("dv")
    origin = vec("center").expand(u.shape[0], 3)
    if frame["defocus"]:
        rad, phi = torch.sqrt(u[:, 2]), 2.0 * math.pi * u[:, 3]
        origin = origin + (rad * torch.cos(phi))[:, None] * vec("defocus_u") \
            + (rad * torch.sin(phi))[:, None] * vec("defocus_v")
    return origin, target - origin


# ----------------------------------------------------------- closest hit

def _quads_hit(qd, o, d):
    """(t, index) of the nearest quad, inf where none."""
    dn = d @ qd["normal"].T
    ok = torch.abs(dn) >= PARALLEL_EPS
    t = (qd["d"][None] - o @ qd["normal"].T) / torch.where(ok, dn, 1.0)
    p = o[:, None, :] + t[..., None] * d[:, None, :]
    planar = p - qd["q"][None]
    a = _dot(planar, qd["cvw"][None])
    b = _dot(planar, qd["cwu"][None])
    ok = ok & (t >= T_MIN) & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)
    return torch.where(ok, t, math.inf).min(1)


def _to_object(bx, o, d):
    c, s = bx["cos"][None], bx["sin"][None]
    osh = o[:, None, :] - bx["offset"][None]
    rot = lambda x: torch.stack([c * x[..., 0] - s * x[..., 2], x[..., 1],
                                 s * x[..., 0] + c * x[..., 2]], -1)
    return rot(osh), rot(d[:, None, :].expand_as(osh))


def _slabs(lo, hi, o, d):
    tiny = torch.where(d < 0, -1e-30, 1e-30).to(d.dtype)
    inv = 1.0 / torch.where(torch.abs(d) < 1e-30, tiny, d)
    t0, t1 = (lo - o) * inv, (hi - o) * inv
    return torch.minimum(t0, t1), torch.maximum(t0, t1)


def _boxes_hit(bx, o, d):
    """(t, index) of the nearest box: the entry face, or the exit face for
    a ray that starts inside, in the box's own frame."""
    oo, do = _to_object(bx, o, d)
    lo_t, hi_t = _slabs(bx["lo"][None], bx["hi"][None], oo, do)
    near, far = lo_t.amax(-1), hi_t.amin(-1)
    t = torch.where(near >= T_MIN, near, far)
    ok = (far > near) & (t >= T_MIN)
    return torch.where(ok, t, math.inf).min(1)


def _box_normal(bx, idx, o, d, t):
    """Outward world normal of box idx at the hit t: the axis of the slab
    that bounds t (the entry slab, or the exit slab from inside)."""
    c, s = bx["cos"][idx], bx["sin"][idx]
    rot = lambda x: torch.stack([c * x[:, 0] - s * x[:, 2], x[:, 1],
                                 s * x[:, 0] + c * x[:, 2]], -1)
    oo, do = rot(o - bx["offset"][idx]), rot(d)
    lo_t, hi_t = _slabs(bx["lo"][idx], bx["hi"][idx], oo, do)
    entry = torch.abs(t - lo_t.amax(-1)) <= torch.abs(hi_t.amin(-1) - t)
    axis = torch.where(entry[:, None], lo_t, -hi_t).argmax(-1)
    tiny = torch.where(do < 0, -1e-30, 1e-30).to(do.dtype)
    d_safe = torch.where(torch.abs(do) < 1e-30, tiny, do)
    sgn = torch.sign(torch.gather(d_safe, 1, axis[:, None]))[:, 0]
    sgn = torch.where(entry, -sgn, sgn)
    n_obj = sgn[:, None] * torch.eye(3, dtype=o.dtype, device=o.device)[axis]
    return torch.stack([c * n_obj[:, 0] + s * n_obj[:, 2], n_obj[:, 1],
                        -s * n_obj[:, 0] + c * n_obj[:, 2]], -1)


def _sphere_roots(center, radius, o, d):
    oc = center - o
    a = _dot(d, d)
    h = _dot(d, oc)
    disc = h * h - a * (_dot(oc, oc) - radius * radius)
    sq = _sqrt0(disc)
    return (h - sq) / a, (h + sq) / a, disc >= 0


def _spheres_hit(sp, o, d):
    r1, r2, ok = _sphere_roots(sp["center"][None], sp["radius"][None],
                               o[:, None, :], d[:, None, :])
    inside = lambda t: t > T_MIN
    t = torch.where(inside(r1), r1, r2)
    return torch.where(ok & inside(t), t, math.inf).min(1)


def _tris_hit(tr, o, d, t_best, chunk):
    """(t, index) of the nearest triangle (inf, 0 where none before
    t_best): each group of triangles is tested against the rays whose
    path through the group's box starts before the best hit so far."""
    n = o.shape[0]
    t_out = t_best.clone()
    i_out = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    with torch.no_grad():
        a_all = torch.cat([d, _cross(o, d), o], -1)
        # few rays (a deep level) take every triangle at once: the groups'
        # culling would cost more launches than it saves
        few = n <= SMALL_LEVEL
        for g in [tr["whole"]] if few else tr["groups"]:
            if few:
                rows = torch.arange(n, device=o.device)
            else:
                lo_t, hi_t = _slabs(g["lo"], g["hi"], o, d)
                near = torch.clamp(lo_t.amax(-1), min=T_MIN)
                rows = torch.nonzero(
                    near <= torch.minimum(hi_t.amin(-1), t_out))[:, 0]
            n_tri = g["k"].shape[0]
            chunk_g = max(1, chunk * 1024 // n_tri)
            for start in range(0, rows.shape[0], chunk_g):
                r = rows[start:start + chunk_g]
                prod = (a_all[r] @ g["gemm"]).view(r.shape[0], 4, n_tri)
                det, u_det, v_det = prod[:, 0], prod[:, 1], prod[:, 2]
                t_det = prod[:, 3] - g["k"][None]
                ok = torch.abs(det) >= PARALLEL_EPS
                inv = 1.0 / torch.where(ok, det, 1.0)
                u, v, t = u_det * inv, v_det * inv, t_det * inv
                ok = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) \
                    & (t >= T_MIN)
                t_min, i_min = torch.where(ok, t, math.inf).min(1)
                closer = t_min < t_out[r]
                t_out[r] = torch.where(closer, t_min, t_out[r])
                i_out[r] = torch.where(closer, i_min + g["start"], i_out[r])
    hit = i_out >= 0
    return torch.where(hit, t_out, math.inf), torch.clamp(i_out, min=0)


def closest_hit(sc: Scene, o, d, chunk: int = 8192):
    """The nearest surface of each ray: (hit, t, point, face-forward
    normal, front face, material id)."""
    n = o.shape[0]
    t = torch.full((n,), math.inf, dtype=o.dtype, device=o.device)
    cls = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    loc = torch.zeros((n,), dtype=torch.int64, device=o.device)
    classes = [("sphere", sc.spheres, _spheres_hit), ("quad", sc.quads, _quads_hit),
               ("box", sc.boxes, _boxes_hit)]
    for code, (name, table, fn) in enumerate(classes):
        if table is None:
            continue
        t_c, i_c = fn(table, o, d)
        closer = t_c < t
        t, cls, loc = (torch.where(closer, t_c, t), torch.where(closer, code, cls),
                       torch.where(closer, i_c, loc))
    if sc.tris is not None:
        t_c, i_c = _tris_hit(sc.tris, o.detach(), d.detach(), t.detach(), chunk)
        closer = t_c < t
        # the triangle's distance carries no derivative
        t = torch.where(closer, t_c.to(t.dtype), t)
        cls, loc = torch.where(closer, 3, cls), torch.where(closer, i_c, loc)
    hit = cls >= 0
    t_safe = torch.where(hit, t, 1.0)
    p = o + t_safe[:, None] * d
    outward = torch.zeros_like(p)
    mat = torch.zeros((n,), dtype=torch.int64, device=o.device)
    if sc.spheres is not None:
        sp, m = sc.spheres, cls == 0
        i = torch.where(m, loc, 0)
        nrm = (p - sp["center"][i]) / sp["radius"][i][:, None]
        outward, mat = torch.where(m[:, None], nrm, outward), \
            torch.where(m, sp["mat"][i], mat)
    if sc.quads is not None:
        qd, m = sc.quads, cls == 1
        i = torch.where(m, loc, 0)
        outward, mat = torch.where(m[:, None], qd["normal"][i], outward), \
            torch.where(m, qd["mat"][i], mat)
    if sc.boxes is not None:
        bx, m = sc.boxes, cls == 2
        i = torch.where(m, loc, 0)
        outward, mat = torch.where(m[:, None], _box_normal(bx, i, o, d, t_safe),
                                   outward), torch.where(m, bx["mat"][i], mat)
    if sc.tris is not None:
        tr, m = sc.tris, cls == 3
        i = torch.where(m, loc, 0)
        outward = torch.where(m[:, None], tr["normal"][i], outward)
        mat = torch.where(m, torch.full_like(mat, tr["mat"]), mat)
    front = _dot(d, outward) < 0
    normal = torch.where(front[:, None], outward, -outward)
    return hit, p, normal, front, mat


# ---------------------------------------------------------------- lights

def _onb(n):
    """The orthonormal basis (u, v, w) about n of onb.go: helper axis y
    where |n.x| > 0.9, else x."""
    w = _unit(n)
    use_y = (torch.abs(n[..., 0]) > 0.9)[..., None].to(n.dtype)
    a = torch.cat([1.0 - use_y, use_y, torch.zeros_like(use_y)], -1)
    v = _unit(_cross(n, a))
    return _unit(_cross(n, v)), v, w


def _local(basis, x):
    u, v, w = basis
    return x[..., 0:1] * u + x[..., 1:2] * v + x[..., 2:3] * w


def lights_sample(sc: Scene, p, u_pick, u1, u2):
    """A direction from p toward a uniformly picked light (not unit)."""
    k = len(sc.lights)
    pick = torch.clamp((u_pick * k).to(torch.int64), max=k - 1)
    out = torch.zeros_like(p)
    for li, (kind, idx) in enumerate(sc.lights):
        if kind == "quad":
            qd = sc.quads
            target = qd["q"][idx] + u1[:, None] * qd["u"][idx] \
                + u2[:, None] * qd["v"][idx]
            dirs = target - p
        else:
            sp = sc.spheres
            to_c = sp["center"][idx] - p
            r = sp["radius"][idx]
            cos_max = _sqrt0(1.0 - r * r / _dot(to_c, to_c))
            z = 1.0 + u2 * (cos_max - 1.0)
            phi = 2.0 * math.pi * u1
            s = _sqrt0(1.0 - z * z)
            local = torch.stack([torch.cos(phi) * s, torch.sin(phi) * s, z], -1)
            dirs = _local(_onb(to_c), local)
        out = torch.where((pick == li)[:, None], dirs, out)
    return out


def lights_pdf(sc: Scene, p, d):
    """The mean over the lights of each light's solid-angle pdf of the
    direction d from p (0 where d misses it)."""
    total = torch.zeros(p.shape[0], dtype=p.dtype, device=p.device)
    for kind, idx in sc.lights:
        if kind == "quad":
            qd = sc.quads
            nrm = qd["normal"][idx]
            dn = _dot(d, nrm)
            ok = torch.abs(dn) >= PARALLEL_EPS
            dn_safe = torch.where(ok, dn, 1.0)
            t = (qd["d"][idx] - _dot(p, nrm)) / dn_safe
            planar = p + t[:, None] * d - qd["q"][idx]
            a, b = _dot(planar, qd["cvw"][idx]), _dot(planar, qd["cwu"][idx])
            ok = ok & (t >= T_MIN) & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)
            dd = _dot(d, d)
            pdf = t * t * dd * torch.sqrt(dd) / (torch.abs(dn_safe) * qd["area"][idx])
            total = total + torch.where(ok, pdf, 0.0)
        else:
            sp = sc.spheres
            c, r = sp["center"][idx], sp["radius"][idx]
            r1, r2, ok = _sphere_roots(c, r, p, d)
            root = torch.where(r1 > 1e-4, r1, r2)
            ok = ok & (root > 1e-4) & torch.isfinite(root)
            arg = 1.0 - r * r / _dot(c - p, c - p)
            # from inside the sphere the upstream pdf is NaN, and the
            # vertex then contributes nothing
            cos_max = torch.where(arg >= 0, _sqrt0(arg), math.nan)
            solid = 2.0 * math.pi * (1.0 - cos_max)
            good = ok & (solid > 0)
            pdf = 1.0 / torch.where(good, solid, 1.0)
            total = total + torch.where(good, pdf, torch.where(ok, 1.0 / solid.detach(), 0.0))
    return total / len(sc.lights)


# ---------------------------------------------------------------- bounce

def bounce(sc: Scene, colors, background, o, d, u, fuzz=None):
    """One bounce of live rays: (E, W, clamp flag, next origin, next
    direction, still alive)."""
    hit, p, n, front, mat = closest_hit(sc, o, d)
    kind = sc.kind[mat]
    col = colors[mat]
    zero3 = torch.zeros_like(col)
    is_light, is_metal = hit & (kind == 2), hit & (kind == 1)
    diffuse = hit & (kind == 0)
    E = torch.where(hit[:, None], zero3, background.expand_as(col))
    E = torch.where((is_light & front)[:, None], col, E)

    phi, u2 = 2.0 * math.pi * u[:, U_MA], u[:, U_MB]
    sq = torch.sqrt(u2)
    cos_dir = _local(_onb(n), torch.stack(
        [torch.cos(phi) * sq, torch.sin(phi) * sq, _sqrt0(1.0 - u2)], -1))
    light_dir = lights_sample(sc, p, u[:, U_PICK], u[:, U_LA], u[:, U_LB])
    gen = torch.where((u[:, U_MIX] < 0.5)[:, None], light_dir, cos_dir)
    cos_pdf = torch.clamp(_dot(_unit(gen), n), min=0.0) / math.pi
    pdf = 0.5 * lights_pdf(sc, p, gen) + 0.5 * cos_pdf
    ok = diffuse & (pdf > 0)
    bad = diffuse & ~ok
    ratio = torch.where(ok, cos_pdf, 0.0) / torch.where(ok, pdf, 1.0)
    W = torch.where(diffuse[:, None], col * ratio[:, None], zero3)

    z = 1.0 - 2.0 * u[:, U_METAL_A]
    rr, ph = _sqrt0(1.0 - z * z), 2.0 * math.pi * u[:, U_METAL_B]
    fuzz_vec = torch.stack([rr * torch.cos(ph), rr * torch.sin(ph), z], -1)
    refl = d - 2.0 * _dot(d, n)[:, None] * n
    fuzz = sc.fuzz if fuzz is None else fuzz
    d_metal = _unit(refl) + fuzz[mat][:, None] * fuzz_vec
    W = torch.where(is_metal[:, None], col, W)
    new_d = torch.where(is_metal[:, None], d_metal, gen)
    E = torch.where(bad[:, None], 0.0, E)
    W = torch.where(bad[:, None], 0.0, W)
    return E, W, diffuse, torch.where(hit[:, None], p, o), new_d, \
        (is_metal | diffuse) & ~bad


def clamp_sum(c, max_value):
    """Scale c so that its components sum to at most max_value."""
    s = c.sum(-1, keepdim=True)
    over = s > max_value
    return c * torch.where(over, max_value / torch.where(over, s, 1.0), 1.0)


def radiance(sc: Scene, o, d, max_depth: int, max_contribution: float,
             draw, colors=None, background=None, fuzz=None):
    """Radiance (N, 3) of rays (o, d). draw(s) gives level s's (N, 9)
    numbers; only live rays are traced at each level."""
    colors = sc.colors if colors is None else colors
    background = sc.background if background is None else background
    n = o.shape[0]
    alive = torch.ones(n, dtype=torch.bool, device=o.device)
    rows = []
    for s in range(max_depth + 1):
        u = draw(s)
        idx = torch.nonzero(alive)[:, 0]
        if idx.numel() == 0:
            break
        E, W, cf, o_n, d_n, a_n = bounce(sc, colors, background, o[idx],
                                         d[idx], u[idx].to(o.dtype), fuzz)
        put = lambda x: torch.zeros((n,) + x.shape[1:], dtype=x.dtype,
                                    device=x.device).index_copy(0, idx, x)
        rows.append((put(E), put(W), put(cf)))
        o, d = o.index_copy(0, idx, o_n), d.index_copy(0, idx, d_n)
        alive = put(a_n)
    L = torch.zeros((n, 3), dtype=o.dtype, device=o.device)
    for E, W, cf in reversed(rows):
        raw = E + W * L
        L = torch.where(cf[:, None], clamp_sum(raw, max_contribution), raw)
    return L
