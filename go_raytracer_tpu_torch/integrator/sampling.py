"""Texture evaluation and light-importance sampling on tensors.

Counterpart of the JAX package's `integrator/sampling.py`: the reference's
Texture.Value implementations (hittable/texture.go), the Pdf family
(hittable/pdf.go) and the per-primitive PdfValue/Random
(hittable/objects.go:52-80, 152-165, 356-385; hittable/hittable.go:89-103),
as pure functions over a ray batch. Dispatch on texture or light kind is a
masked select; the per-light pdf matrix is (N, L), L the small light
count. `ds` is `ops/trace.to_device(scene, device)`.
"""

from __future__ import annotations

import torch

from go_raytracer_tpu_torch.core import onb, rng, vecmath as vm
from go_raytracer_tpu_torch.ops import bounce as bounce_mod
from go_raytracer_tpu_torch.ops import intersect as ix
from go_raytracer_tpu_torch.scene import perlin as perlin_mod
from go_raytracer_tpu_torch.scene import types as T


# --------------------------------------------------------------------------
# Textures
# --------------------------------------------------------------------------

def param_rows(table, idx):
    """table[idx] for a parameter table (a leaf of `parallel/mesh.
    extract_params`) and per-ray row ids idx (N,): `index_select`, whose
    backward is an `index_add_`. On CUDA that is an atomic scatter-add, so
    two runs' gradients may differ in the last bits; the backward of
    `table[idx]` is a sorted accumulation that runs each row's
    contributions one after another, ~21 ms a gather at 262,144 rays on a
    4-row table (NVIDIA H100, PERF.md)."""
    return torch.index_select(table, 0, idx)


def texture_value(ds, tex_id, u, v, p):
    """Texture colour (N, 3) at (u, v, p) for per-ray texture ids."""
    tx = ds.textures
    kind = tx.kind[tex_id]
    out = param_rows(tx.color, tex_id)  # TEX_SOLID (texture.go:25-27)

    # checkerboard by the parity of the summed floor(p / scale)
    # (texture.go:50-60): Go's int truncation of an already floored float
    # is floor, and a floor-mod by 2 classifies negative sums as Go does
    ints = torch.floor(tx.inv_scale[tex_id][:, None] * p).to(torch.int32)
    is_even = torch.remainder(ints.sum(-1), 2) == 0
    checker = torch.where(is_even[:, None], param_rows(tx.even, tex_id),
                          param_rows(tx.odd, tex_id))
    out = torch.where((kind == T.TEX_CHECKER)[:, None], checker, out)

    if ds.has_image:
        img_id = tx.image_id[tex_id].to(torch.int64)
        val = bounce_mod.image_value(ds.images.data, ds.images.wh, img_id,
                                     u, v)
        out = torch.where((kind == T.TEX_IMAGE)[:, None], val, out)

    if ds.has_noise:
        scale = tx.scale[tex_id]
        seed = ds.perlin_seed[tx.noise_id[tex_id].to(torch.int64)]
        needs_turb = (kind == T.TEX_MARBLE) | (kind == T.TEX_TURBULENT)
        needs_noise = (kind == T.TEX_PERLIN) | needs_turb
        ps = p * scale[:, None]
        nz = perlin_mod.noise_planes(seed, ps[:, 0], ps[:, 1], ps[:, 2])
        # turbulence at the unscaled p (texture.go:117-119)
        tb = perlin_mod.turbulence_planes(seed, p[:, 0], p[:, 1], p[:, 2])
        gray = torch.where(
            kind == T.TEX_PERLIN, 0.5 * (1.0 + nz),               # :115
            torch.where(kind == T.TEX_MARBLE,
                        0.5 * (1.0 + torch.sin(scale * p[:, 2] + 10.0 * tb)),
                        tb))                                      # :117, :119
        out = torch.where(needs_noise[:, None], gray[:, None].expand(-1, 3),
                          out)
    return out


# --------------------------------------------------------------------------
# Light pdf: (1/K) sum of the per-light pdfs (hittable.go:89-97)
# --------------------------------------------------------------------------

def _quad_light_pdf(ds, lt_pid, o, d):
    """(N, L) solid-angle pdf of quad lights (objects.go:152-160)."""
    qd = ds.quads
    pid = torch.clamp(lt_pid, 0, qd.area.shape[0] - 1).to(torch.int64)
    n = qd.normal[pid]
    cvw, cwu, q = qd.cvw[pid], qd.cwu[pid], qd.q[pid]
    dn = d @ n.T
    on = o @ n.T
    # the masked parallel lanes must not make inf or NaN cotangents
    dn_safe = torch.where(torch.abs(dn) >= ix.PARALLEL_EPS, dn, 1.0)
    t = (qd.d_plane[pid][None, :] - on) / dn_safe
    alpha = (o @ cvw.T) + t * (d @ cvw.T) - vm.dot(q, cvw)[None, :]
    beta = (o @ cwu.T) + t * (d @ cwu.T) - vm.dot(q, cwu)[None, :]
    hit = ((torch.abs(dn) >= ix.PARALLEL_EPS) & (t >= 1e-3)
           & (alpha >= 0) & (alpha <= 1) & (beta >= 0) & (beta <= 1))
    dlen_sq = vm.length_squared(d, keepdim=True)
    dlen = torch.sqrt(dlen_sq)
    # dist^2 / (cos * area), dist^2 = t^2 |d|^2, cos = |d.n| / |d|
    pdf = t * t * dlen_sq * dlen / (torch.abs(dn_safe) * qd.area[pid][None, :])
    return torch.where(hit, pdf, 0.0)


def _sphere_light_pdf(ds, lt_pid, o, d):
    """(N, L) solid-angle pdf of sphere lights (objects.go:52-62). The
    reference's sqrt(1 - r^2 / dist^2) is unguarded, so from inside the
    sphere it is NaN, which the film's NaN guard zeroes; the NaN is kept
    here as a constant, so the square root only ever sees a positive
    argument and its derivative stays finite (GRAD.md). The reciprocal
    takes the same double where: a lane whose origin lies on or inside
    the light (a hit on its surface, the rounding then decides) gets the
    reference's NaN or inf as a constant, so 1 / solid_angle's derivative
    never meets it. The JAX package divides unguarded there: its backward
    gives NaN to every leaf upstream of such a lane, even where the pdf
    is not used (modelExample's fuzz on the card, PERF.md)."""
    sp = ds.spheres
    pid = torch.clamp(lt_pid, 0, sp.radius.shape[0] - 1).to(torch.int64)
    c0 = sp.center0[pid]      # PdfValue uses the centre at time 0 (:57)
    r = sp.radius[pid]
    r1, r2, ok = ix.sphere_roots(c0[None, :, :], r[None, :], o[:, None, :],
                                 d[:, None, :])
    sur = lambda t: (t > 1e-4) & torch.isfinite(t)  # the open (.0001, inf)
    root = torch.where(sur(r1), r1, r2)
    hit = ok & sur(root)
    dist_sq = vm.length_squared(c0[None, :, :] - o[:, None, :])
    arg = 1.0 - (r * r)[None, :] / dist_sq
    safe = torch.sqrt(torch.where(arg > 0, arg, 1.0))
    cos_theta_max = torch.where(
        arg > 0, safe, torch.where(arg == 0, 0.0, float("nan")))
    solid_angle = 2.0 * torch.pi * (1.0 - cos_theta_max)
    ok = hit & (solid_angle > 0)
    pdf = 1.0 / torch.where(ok, solid_angle, 1.0)
    return torch.where(ok, pdf, torch.where(hit, 1.0 / solid_angle.detach(),
                                            0.0))


def _tri_light_pdf(ds, lt_pid, o, d):
    """(N, L) pdf of triangle lights (objects.go:356-367)."""
    tr = ds.triangles
    pid = torch.clamp(lt_pid, 0, tr.area.shape[0] - 1).to(torch.int64)
    v0, e0, e1 = tr.v0[pid][None], tr.e0[pid][None], tr.e1[pid][None]
    ob = o[:, None, :]
    db = d[:, None, :]
    pvec = vm.cross(db, e1)
    det = vm.dot(e0, pvec)
    inv = 1.0 / torch.where(torch.abs(det) < 1e-30, 1e-30, det)
    tvec = ob - v0
    uu = vm.dot(tvec, pvec) * inv
    qvec = vm.cross(tvec, e0)
    vv = vm.dot(db, qvec) * inv
    t = vm.dot(e1, qvec) * inv
    hit = ((torch.abs(det) >= ix.PARALLEL_EPS) & (uu >= 0) & (uu <= 1)
           & (vv >= 0) & (uu + vv <= 1) & (t >= 1e-3))
    dlen_sq = vm.length_squared(d, keepdim=True)
    dlen = torch.sqrt(dlen_sq)
    dn = vm.dot(db, tr.n_face[pid][None])
    pdf = t * t * dlen_sq * dlen / (torch.abs(dn) * tr.area[pid][None, :])
    return torch.where(hit, pdf, 0.0)


def lights_pdf_value(ds, o, d):
    """Mean of the live lights' pdfs (hittable.go:89-97), (N,)."""
    lt = ds.lights
    if lt.n == 0:
        return torch.zeros(o.shape[0], dtype=o.dtype, device=o.device)
    kind = lt.kind[None, :]
    per_light = torch.zeros((o.shape[0], lt.kind.shape[0]), dtype=o.dtype,
                            device=o.device)
    if ds.has_quad_lights:
        per_light = torch.where(kind == T.LIGHT_QUAD,
                                _quad_light_pdf(ds, lt.prim_id, o, d),
                                per_light)
    if ds.has_sphere_lights:
        per_light = torch.where(kind == T.LIGHT_SPHERE,
                                _sphere_light_pdf(ds, lt.prim_id, o, d),
                                per_light)
    if ds.has_tri_lights and ds.has_triangles:
        per_light = torch.where(kind == T.LIGHT_TRIANGLE,
                                _tri_light_pdf(ds, lt.prim_id, o, d),
                                per_light)
    live = (torch.arange(lt.kind.shape[0], device=o.device) < lt.n)[None, :]
    return torch.sum(torch.where(live, per_light, 0.0), dim=1) / lt.n


def lights_sample(ds, origin, u_pick, u1, u2):
    """Direction toward a uniformly chosen light (hittable.go:98-103),
    (N, 3), not normalised."""
    lt = ds.lights
    n = max(lt.n, 1)
    li = torch.clamp((u_pick * n).to(torch.int64), max=n - 1)
    kind = lt.kind[li]
    pid = lt.prim_id[li].to(torch.int64)
    out = torch.zeros_like(origin)
    if ds.has_quad_lights:
        # a point of the quad (objects.go:161-165)
        qd = ds.quads
        qpid = torch.clamp(pid, 0, qd.area.shape[0] - 1)
        p_q = qd.q[qpid] + u1[:, None] * qd.u[qpid] + u2[:, None] * qd.v[qpid]
        out = torch.where((kind == T.LIGHT_QUAD)[:, None], p_q - origin, out)
    if ds.has_sphere_lights:
        # the cone toward the sphere (objects.go:63-80)
        sp = ds.spheres
        spid = torch.clamp(pid, 0, sp.radius.shape[0] - 1)
        to_c = sp.center0[spid] - origin
        local = rng.to_sphere(sp.radius[spid], vm.length_squared(to_c), u1, u2)
        dir_s = onb.transform(onb.build(to_c), local)
        out = torch.where((kind == T.LIGHT_SPHERE)[:, None], dir_s, out)
    if ds.has_tri_lights and ds.has_triangles:
        # a barycentric point of the triangle (objects.go:369-385)
        tr = ds.triangles
        tpid = torch.clamp(pid, 0, tr.area.shape[0] - 1)
        r2 = u2 * (1.0 - u1)
        a = 1.0 - u1 - r2
        v0 = tr.v0[tpid]
        p_t = a[:, None] * v0 + u1[:, None] * (v0 + tr.e0[tpid]) \
            + r2[:, None] * (v0 + tr.e1[tpid])
        out = torch.where((kind == T.LIGHT_TRIANGLE)[:, None], p_t - origin,
                          out)
    return out
