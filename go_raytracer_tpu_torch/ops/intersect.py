"""Dense ray-primitive hit distances in matrix-product form.

Counterpart of the JAX package's `ops/intersect.py`: every ray against
every sphere, quad, fused box or triangle, as (N, 3) @ (3, P) products
plus elementwise work, and the boundary spans of the media. The mesh path
takes the row minimum as the cap `t_cap` that prunes the triangle
traversal (the cross-class shrinking rayT.Max of hittable/bvh.go:69-82);
the reference engine (`ops/trace.trace`) takes each class's minimum as
its candidate. These are plain matrix products in the JAX package too (no
kernel), so `torch.matmul` is their port.

Tables are namespaces of tensors on the rays' device (`ops/trace.to_device`).
"""

from __future__ import annotations

import torch

INF = float("inf")
PARALLEL_EPS = 1e-8


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 3) @ (P, 3)^T in float32."""
    return torch.matmul(a, b.T)


def _dot(a, b, keepdim=False):
    return torch.sum(a * b, dim=-1, keepdim=keepdim)


def sphere_ts(sp, o, d, time, t_min: float, t_max: float) -> torch.Tensor:
    """Hit distances (N, S) for the sphere table (objects.go:83-115), inf
    where a ray misses. With C(t) = C0 + t*Cd,
      h = d.C(t) - d.O,   c = |C(t)|^2 - 2 O.C(t) + |O|^2 - r^2."""
    c0, cd, r = sp.center0, sp.center_delta, sp.radius
    tcol = time[:, None]
    d_c = _mm(d, c0) + tcol * _mm(d, cd)
    h = d_c - _dot(d, o, keepdim=True)
    a = _dot(d, d, keepdim=True)
    c0_sq = _dot(c0, c0)[None, :]
    c0_cd = _dot(c0, cd)[None, :]
    cd_sq = _dot(cd, cd)[None, :]
    o_c = _mm(o, c0) + tcol * _mm(o, cd)
    o_sq = _dot(o, o, keepdim=True)
    c = (c0_sq + 2.0 * tcol * c0_cd + tcol * tcol * cd_sq) - 2.0 * o_c \
        + o_sq - (r * r)[None, :]
    disc = h * h - a * c
    sqrtd = torch.sqrt(torch.where(disc > 0.0, disc, 1.0))
    root1 = (h - sqrtd) / a
    root2 = (h + sqrtd) / a
    surrounds = lambda t: (t_min < t) & (t < t_max)   # interval.go:31-35
    root = torch.where(surrounds(root1), root1, root2)
    valid = (disc >= 0.0) & surrounds(root) & sp.active[None, :]
    return torch.where(valid, root, INF)


def quad_ts(qd, o, d, t_min: float, t_max: float) -> torch.Tensor:
    """Hit distances (N, Q) for the quad table (objects.go:167-206)."""
    dn = _mm(d, qd.normal)
    on = _mm(o, qd.normal)
    dn_safe = torch.where(torch.abs(dn) >= PARALLEL_EPS, dn, 1.0)
    t = (qd.d_plane[None, :] - on) / dn_safe
    alpha = _mm(o, qd.cvw) + t * _mm(d, qd.cvw) - _dot(qd.q, qd.cvw)[None, :]
    beta = _mm(o, qd.cwu) + t * _mm(d, qd.cwu) - _dot(qd.q, qd.cwu)[None, :]
    valid = ((torch.abs(dn) >= PARALLEL_EPS)
             & (t_min <= t) & (t <= t_max)
             & (alpha >= 0.0) & (alpha <= 1.0)
             & (beta >= 0.0) & (beta <= 1.0) & qd.active[None, :])
    return torch.where(valid, t, INF)


def box_ts(bx, o, d, t_min: float, t_max: float) -> torch.Tensor:
    """Hit distances (N, B) for the fused-box table: the slab entry when
    it clears t_min, else the exit (ray starts inside), in each row's
    object space (rotate-Y + translate, transformation.go)."""
    cos, sin = bx.cos_t[None, :], bx.sin_t[None, :]
    osh = o[:, None, :] - bx.offset[None, :, :]
    o_obj = torch.stack([cos * osh[..., 0] - sin * osh[..., 2], osh[..., 1],
                         sin * osh[..., 0] + cos * osh[..., 2]], dim=-1)
    dy_b = d[:, None, 1].expand(o.shape[0], bx.cos_t.shape[0])
    d_obj = torch.stack([cos * d[:, None, 0] - sin * d[:, None, 2], dy_b,
                         sin * d[:, None, 0] + cos * d[:, None, 2]], dim=-1)
    d_safe = torch.where(torch.abs(d_obj) < 1e-30,
                         torch.where(d_obj < 0, -1e-30, 1e-30), d_obj)
    inv = 1.0 / d_safe
    t0 = (bx.lo[None, :, :] - o_obj) * inv
    t1 = (bx.hi[None, :, :] - o_obj) * inv
    near = torch.minimum(t0, t1).amax(dim=-1)
    far = torch.maximum(t0, t1).amin(dim=-1)
    t = torch.where(near >= t_min, near, far)
    valid = ((far > near) & (t_min <= t) & (t <= t_max)
             & bx.active[None, :])
    return torch.where(valid, t, INF)


def tri_ts(tr, o, d, t_min: float, t_max: float) -> torch.Tensor:
    """Hit distances (N, T) of every ray against every triangle
    (Moller-Trumbore, objects.go:408-461): the dense oracle the tests hold
    the mesh intersectors against. O(N*T) memory; small inputs only."""
    e0, e1, v0 = tr.e0[None], tr.e1[None], tr.v0[None]
    dd = d[:, None, :].expand(-1, e0.shape[1], -1)
    pvec = torch.linalg.cross(dd, e1.expand_as(dd))
    det = _dot(e0, pvec)
    inv = 1.0 / torch.where(torch.abs(det) < 1e-30, 1e-30, det)
    tvec = o[:, None, :] - v0
    u = _dot(tvec, pvec) * inv
    qvec = torch.linalg.cross(tvec, e0.expand_as(tvec))
    v = _dot(dd, qvec) * inv
    t = _dot(e1, qvec) * inv
    ok = ((torch.abs(det) >= PARALLEL_EPS) & (u >= 0.0) & (u <= 1.0)
          & (v >= 0.0) & (u + v <= 1.0) & (t_min <= t) & (t <= t_max)
          & tr.active[None, :])
    return torch.where(ok, t, INF)


def tri_ts_factored(tr, o, d, t_min: float, t_max: float) -> torch.Tensor:
    """Hit distances (N, T) in the JAX package's GEMM form of
    Moller-Trumbore (objects.go:408-461), the dense triangle class of its
    `trace`: with m = O x d, det = -(d.cn), u det = m.e1 - d.c_e1v0,
    v det = -m.e0 - d.c_v0e0 and t det = O.cn - k, from the triangle
    table's precomputed cn, c_e1v0, c_v0e0 and k."""
    m = torch.linalg.cross(o, d)
    det = -_mm(d, tr.cn)
    u_det = _mm(m, tr.e1) - _mm(d, tr.c_e1v0)
    v_det = -_mm(m, tr.e0) - _mm(d, tr.c_v0e0)
    t_det = _mm(o, tr.cn) - tr.k[None, :]
    ok_det = torch.abs(det) >= PARALLEL_EPS
    inv = 1.0 / torch.where(ok_det, det, 1.0)
    u = u_det * inv
    v = v_det * inv
    t = t_det * inv
    valid = (ok_det & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t_min <= t) & (t <= t_max) & tr.active[None, :])
    return torch.where(valid, t, INF)


def sphere_roots(center, radius, o, d):
    """Both quadratic roots (near, far) and a validity flag, for medium
    boundary spans and the light pdf; `center` (..., 3) broadcasts against
    `o`. The square root's argument is guarded (`core/rng._sqrt0`'s
    double where), so its derivative stays finite where disc <= 0."""
    oc = center - o
    a = _dot(d, d)
    h = _dot(d, oc)
    c = _dot(oc, oc) - radius * radius
    disc = h * h - a * c
    pos = disc > 0
    sqrtd = torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)
    return (h - sqrtd) / a, (h + sqrtd) / a, disc >= 0.0


def box_slab_span(box_min, box_max, o, d):
    """Slab entry and exit (t_near, t_far, hit) of an axis box, the first
    and second quad hits of the reference's box-of-quads boundary
    (aabb.go:90-113) for the medium path."""
    d_safe = torch.where(torch.abs(d) < 1e-30,
                         torch.where(d < 0, -1e-30, 1e-30), d)
    inv = 1.0 / d_safe
    t0 = (box_min - o) * inv
    t1 = (box_max - o) * inv
    near = torch.minimum(t0, t1).amax(dim=-1)
    far = torch.maximum(t0, t1).amin(dim=-1)
    return near, far, far > near
