"""The glue of one bounce level of the mesh path's window.

What the JAX package's `fwd_step` (integrator/regen.py there) does outside
`bounce_fn`, which XLA compiles into the window's program: before the
bounce the refill (`refill_assign`: dead lanes take the next queue items
by their rank among the dead lanes in lane order) and the taken lanes'
camera rays; after it the dead-lane zeroing, the depth cap and the merged
V/FL records. Two entry points, each beside its plain version:

* `refill` (`refill_ref`): the level's takes, ranks and camera rays, the
  lane state updated in place, the level's row of the counts plane and
  its base;
* `record` (`record_ref`): row s of the record planes, the lane state
  moved on to the bounce's outputs, and the lanes alive after the level.

On CUDA tensors both launch csrc/mesh_level.cu; on CPU tensors they run
the plain versions, today's tensor code of the window. Both take the
level s from a counter on the device (`MeshLevel.lvl`) and the cursor
from the counts plane, so one launch configuration serves every level of
a window and `integrator/regen._mesh_window` reads nothing back inside a
level.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from go_raytracer_tpu_torch.ops import _cuda
from go_raytracer_tpu_torch.render import camera as camera_mod

# Launches of the CUDA kernels through `refill` and `record` (one per
# call each; `refill` launches the dead counts and the refill).
launches_refill = 0
launches_record = 0

BLOCK = 256
# columns of the packed camera row (`pack_camera`) and of the counts plane
CAM_COLS = 20
CNT_COLS = 4
# the counts plane's columns: lanes alive after the refill (the level's
# segments), lanes alive after the bounce and its depth cap, the cursor
# after the level, the level's takes
SEGMENTS, ALIVE_AFTER, CURSOR, TAKES = range(CNT_COLS)


def pack_camera(arrays: camera_mod.CameraArrays, device) -> torch.Tensor:
    """The kernel's camera row (CAM_COLS,) float32 on `device`: center,
    pixel00, du, dv, defocus_u, defocus_v, 1 / sqrt(spp) (as the tensor
    code's float32 scalar) and the defocus flag."""
    vecs = [np.asarray(torch.as_tensor(v).detach().cpu(), np.float32)
            for v in (arrays.center, arrays.pixel00, arrays.du, arrays.dv,
                      arrays.defocus_u, arrays.defocus_v)]
    row = np.concatenate(vecs + [np.float32([arrays.recip_spp_sqrt,
                                             arrays.defocus_angle > 0])])
    return torch.from_numpy(row.astype(np.float32)).to(device)


@dataclasses.dataclass
class MeshLevel:
    """The device buffers of a mesh window's levels: the lane state (o, d
    (N, 3) float32, t (N,) float32, alive (N,) bool, depth (N,) int32),
    updated in place; the level's uniforms `u_cam` (N, 5) and `u` (N,
    n_u), drawn before each level; `start` (N,) int32, a started lane's
    flag bits 2.. (4 | rank << 3); `cnt` (rows + 1, CNT_COLS) int32, row 0
    holding the window's first cursor and row s + 1 level s's counts;
    `lvl` (1,) int32, the levels run in the window; `dcnt`, the kernel's
    per-block dead counts."""

    o: torch.Tensor
    d: torch.Tensor
    t: torch.Tensor
    alive: torch.Tensor
    depth: torch.Tensor
    u_cam: torch.Tensor
    u: torch.Tensor
    start: torch.Tensor
    cnt: torch.Tensor
    lvl: torch.Tensor
    dcnt: torch.Tensor

    @staticmethod
    def empty(n: int, rows: int, n_u: int, device) -> "MeshLevel":
        f = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
        return MeshLevel(
            o=f((n, 3), torch.float32), d=f((n, 3), torch.float32),
            t=f(n, torch.float32), alive=f(n, torch.bool),
            depth=f(n, torch.int32),
            u_cam=f((n, camera_mod.N_U_RAYGEN), torch.float32),
            u=f((n, n_u), torch.float32), start=f(n, torch.int32),
            cnt=f((rows + 1, CNT_COLS), torch.int32),
            lvl=f(1, torch.int32), dcnt=f(max(n // BLOCK, 1), torch.int32))

    @property
    def state(self) -> list:
        return [self.o, self.d, self.t, self.alive, self.depth]

    def begin(self, state, cursor):
        """Start a window: the lane state `state` (o, d, t, alive, depth)
        copied in unless it is this one's, the level counter at 0 and the
        window's first cursor (an int or a device tensor) in row 0."""
        for dst, src in zip(self.state, state):
            if dst is not src:
                dst.copy_(src)
        self.lvl.zero_()
        self.cnt[0].zero_()
        if isinstance(cursor, torch.Tensor):
            self.cnt[0, CURSOR:CURSOR + 1].copy_(cursor.reshape(1))
        else:
            self.cnt[0, CURSOR].fill_(cursor)


def refill_assign(next_item, alive, do_refill: bool, item_end: int, *,
                  npix: int, sqrt_spp: int):
    """Queue items -> dead lanes: a dead lane's item is `next_item` plus
    its rank among the dead lanes in lane order, so the lanes that take
    form a prefix of the dead lanes and map to consecutive items.
    `next_item` is a 0-d int64 tensor. Returns (take, rank, pixel id,
    stratum row, stratum column)."""
    dead = ~alive
    rank = torch.cumsum(dead.to(torch.int64), 0) - 1
    item = next_item + rank
    take = dead & (item < item_end) if do_refill else torch.zeros_like(dead)
    stratum = torch.div(item, npix, rounding_mode="floor")
    pid = item - stratum * npix
    s_i = torch.div(stratum, sqrt_spp, rounding_mode="floor")
    return (take, rank, pid, s_i.to(torch.float32),
            (stratum - s_i * sqrt_spp).to(torch.float32))


def refill_ref(lv: MeshLevel, arrays, cam, base, *, item_end: int,
               refill: int, cadence: int, width: int, npix: int,
               sqrt_spp: int):
    """Plain version of `refill` (its arguments; `cam` unused): the window's
    tensor code, the level read back from the device."""
    s = int(lv.lvl[0])
    lv.lvl += 1
    if s >= lv.cnt.shape[0] - 1:
        return
    cursor = lv.cnt[s, CURSOR].to(torch.int64)
    take, rank, pid, s_i, s_j = refill_assign(
        cursor, lv.alive, s < refill and s % cadence == 0, item_end,
        npix=npix, sqrt_spp=sqrt_spp)
    o_n, d_n, t_n = camera_mod.generate_rays(arrays, width, pid, s_i, s_j,
                                             lv.u_cam)
    lv.o.copy_(torch.where(take[:, None], o_n, lv.o))
    lv.d.copy_(torch.where(take[:, None], d_n, lv.d))
    lv.t.copy_(torch.where(take, t_n, lv.t))
    lv.alive.copy_(lv.alive | take)
    lv.depth.copy_(torch.where(take, torch.zeros_like(lv.depth), lv.depth))
    lv.start.copy_(torch.where(take, (rank << 3) | 4,
                               torch.zeros_like(rank)))
    n_take = take.sum()
    base[s] = cursor
    lv.cnt[s + 1] = torch.stack([lv.alive.sum(), torch.zeros_like(n_take),
                                 cursor + n_take, n_take])


def record_ref(lv: MeshLevel, rec, E, W, cf, new_o, new_d, alive_out, *,
               max_depth: int):
    """Plain version of `record` (its arguments): the window's tensor
    code, the level read back from the device."""
    s = int(lv.lvl[0]) - 1
    if not 0 <= s < rec[0].shape[0]:
        return
    alive = lv.alive
    dead = ~alive
    E = torch.where(dead[:, None], 0.0, E)
    W = torch.where(dead[:, None], 0.0, W)
    # depth cap (camera.go:293-296): a path gets max_depth + 1 levels
    alive_out = alive_out & (lv.depth < max_depth)
    lv.depth.copy_(torch.where(alive, lv.depth + 1, lv.depth))
    # merged V/FL records (E and W are disjoint: lights and background
    # terminate, scatterers do not emit)
    emit = (E != 0.0).any(dim=-1)
    V = torch.where(emit[:, None], E, W)
    for c in range(3):
        rec[c][s] = V[:, c]
    rec[3][s] = (cf & alive).to(torch.int32) \
        | (emit.to(torch.int32) << 1) | lv.start
    lv.cnt[s + 1, ALIVE_AFTER] = alive_out.sum()
    lv.o.copy_(new_o)
    lv.d.copy_(new_d)
    lv.alive.copy_(alive_out)


# Mirror of `MeshLevelArgs` in csrc/mesh_level.cu (field for field).
_Args = type("_MeshLevelArgs", (ctypes.Structure,), {"_fields_": [
    (name, ctypes.c_void_p) for name in (
        "o", "d", "t", "alive", "depth", "u_cam", "cam", "start", "cnt",
        "lvl", "dcnt", "base", "E", "W", "cf", "alive_out", "new_o",
        "new_d", "vr", "vg", "vb", "fl")] + [
    (name, ctypes.c_int) for name in (
        "n", "rows", "item_end", "refill", "cadence", "width", "npix",
        "sqrt_spp", "max_depth")]})


def _check(checks, dev):
    for name, t, dt, shape in checks:
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}, expected "
                f"a contiguous {dt} {shape} on {dev}")


def _lanes_args(lv: MeshLevel, rows: int):
    """The struct with the lane state's pointers, after checking it."""
    n = lv.o.shape[0]
    f32, i32 = torch.float32, torch.int32
    if n % BLOCK:
        raise ValueError(f"lane count {n} is not a multiple of {BLOCK}")
    dev = lv.o.device
    _check([("o", lv.o, f32, (n, 3)), ("d", lv.d, f32, (n, 3)),
            ("t", lv.t, f32, (n,)), ("alive", lv.alive, torch.bool, (n,)),
            ("depth", lv.depth, i32, (n,)),
            ("u_cam", lv.u_cam, f32, (n, camera_mod.N_U_RAYGEN)),
            ("start", lv.start, i32, (n,)),
            ("cnt", lv.cnt, i32, (rows + 1, CNT_COLS)),
            ("lvl", lv.lvl, i32, (1,)), ("dcnt", lv.dcnt, i32, (n // BLOCK,))],
           dev)
    p = lambda x: x.data_ptr()
    return _Args(o=p(lv.o), d=p(lv.d), t=p(lv.t), alive=p(lv.alive),
                 depth=p(lv.depth), u_cam=p(lv.u_cam), start=p(lv.start),
                 cnt=p(lv.cnt), lvl=p(lv.lvl), dcnt=p(lv.dcnt), n=n,
                 rows=rows), dev


def _launch(entry: str, a, dev):
    err = getattr(_cuda.library("mesh_level"), entry)(
        ctypes.addressof(a), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{entry} launch failed: "
                           f"{_cuda.error_string(err)}")


def refill(lv: MeshLevel, arrays, cam, base, *, item_end: int, refill: int,
           cadence: int, width: int, npix: int, sqrt_spp: int):
    """Level s = the counter's value (which it then advances): the dead
    lanes of `lv` take items from the cursor in row s of `lv.cnt` on while
    they are below `item_end` and the level refills (s < `refill`, s a
    multiple of `cadence`), start on camera rays from `lv.u_cam`
    (`render/camera.generate_rays` on `arrays`; `cam`, `pack_camera`'s
    row, on the card) with depth 0, and `lv.start` marks them. Writes
    `base[s]` (the level's first item) and row s + 1 of `lv.cnt`. CUDA
    tensors launch csrc/mesh_level.cu; CPU tensors run `refill_ref`."""
    kw = dict(item_end=item_end, refill=refill, cadence=cadence, width=width,
              npix=npix, sqrt_spp=sqrt_spp)
    if not lv.o.is_cuda:
        return refill_ref(lv, arrays, cam, base, **kw)
    rows = lv.cnt.shape[0] - 1
    a, dev = _lanes_args(lv, rows)
    _check([("cam", cam, torch.float32, (CAM_COLS,)),
            ("base", base, torch.int32, (rows,))], dev)
    a.cam, a.base = cam.data_ptr(), base.data_ptr()
    for k, v in kw.items():
        setattr(a, k, v)
    _launch("grt_mesh_refill", a, dev)
    _cuda.count(globals(), "launches_refill")


def record(lv: MeshLevel, rec, E, W, cf, new_o, new_d, alive_out, *,
           max_depth: int):
    """Level s = the counter's value less one, after its bounce (E, W
    (N, 3) float32, cf (N,) bool, new_o, new_d (N, 3) float32, alive' (N,)
    bool): a dead lane's E and W zeroed, the depth cap, the merged V planes
    and the flag word (bit 0 clamp, bit 1 emit, `lv.start` in bits 2..)
    into row s of `rec` (Vr, Vg, Vb float32, FL int32, each (rows, N)),
    the lane state moved on to the bounce's outputs, the lanes alive after
    the cap into row s + 1 of `lv.cnt`. CUDA tensors launch
    csrc/mesh_level.cu; CPU tensors run `record_ref`."""
    if not lv.o.is_cuda:
        return record_ref(lv, rec, E, W, cf, new_o, new_d, alive_out,
                          max_depth=max_depth)
    rows = rec[0].shape[0]
    n = lv.o.shape[0]
    E, W, new_o, new_d = (x.contiguous() for x in (E, W, new_o, new_d))
    a, dev = _lanes_args(lv, rows)
    f32 = torch.float32
    _check([("E", E, f32, (n, 3)), ("W", W, f32, (n, 3)),
            ("cf", cf, torch.bool, (n,)),
            ("alive_out", alive_out, torch.bool, (n,)),
            ("new_o", new_o, f32, (n, 3)), ("new_d", new_d, f32, (n, 3))]
           + [(nm, r, dt, (rows, n)) for nm, r, dt in zip(
               ("Vr", "Vg", "Vb", "FL"), rec, (f32, f32, f32, torch.int32))],
           dev)
    p = lambda x: x.data_ptr()
    a.E, a.W, a.cf, a.alive_out = p(E), p(W), p(cf), p(alive_out)
    a.new_o, a.new_d = p(new_o), p(new_d)
    a.vr, a.vg, a.vb, a.fl = (p(r) for r in rec)
    a.max_depth = max_depth
    _launch("grt_mesh_record", a, dev)
    _cuda.count(globals(), "launches_record")


# the entry points as this module defines them
_ENTRIES = (refill, record)


def kernel_glue() -> bool:
    """Whether `refill` and `record` are this module's own entries (the
    kernel on CUDA tensors) and not plain versions swapped in for them,
    which read the host and so cannot be captured in a CUDA graph."""
    return (refill, record) == _ENTRIES
