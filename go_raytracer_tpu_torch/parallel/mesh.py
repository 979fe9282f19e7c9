"""Device meshes, sharded rendering, scene parameters for inverse
rendering and a differentiable training step, on one device or sharded
over the ranks of a `torch.distributed` group: the JAX package's
`parallel/mesh.py`.

The gradient is autograd over the reference engine
(`integrator/wavefront.radiance`, mode "scan", backend "xla"), which
stands in for `jax.grad`; `torch.optim.Adam` stands in for optax's
`adam` (the same update: beta 0.9/0.999, eps 1e-8 added after the square
root, bias-corrected moments).

On the card the backward of a table gather (a texture's colour, a
material's fuzz) is a scatter-add whose atomic order varies, so two runs'
gradients may differ in the last bits; on the CPU they are equal.

Sharding. A mesh is a `DeviceMesh` over every rank of the default group
(`parallel/distributed.initialize`): "data" shards rays (pixels),
"sample" shards sample batches. JAX's threefry splits a key the same way
however the rays are sharded; a `torch.Generator` per rank would not. So
the sharded paths draw `KeyedUniforms`: each number is a hash of (seed,
stream, the ray's global position, its slot), and a rank computes only
its own rays' numbers, whatever the rank count.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import types as _pytypes
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from go_raytracer_tpu_torch.core import rng
from go_raytracer_tpu_torch.integrator import regen as regen_mod
from go_raytracer_tpu_torch.integrator import wavefront
from go_raytracer_tpu_torch.ops import _cuda
from go_raytracer_tpu_torch.ops import trace as trace_mod
from go_raytracer_tpu_torch.render import camera as camera_mod
from go_raytracer_tpu_torch.scene import types as T
from go_raytracer_tpu_torch.utils import spans


def mesh_shape(n: int, axes: Tuple[str, ...] = ("data", "sample")):
    """The shape of the JAX package's `make_mesh(n, axes)`: (n,) for one
    axis; for two, the most-square factorisation (n // d, d), d the
    largest divisor of n not above sqrt(n)."""
    if n < 1:
        raise ValueError(f"a mesh needs at least one rank, not {n}")
    if len(axes) == 1:
        return (n,)
    if len(axes) != 2:
        raise ValueError(f"a mesh has one or two axes, not {axes}")
    d = max(k for k in range(1, math.isqrt(n) + 1) if n % k == 0)
    return (n // d, d)


def make_mesh(n_devices: Optional[int] = None,
              axes: Tuple[str, ...] = ("data", "sample")):
    """A `torch.distributed.device_mesh.DeviceMesh` of shape
    `mesh_shape(n, axes)` named `axes` over the ranks of the default group
    (`parallel/distributed.initialize` forms it): on CUDA under NCCL, on
    the CPU under gloo. rank r sits at r's row-major coordinate.
    `init_device_mesh` spans the whole group, so n (default: the world
    size) must equal the world size: a smaller or larger n raises
    ValueError, as does a call without a group (RuntimeError)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "parallel.distributed.initialize() first")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a group of {world}: the "
                         "mesh spans every rank of the group")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, mesh_shape(n, axes),
                            mesh_dim_names=tuple(axes))


def host_key(seed: int) -> int:
    """A seed of this rank's own (JAX: `fold_in(key, process_index)`):
    `seed` with the rank folded in, rank 0 without a group."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    return (seed * 0x9E3779B97F4A7C15 + rank + 1) & ((1 << 63) - 1)


@dataclasses.dataclass
class KeyedUniforms:
    """Uniforms keyed by global position. Stream `stream` of `seed` (a
    stratum of `render_sharded`, a step of the train step) gives the ray
    at global position p, slot k, the number `rng.keyed_u01(p * slots +
    k, key(seed, stream))`: the camera's `camera_mod.N_U_RAYGEN` slots
    first, then each level's n_u. A rank that holds some rays computes
    exactly their numbers, so an image or a gradient does not depend on
    how the rays are split over ranks. The train step moves `stream` on
    by one a step."""

    seed: int = 0
    stream: int = 0

    def key(self) -> int:
        s = self.seed & ((1 << 64) - 1)
        return rng.mix32(rng.mix32((s ^ (s >> 32)) & rng.M32)
                         ^ (self.stream & rng.M32))

    def rays(self, pos, n_u: int, levels: int) -> "RayUniforms":
        """The numbers of the rays at global positions `pos` (an int64
        tensor (n,)), for `levels` levels of n_u uniforms."""
        slots = camera_mod.N_U_RAYGEN + levels * n_u
        return RayUniforms(self.key(), pos.to(torch.int64) * slots, n_u)


class RayUniforms:
    """Some rays' keyed numbers (`KeyedUniforms.rays`): `camera()` the (n,
    N_U_RAYGEN) camera uniforms, `[s]` level s's (n, n_u), each computed
    when asked for, so a render holds one level's numbers at a time
    (`wavefront.radiance(uniforms=...)` reads them by level)."""

    def __init__(self, key: int, base, n_u: int):
        self.key, self.base, self.n_u = key, base, n_u

    def _slots(self, first: int, count: int):
        k = torch.arange(first, first + count, dtype=torch.int64,
                         device=self.base.device)
        return rng.keyed_u01(self.base[:, None] + k[None, :], self.key)

    def camera(self):
        return self._slots(0, camera_mod.N_U_RAYGEN)

    def __getitem__(self, s: int):
        return self._slots(camera_mod.N_U_RAYGEN + s * self.n_u, self.n_u)


def _mesh_place(mesh, device):
    """(device, rank index, rank count) of this rank in a mesh over every
    rank of the default group; the device is checked against the mesh's
    device type."""
    device = regen_mod.resolve_device(device)
    if device.type != mesh.device_type:
        raise ValueError(f"the mesh's ranks run on {mesh.device_type}, the "
                         f"render on {device}")
    if mesh.size() != dist.get_world_size():
        raise ValueError("the mesh must span every rank of the group")
    coord = mesh.get_coordinate()
    index = int(np.ravel_multi_index(tuple(coord), tuple(mesh.shape)))
    return device, index, mesh.size()


def render_sharded(scene: T.Scene, cam: camera_mod.Camera, mesh,
                   seed: int = 0, mode: str = "while", device=None):
    """The whole image through the reference engine, its rays sharded over
    every rank of `mesh` (JAX's `render_sharded`): the pixel ids, padded
    to a multiple of the rank count, are split into equal runs in rank
    order, and each stratum is one `wavefront.radiance` call (backend
    "xla", `mode`) over the rank's run. Uniforms are `KeyedUniforms(seed,
    stratum)` at the pixel id, so the image does not depend on the rank
    count. Every rank of the mesh calls it; each gets the image (H, W, 3)
    float32 numpy and {"segments": traced segments over every ray of
    every rank, the padding's included; "graph": False, its levels run
    eagerly}."""
    device, index, count = _mesh_place(mesh, device)
    ds = trace_mod.to_device(scene, device)
    arrays = cam.derived()
    h, w = cam.image_height, cam.width
    npix = h * w
    per = -(-npix // count)
    ids = torch.arange(index * per, (index + 1) * per, device=device)
    sqrt_spp = cam.spp_sqrt
    n_u = wavefront.N_FIXED_U + ds.media.kind.shape[0]
    acc = torch.zeros((per, 3), dtype=torch.float32, device=device)
    seg = torch.zeros((1,), dtype=torch.int64, device=device)
    with torch.no_grad():
        for s_i in range(sqrt_spp):
            for s_j in range(sqrt_spp):
                u = KeyedUniforms(seed, s_i * sqrt_spp + s_j).rays(
                    ids, n_u, cam.max_depth + 1)
                o, d, t = camera_mod.generate_rays(
                    arrays, w, ids,
                    torch.tensor(float(s_i), device=device),
                    torch.tensor(float(s_j), device=device), u.camera())
                L, st = wavefront.radiance(ds, o, d, t, None, cam.max_depth,
                                           cam.max_contribution, mode=mode,
                                           uniforms=u, graph=False)
                acc += L
                seg += st["segments"]
    img = regen_mod.Shard(index, count).gather(acc).reshape(-1, 3)[:npix] \
        .reshape(h, w, 3) / (sqrt_spp * sqrt_spp)
    dist.all_reduce(seg)
    return img.cpu().numpy(), {"segments": int(seg), "graph": False}


def extract_params(ds) -> dict:
    """Differentiable scene parameters of a device scene
    (`ops/trace.to_device`): texture colours (albedos and emission), the
    checker's even and odd colours, metal fuzz, dielectric index, medium
    density (as -1/density) and the background, under the JAX package's
    leaf names. The tensors are ds's own, on its device."""
    return trace_mod.param_tensors(ds)


def params_from_numpy(d) -> dict:
    """Parameters given as numpy arrays (e.g. `{k: np.asarray(v) for k, v
    in jax_params.items()}`) as float32 CPU tensors, copies."""
    unknown = set(d) - set(trace_mod.PARAMS)
    if unknown:
        raise ValueError(f"unknown parameter leaves {sorted(unknown)}")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in d.items()}


def apply_params(ds, params) -> _pytypes.SimpleNamespace:
    """A new device scene carrying `params` (a dict of some or all of
    `extract_params`' leaves, each of the same shape, on ds's device).
    Its textures, materials and media are shallow copies holding the
    given tensors, which keep their autograd graph; ds itself, and any K3
    launch prepared on it, stay as they were. The new scene's K3 launch
    is packed from its own tensors when it is first asked for
    (`integrator/wavefront.kernel_launch`)."""
    old = trace_mod.param_tensors(ds)
    for k, v in params.items():
        if k not in old:
            raise ValueError(f"unknown parameter leaf {k!r}")
        if tuple(v.shape) != tuple(old[k].shape) or v.device != old[k].device:
            raise ValueError(
                f"{k}: shape {tuple(v.shape)} on {v.device}, the scene's is "
                f"{tuple(old[k].shape)} on {old[k].device}")
    out = copy.copy(ds)
    for tab in {tab for k, (tab, _) in trace_mod.PARAMS.items()
                if tab is not None and k in params}:
        setattr(out, tab, copy.copy(getattr(ds, tab)))
    for k, v in params.items():
        tab, f = trace_mod.PARAMS[k]
        setattr(out if tab is None else getattr(out, tab), f, v)
    out.k3 = None
    return out


def render_batches(ds, arrays, width: int, ids, max_depth: int,
                   max_contribution: float, generator, pos=None,
                   uniforms=None):
    """The mean over batches of the radiance of camera rays at stratum
    (0, 0), JAX's `loss_fn` render: ids (S, N) pixel ids. The S batches
    go through one `radiance` call of S * N rays (JAX vmaps them). With a
    `torch.Generator` (on ds's device) the camera uniforms are drawn
    first, then the path uniforms; with `KeyedUniforms` the ray of batch
    b, column c takes the numbers of global position pos[b, c] (default
    b * N + c); `uniforms` = (camera (S * N, N_U_RAYGEN), levels (max_depth
    + 1, S * N, n_u)), drawn by the caller (`StepUniforms`), takes the
    generator's place. Returns (image (N, 3), forward segments, a 0-d
    tensor)."""
    s, n = ids.shape
    flat = ids.reshape(-1)
    if uniforms is not None:
        u, uniforms = uniforms
        generator = None
    elif isinstance(generator, KeyedUniforms):
        if pos is None:
            pos = torch.arange(s * n, device=flat.device)
        uniforms = generator.rays(
            pos.reshape(-1), wavefront.N_FIXED_U + ds.media.kind.shape[0],
            max_depth + 1)
        u, generator = uniforms.camera(), None
    else:
        u = torch.rand((s * n, camera_mod.N_U_RAYGEN), generator=generator,
                       device=flat.device)
    zero = torch.zeros((), device=flat.device)
    o, d, t = camera_mod.generate_rays(arrays, width, flat, zero, zero, u)
    L, st = wavefront.radiance(ds, o, d, t, generator, max_depth,
                               max_contribution, mode="scan",
                               uniforms=uniforms)
    return L.reshape(s, n, 3).mean(dim=0), st["segments"]


@dataclasses.dataclass
class StepUniforms:
    """A train step's uniforms on fixed buffers: `camera` (rays,
    N_U_RAYGEN) and `levels` (levels, rays, n_u). `draw` fills them in the
    order `render_batches` draws them from a torch.Generator (the camera's,
    then each level's: the same numbers as `torch.rand` of those shapes),
    or copies a `KeyedUniforms` stream's numbers of rays 0 .. rays - 1, so
    that a captured step reads new numbers at every replay."""

    camera: torch.Tensor
    levels: torch.Tensor

    @staticmethod
    def empty(rays: int, levels: int, n_u: int, device) -> "StepUniforms":
        return StepUniforms(
            torch.empty((rays, camera_mod.N_U_RAYGEN), device=device),
            torch.empty((levels, rays, n_u), device=device))

    def draw(self, generator):
        if isinstance(generator, KeyedUniforms):
            levels, rays, n_u = self.levels.shape
            keyed = generator.rays(
                torch.arange(rays, device=self.levels.device), n_u, levels)
            self.camera.copy_(keyed.camera())
            for s in range(levels):
                self.levels[s].copy_(keyed[s])
            return
        self.camera.uniform_(generator=generator)
        for s in range(self.levels.shape[0]):
            self.levels[s].uniform_(generator=generator)


class _SumOver(torch.autograd.Function):
    """The sum of a tensor over the ranks of a group, whose backward is
    the sum of the incoming gradients over the same ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def make_train_step(scene: T.Scene, cam: camera_mod.Camera, n_rays: int,
                    n_sample_batches: int, max_depth: int,
                    learning_rate: float = 1e-2, device=None,
                    generator=None, mesh=None, graph=None):
    """Differentiable render + MSE loss + Adam update, on one device (CUDA
    unless `device` says otherwise) or sharded over a ("data", "sample")
    mesh (`make_mesh`).

    Returns (train_step, params, optimizer): params are `extract_params`'
    leaves as fresh tensors that require a gradient, optimizer a
    `torch.optim.Adam(lr=learning_rate)` over them (`capturable` on the
    card), and `train_step(params, ids, target)` renders
    `n_sample_batches` batches of `n_rays` camera rays (ids
    (n_sample_batches, n_rays) pixel ids; `pixel_ids(n_rays,
    n_sample_batches, device)` gives JAX's), takes the MSE of their mean
    against target (n_rays, 3), updates params in place and returns the
    loss as a float, its one host read. Every leaf gets a gradient, zero
    where the render does not read it, as under optax. Uniforms come from
    `generator`: a torch.Generator on the device (seed 0 when None and no
    mesh), or `KeyedUniforms`, whose stream moves on by one a step.

    On one device the step draws its uniforms into fixed buffers
    (`StepUniforms`) and copies ids and target into its own, then runs
    the render, the MSE, the backward and Adam on them. `graph` (None:
    on the card without a mesh) makes that one CUDA graph: the first step
    runs eagerly on a side stream (it warms every kernel and makes every
    gradient and Adam's state), the second is captured and every step
    from then on replays it (`ops/_cuda.StepGraph`); the step then takes
    only the params it returned. The gradients are zeroed in place before each
    backward, so the captured step keeps their addresses. A capture that
    fails raises; True raises ValueError off the card or on a mesh. Each
    call is the root span "train.step" (`utils/spans.py`), with
    "train.inputs" (ids, target and uniforms into the buffers),
    "train.launch" (the replay, or the eager body) and "train.loss_read"
    in it; on the card its counts `forward_ms` (the gradients zeroed, the
    render and the loss), `backward_ms` (the backward) and `adam_ms` (the
    update) are the device's times of the step's phases, from timing
    events that the graph records.

    On a mesh (its device type the device's), every rank calls the step
    with the same ids and target and renders its block: batches
    [i_s * S_r, (i_s + 1) * S_r) and rays [i_d * N_r, (i_d + 1) * N_r),
    S_r = S / n_sample, N_r = N / n_data, (i_d, i_s) its coordinate. The
    uniforms must be keyed (`KeyedUniforms(0)` when None), so the step's
    loss and gradient are the one-device step's on the same
    `KeyedUniforms`. The loss is not linear in the batch mean, so the
    rank's batch sum goes through a sum over the "sample" ranks that
    autograd differentiates, the loss of the rank's pixels is summed over
    the "data" ranks, and after the backward each leaf's gradient is
    summed over every rank before Adam, which then makes the same update
    on every rank. That step runs eagerly."""
    device = regen_mod.resolve_device(device)
    ds = trace_mod.to_device(scene, device)
    arrays = cam.derived().to(device)
    w = cam.width
    if graph is None:
        graph = device.type == "cuda" and mesh is None
    elif graph and (device.type != "cuda" or mesh is not None):
        raise ValueError("graph=True: the train step is captured only on "
                         "the card and without a mesh")
    if mesh is not None:
        if isinstance(generator, torch.Generator):
            raise ValueError("a sharded step draws KeyedUniforms (keyed by "
                             "global position), not a torch.Generator")
        if mesh.ndim != 2:
            raise ValueError("the sharded step runs on a (\"data\", "
                             "\"sample\") mesh")
        device, _, _ = _mesh_place(mesh, device)
        n_data, n_sample = mesh.shape
        if n_rays % n_data or n_sample_batches % n_sample:
            raise ValueError(
                f"{n_sample_batches} batches of {n_rays} rays do not split "
                f"over a {n_data} x {n_sample} mesh")
        i_d, i_s = mesh.get_coordinate()
        data_g, sample_g = mesh.get_group(0), mesh.get_group(1)
        s_r, n_r = n_sample_batches // n_sample, n_rays // n_data
        rows = slice(i_s * s_r, (i_s + 1) * s_r)
        cols = slice(i_d * n_r, (i_d + 1) * n_r)
        pos = (torch.arange(rows.start, rows.stop, device=device)[:, None]
               * n_rays
               + torch.arange(cols.start, cols.stop, device=device)[None])
    if generator is None:
        generator = KeyedUniforms(0) if mesh is not None else \
            torch.Generator(device=device).manual_seed(0)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in extract_params(ds).items()}
    optimizer = torch.optim.Adam(list(params.values()), lr=learning_rate,
                                 capturable=device.type == "cuda")

    def check_ids(ids):
        if tuple(ids.shape) != (n_sample_batches, n_rays):
            raise ValueError(f"ids of shape {tuple(ids.shape)}, the step "
                             f"renders ({n_sample_batches}, {n_rays})")

    def zero_missing(params):
        # a leaf the render does not read gets a zero gradient, as under
        # optax
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)

    if mesh is not None:
        def sharded_step(params, ids, target):
            check_ids(ids)
            optimizer.zero_grad(set_to_none=True)
            img, _ = render_batches(apply_params(ds, params), arrays, w,
                                    ids[rows, cols], max_depth,
                                    cam.max_contribution, generator, pos=pos)
            img = _SumOver.apply(img * s_r, sample_g) / n_sample_batches
            loss = ((img - target[cols]) ** 2).sum() / (n_rays * 3)
            # every "sample" rank of a column holds the column's loss: each
            # backs up its share so that the sum's backward counts it once
            (loss / n_sample).backward()
            loss = loss.detach().clone()
            dist.all_reduce(loss, group=data_g)
            zero_missing(params)
            for p in params.values():
                dist.all_reduce(p.grad)
            optimizer.step()
            generator.stream += 1
            return loss.item()

        return sharded_step, params, optimizer

    n_u = wavefront.N_FIXED_U + ds.media.kind.shape[0]
    uni = StepUniforms.empty(n_sample_batches * n_rays, max_depth + 1, n_u,
                             device)
    ids_buf = torch.zeros((n_sample_batches, n_rays), dtype=torch.int64,
                          device=device)
    target_buf = torch.zeros((n_rays, 3), dtype=torch.float32, device=device)
    own = dict(params)
    # on the card, timing events at the body's phase boundaries; external,
    # so that every replay of the captured step records them
    marks = [torch.cuda.Event(enable_timing=True, external=True)
             for _ in range(4)] if device.type == "cuda" else None

    def mark(i):
        if marks:
            marks[i].record()

    def body():
        mark(0)
        optimizer.zero_grad(set_to_none=False)
        img, _ = render_batches(apply_params(ds, own), arrays, w, ids_buf,
                                max_depth, cam.max_contribution, None,
                                uniforms=(uni.camera, uni.levels))
        loss = torch.mean((img - target_buf) ** 2)
        mark(1)
        loss.backward()
        zero_missing(own)
        mark(2)
        optimizer.step()
        mark(3)
        return loss.detach()

    step = _cuda.StepGraph(body, graph, device)

    def train_step(params, ids, target):
        with spans.span("train.step") as root:
            check_ids(ids)
            if graph and any(params.get(k) is not v for k, v in own.items()):
                raise ValueError("a captured train step takes the params "
                                 "that make_train_step returned")
            with spans.span("train.inputs"):
                own.update(params)
                ids_buf.copy_(ids)
                target_buf.copy_(target)
                uni.draw(generator)
                if isinstance(generator, KeyedUniforms):
                    generator.stream += 1
            with spans.span("train.launch"):
                out = step()
            with spans.span("train.loss_read"):
                loss = out.item()
            if marks:
                root.counts.update(zip(
                    ("forward_ms", "backward_ms", "adam_ms"),
                    (a.elapsed_time(b) for a, b in zip(marks, marks[1:]))))
        return loss

    return train_step, params, optimizer


def pixel_ids(n_rays: int, n_sample_batches: int, device=None):
    """JAX's ray layout for the step: ids 0 .. n_rays - 1 in every batch,
    (n_sample_batches, n_rays) int64."""
    return torch.arange(n_rays, device=device).repeat(n_sample_batches, 1)
