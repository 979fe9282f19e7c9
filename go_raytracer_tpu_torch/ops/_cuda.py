"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source has a plain C interface and no PyTorch headers, so `nvcc`
compiles it in seconds into a shared library of its own, loaded with
ctypes. All sources build at once (one `nvcc` each, started together) at
first use, into `build/torch_kernels/` at the repository root, named by a
hash of the source, the headers and the flags so an edited kernel
rebuilds. The compiler's
register and spill report (`-Xptxas -v`) is kept beside each library as
`<name>-<hash>.log`.

Only `library()` builds; importing this module does nothing, so the CPU
tests import every module without a CUDA toolkit.

Every wrapper counts its kernel's launches through `count`, which also
serves CUDA graphs (`Graph`): a launch captured into a graph runs at each
replay, and is counted there. `DrainWatch` lets a host loop of levels
learn, without waiting on the device, that its work has drained.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import time

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "torch_kernels")
SOURCES = ("bounce_fused_q", "harvest", "bounce", "stream", "traverse8",
           "bounce_fused", "bounce_fused_pos", "harvest_rows", "traverse",
           "stream_round", "stream2", "mesh_level")
# entry point of each library, all `int fn(const Args*, cudaStream_t)`
ENTRY = {"bounce_fused_q": "grt_bounce_fused_q",
         "harvest": "grt_harvest_levels", "bounce": "grt_bounce",
         "stream": "grt_stream_rows", "traverse8": "grt_bvh8_closest",
         "bounce_fused": "grt_bounce_fused",
         "bounce_fused_pos": "grt_bounce_fused_pos",
         "harvest_rows": "grt_harvest_rows", "traverse": "grt_bvh_closest",
         "stream_round": "grt_stream_round_rows",
         "stream2": "grt_stream2_rows", "mesh_level": "grt_mesh_refill"}
# further entry points of a library, with the same signature
MORE_ENTRIES = {"bounce_fused_q": ("grt_bounce_fused_q_direct",),
                "bounce": ("grt_bounce_cap",),
                "harvest_rows": ("grt_harvest_rows_perm",),
                "mesh_level": ("grt_mesh_record",)}
# libraries whose kernels run the bounce core's staged scan; each exports
# `int grt_kernel_info(feat, n_sph, n_quad, n_box, int* out)`
STAGED = ("bounce_fused_q", "bounce_fused", "bounce_fused_pos", "bounce")
# The mesh intersectors must agree with their plain versions bit for bit,
# so their multiply-adds stay uncontracted (csrc/mt.cuh).
EXTRA_FLAGS = {name: ["-fmad=false"] for name in (
    "stream", "traverse8", "traverse", "stream_round", "stream2")}
FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]

_libs = {}
build_seconds = None   # wall time of the last build_all() that compiled
_noting = None         # the counts of the Graph being captured


def count(where: dict, name: str):
    """One launch of a kernel, or one call of a route, into the counter
    `where[name]` (a wrapper module's `globals()` or a counters dict):
    added now, or, while a `Graph` captures the launch, at each replay."""
    if _noting is not None:
        _noting.append((where, name))
    else:
        where[name] = where.get(name, 0) + 1


class Graph:
    """A CUDA graph of wrapper launches whose every replay counts them:
    `capture(fn)` records fn()'s launches on a side stream (counted by
    `count` into `noted`, not run), `replay()` runs them on the current
    stream and adds `noted` to the counters. A capture that fails
    raises."""

    def __init__(self):
        import torch
        self.graph = torch.cuda.CUDAGraph()
        self.noted = []

    def capture(self, fn):
        # on a side stream that waits for the current one, as
        # torch.cuda.graph does, but without its synchronize and cache
        # flushes (a render captures a graph per scene: those would cost
        # a wait and fresh allocations each time)
        import torch
        global _noting
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        _noting = self.noted
        try:
            with torch.cuda.stream(side):
                self.graph.capture_begin(capture_error_mode="relaxed")
                try:
                    fn()
                finally:
                    self.graph.capture_end()
        finally:
            _noting = None
        main.wait_stream(side)

    def replay(self):
        self.graph.replay()
        for where, name in self.noted:
            where[name] = where.get(name, 0) + 1


class StepGraph:
    """A step (`body()`, which reads and writes only tensors that live
    from one step to the next) run as one CUDA graph: the first call runs
    body eagerly on a side stream (the warm-up: it loads every kernel and
    makes what body allocates for good, an optimizer's state and the
    gradients), the second captures it (`Graph`; autograd's backward and
    an optimizer step capture with it, so long as the gradients already
    exist and body zeroes them in place) and replays it, as does every
    later call. Each call returns what body returned at the capture, or
    at this call when eager: tensors that every replay rewrites. With
    `graph` False every call runs body eagerly on the current stream. A
    capture that fails raises."""

    def __init__(self, body, graph: bool, device=None):
        self.body, self.on, self.device = body, graph, device
        self.calls, self.graph, self.out = 0, None, None

    def __call__(self):
        import torch
        self.calls += 1
        if not self.on:
            return self.body()
        if self.calls == 1:
            main = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                out = self.body()
            main.wait_stream(side)
            return out
        if self.graph is None:
            graph = Graph()
            graph.capture(lambda: setattr(self, "out", self.body()))
            self.graph = graph
        self.graph.replay()
        return self.out


class DrainWatch:
    """Early drain exit of a loop of levels (or kernel calls). `rows`
    ((calls, k) int32, on the render device) holds each call's counts once
    the call has run, and `done(row, i)` tells from call i's row (a list
    of k ints) that the work drained. On the CPU the row is read directly;
    on the GPU it is copied to pinned memory behind the call and read once
    its event has completed, so the host never waits, and how many calls
    run past the drained one follows the host's pace. Those calls must
    change nothing: the loop's counts come from the device, not from the
    number of calls. With `ahead`, at most that many calls stay in
    flight: past it, `drained` polls the oldest call's event (never a
    synchronizing call) until it completes, so the host does not run more
    than `ahead` calls past a drain; `wait_ns` sums the host's time in
    those polls (ns on `time.perf_counter_ns`)."""

    def __init__(self, rows, done=lambda row, i: row[0] == 0, ahead=None):
        import torch
        self.rows, self.done, self.ahead = rows, done, ahead
        self.cuda = rows.is_cuda
        if self.cuda:
            self.host = torch.empty(tuple(rows.shape), dtype=torch.int32,
                                    pin_memory=True)
            self.pending = collections.deque()
        self.last = -1
        self.wait_ns = 0

    def record(self, i: int):
        import torch
        self.last = i
        if self.cuda:
            self.host[i].copy_(self.rows[i], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            self.pending.append((i, ev))

    def drained(self) -> bool:
        if not self.cuda:
            return bool(self.done(self.rows[self.last].tolist(), self.last))
        while self.pending and (self.pending[0][1].query() or (
                self.ahead is not None and len(self.pending) > self.ahead)):
            i, ev = self.pending.popleft()
            if not ev.query():
                t0 = time.perf_counter_ns()
                while not ev.query():
                    pass
                self.wait_ns += time.perf_counter_ns() - t0
            if self.done(self.host[i].tolist(), i):
                return True
        return False


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if not home:
        try:
            from torch.utils.cpp_extension import CUDA_HOME as home
        except ImportError:
            home = None
    cands = ([os.path.join(home, "bin", "nvcc")] if home else []) \
        + [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _flags(name: str) -> list:
    return FLAGS + EXTRA_FLAGS.get(name, [])


def _target(name: str) -> str:
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    for path in [os.path.join(_CSRC, name + ".cu")] \
            + sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))):
        with open(path, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_all() -> dict:
    """Compile every source whose library is missing, all in parallel.
    Returns {name: library path}; raises with the compiler's output if a
    build fails."""
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = {name: _target(name) for name in SOURCES}
    procs = {}
    t0 = time.perf_counter()
    for name, so in todo.items():
        if os.path.exists(so):
            continue
        tmp = so + f".{os.getpid()}.tmp"
        log = open(so[:-3] + ".log", "w")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *_flags(name), "-o", tmp,
             os.path.join(_CSRC, name + ".cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, so, log)
    failed = []
    for name, (proc, tmp, so, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, so)
        else:
            with open(so[:-3] + ".log") as fh:
                failed.append(f"{name} (nvcc exit {rc}):\n{fh.read()}")
    if procs:
        build_seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return todo


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all()[name]
        lib = ctypes.CDLL(path)
        for entry in (ENTRY[name],) + MORE_ENTRIES.get(name, ()):
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.grt_error_string.argtypes = [ctypes.c_int]
        lib.grt_error_string.restype = ctypes.c_char_p
        if name in STAGED:
            lib.grt_kernel_info.argtypes = [ctypes.c_int] * 4 \
                + [ctypes.c_void_p]
            lib.grt_kernel_info.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def kernel_info(name: str, feat: int, n_sph: int, n_quad: int,
                n_box: int) -> dict:
    """What the card says of the staged-scan kernel of csrc/<name>.cu (one
    of STAGED) in the variant of feature bits `feat`, on a primitive table
    of these section sizes: registers, the staged geometry's dynamic
    shared bytes, static shared bytes, resident blocks per SM at the
    kernels' 256 threads, and spill (local) bytes per thread."""
    out = (ctypes.c_int * 5)()
    lib = library(name)
    err = lib.grt_kernel_info(feat, n_sph, n_quad, n_box, out)
    if err:
        raise RuntimeError(f"{name} kernel info: {error_string(err)}")
    return dict(zip(("registers", "dynamic_smem", "static_smem",
                     "blocks_per_sm", "local_bytes"), out))


def ptxas_report(name: str) -> list:
    """One line per kernel of csrc/<name>.cu from its build log: the entry
    function (its template arguments, if any), registers, static shared
    memory and spill stores, as `-Xptxas -v` reported them. Empty before
    the build."""
    log = _target(name)[:-3] + ".log"
    if not os.path.exists(log):
        return []
    out, func, spill = [], None, ""
    with open(log) as fh:
        for line in fh:
            m = re.search(r"Compiling entry function '_Z(\d+)(\w+)'", line)
            if m:
                k = int(m.group(1))
                targs = re.match(r"I((?:L[ib]\d+E)+)E", m.group(2)[k:])
                func = m.group(2)[:k] + (
                    "<" + ",".join(re.findall(r"L[ib](\d+)E", targs.group(1)))
                    + ">" if targs else "")
                continue
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spill = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and func:
                smem = re.search(r"(\d+) bytes smem", line)
                out.append(f"{func}: {m.group(1)} registers, "
                           f"{smem.group(1) if smem else 0} bytes static "
                           f"smem, {spill or '0'} bytes spill stores")
                func, spill = None, ""
    return out


def error_string(err: int) -> str:
    lib = next(iter(_libs.values()))
    return f"{lib.grt_error_string(err).decode()} (cudaError {err})"
