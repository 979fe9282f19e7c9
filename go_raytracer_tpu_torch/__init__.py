"""go_raytracer_tpu_torch — the path tracer in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package `go_raytracer_tpu`, which stays the reference:
this package imports neither JAX nor it. Module names follow the JAX
package's layout. Entry points run on the GPU unless the caller asks for
the CPU (`device="cpu"`, CLI `--cpu`), which runs each kernel's plain
PyTorch version. Ported so far: the host scene compiler, the regen
integrator's in-kernel-queue path with its two kernels (`ops/bounce.py`,
`ops/harvest.py`), checkpoints and the CLI; ROADMAP.md lists the rest.
"""

__version__ = "0.1.0"
