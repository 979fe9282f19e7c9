#!/usr/bin/env python3
"""modelExample at 4 spp through `render_regen_sharded` on a one-rank
NCCL group (a file:// rendezvous in a temporary directory), from the
checkout given as the first argument (default: this one), on a pool of
LANES lanes (default 65,536). Prints one line, `SHARDED8 {json}`: the
image's SHA-256 (16 hex digits), segments, paths, levels, whether the
mesh levels replayed as a CUDA graph, and the render loop's seconds.
Needs one CUDA GPU.

    python3 scripts/sharded_mesh_render.py [CHECKOUT [LANES]]
"""
import hashlib
import json
import os
import sys
import tempfile

repo = sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.abspath(repo))
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402
from go_raytracer_tpu_torch.integrator import regen  # noqa: E402
from go_raytracer_tpu_torch.parallel import distributed  # noqa: E402
from go_raytracer_tpu_torch.scenes import registry  # noqa: E402

d = tempfile.mkdtemp()
distributed.initialize(f"file://{d}/rdzv", 1, 0)
sc, cam = registry.model_example()
cam.samples_per_pixel = 4
lanes = int(sys.argv[2]) if len(sys.argv) > 2 else 1 << 16
img, st = regen.render_regen_sharded(sc, cam, distributed.global_render_mesh(),
                                     seed=0, n_lanes=lanes)
print("SHARDED8", json.dumps(dict(
    repo=repo, sha=hashlib.sha256(np.ascontiguousarray(img).tobytes())
    .hexdigest()[:16], segments=st["segments"], paths=st["paths"],
    lanes=lanes, levels=st.get("levels"),
    graph=st.get("mesh", {}).get("graph"),
    elapsed=st["elapsed_s"])))
dist.destroy_process_group()
