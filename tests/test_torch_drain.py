"""The early drain exit of the `queue_ik` window (integrator/regen.py):
what a window reports must not depend on when the host notices the drain.

On the card the loop polls an event without waiting, so it may run a few
calls past the first drained one. Those calls trace nothing, and the
window's cursor, segments and recorded levels (`cur`) and its accumulator
must come out as if the drain had been seen at once. Here the watch is
made to see it two calls late."""

import numpy as np
import pytest
import torch

from go_raytracer_tpu_torch.integrator import regen
from go_raytracer_tpu_torch.ops import bounce as tpb
from go_raytracer_tpu_torch.scenes import registry as treg

torch.set_num_threads(2)


def _window(late_by, direct_rec=False):
    """One cornellBox window (16 px, 4 spp, depth 8, 512 lanes, cadence 2,
    refill 40: the queue empties and the lanes die well before the window's
    25 calls end). Returns (cur, acc, calls run)."""
    scene, cam = treg.cornell_box()
    cam.width, cam.samples_per_pixel, cam.max_depth = 16, 4, 8
    n, cadence, refill = 512, 2, 40
    window = -(-(refill + cam.max_depth + 1) // cadence) * cadence
    total = 16 * 16 * 4
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    tables = tuple(to(t) for t in tpb.pack_scene(scene))
    bufs = regen.WindowBuffers.empty(n, window // cadence, cadence, "cpu")
    for r in bufs.rec:
        r.zero_()
    acc = torch.zeros((total + n, 3))
    orig = regen._DrainWatch.drained
    seen = {}

    def late(self):
        if "at" not in seen and orig(self):
            seen["at"] = self.last
        return "at" in seen and self.last >= seen["at"] + late_by

    calls = []
    real = tpb.bounce_fused_q_direct if direct_rec else tpb.bounce_fused_q

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(regen._DrainWatch, "drained", late)
    mp.setattr(tpb, "bounce_fused_q_direct" if direct_rec
               else "bounce_fused_q", counted)
    try:
        _, _, cur = regen._window_impl(
            tables, tpb.scene_statics(scene),
            to(tpb.pack_camera(cam.derived())),
            to(np.asarray(scene.background, np.float32)), acc,
            regen._init_state(n, "cpu"), torch.zeros(1, dtype=torch.int32),
            regen.window_seeds(3, 0, window // cadence), 0, total,
            width=16, npix=256, sqrt_spp=2, window=window, refill=refill,
            cadence=cadence, max_depth=cam.max_depth,
            max_contribution=cam.max_contribution, bufs=bufs,
            direct_rec=direct_rec)
    finally:
        mp.undo()
    return cur, acc, len(calls), window // cadence


@pytest.mark.parametrize("direct_rec", [False, True])
def test_late_drain_reports_the_same_window(direct_rec):
    cur0, acc0, calls0, outer = _window(0, direct_rec)
    cur2, acc2, calls2, _ = _window(2, direct_rec)
    # the late watch really ran two surplus calls, inside the window
    assert calls2 == calls0 + 2 <= outer
    assert int(cur0[0]) == 16 * 16 * 4
    assert torch.equal(cur0, cur2)
    assert int(cur0[2]) == calls0 * 2
    assert torch.equal(acc0, acc2)
