"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped, a cell at a size the CPU holds,
the program's kernels' plain versions, the cell's own limits. Each fault
that the cell can have: a state left unchanged, half of the samples or
batches left out with the mean taken over the rest, an answer altered
where it is produced, and (renders) one image returned for every seed.
A cell has no exchange between chips to leave out (one chip a cell).
The same run unbroken comes out correct."""

import numpy as np
import pytest
import torch

from benchmark import run as R

SEED = 2**31 + 11


def tiny_render():
    cell = R.Cell("cornellBox.final")
    cell.config["camera"].update(width=24, samples_per_pixel=64)
    cell.workload["params"].update(lanes=8192, pixels=128)
    return cell


def tiny_train():
    cell = R.Cell("cornellBox.train")
    cell.workload["params"].update(width=16, batches=4, depth=5)
    return cell


def run(cell):
    return R.run_cell(cell, SEED, 4.0, False, device="cpu")


@pytest.fixture
def regen():
    from go_raytracer_tpu_torch.integrator import regen
    return regen


def broken_render(monkeypatch, regen, fault):
    real = regen.render_regen
    first = {}

    def render(scene, cam, seed=0, **kw):
        if fault == "half":
            cam = type(cam)(**{**cam.__dict__, "samples_per_pixel":
                               cam.samples_per_pixel // 2})
        img, st = real(scene, cam, seed=seed, **kw)
        if fault == "unchanged":
            img = np.zeros_like(img)
        elif fault == "altered" and seed == SEED + 1:
            img = img.copy()
            img[: img.shape[0] // 2] = 0.0
        elif fault == "repeated":
            img = first.setdefault("img", img)
        return img, st

    monkeypatch.setattr(regen, "render_regen", render)


def test_render_unbroken_is_correct():
    assert run(tiny_render())["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered", "repeated"])
def test_render_fault_is_not_correct(monkeypatch, regen, fault):
    broken_render(monkeypatch, regen, fault)
    result = run(tiny_render())
    assert not result["correct"], result["checks"]


def test_train_unbroken_is_correct():
    assert run(tiny_train())["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_train_fault_is_not_correct(monkeypatch, fault):
    from go_raytracer_tpu_torch.integrator import wavefront

    if fault == "unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    elif fault == "half":
        real = wavefront.radiance

        def radiance(ds, o, *a, **kw):
            L, st = real(ds, o, *a, **kw)
            # the rays are batch-major: keep the first half of the
            # batches, doubled, so the mean is theirs
            keep = torch.arange(L.shape[0]) < L.shape[0] // 2
            return torch.where(keep[:, None], 2 * L, 0 * L), st

        monkeypatch.setattr(wavefront, "radiance", radiance)
    else:
        real_step = torch.optim.Adam.step

        def step(self, closure=None):
            p = self.param_groups[0]["params"][0]      # tex_color
            p.grad[1] *= 2.0
            return real_step(self, closure)

        monkeypatch.setattr(torch.optim.Adam, "step", step)
    result = run(tiny_train())
    assert not result["correct"], result["checks"]
