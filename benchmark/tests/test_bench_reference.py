"""The plain reference follows the program's paths on the same random
numbers, and the yardstick's arithmetic (bounds, statistics, trace
reduction, metric readers, input generators) gives the expected values
on fixed inputs."""

import json
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import devtrace, roofline, run as R, scenes
from benchmark.reference import check_render, check_train, pathtrace as pt

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


@pytest.mark.parametrize("name,width,depth", [("cornellBox", 20, 8),
                                              ("modelExample", 24, 5)])
def test_reference_follows_the_programs_paths(name, width, depth):
    from go_raytracer_tpu_torch.integrator import wavefront
    from go_raytracer_tpu_torch.ops import trace as trace_mod
    from go_raytracer_tpu_torch.render import camera as camera_mod

    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    scene, cam = scenes.build(cfg, {"width": width, "max_depth": depth})
    n = width * cam.image_height * 2
    g = torch.Generator().manual_seed(3)
    ucam = torch.rand((n, 5), generator=g)
    ulev = torch.rand((depth + 1, n, 10), generator=g)
    ids = torch.arange(n) % (width * cam.image_height)
    zero = torch.zeros(())
    o, d, t = camera_mod.generate_rays(cam.derived(), width, ids, zero, zero, ucam)
    want, _ = wavefront.radiance(trace_mod.to_device(scene, "cpu"), o, d, t,
                                 None, depth, cam.max_contribution,
                                 uniforms=ulev, graph=False)
    frame = pt.camera_frame(dict(cfg["camera"], width=width))
    o2, d2 = pt.camera_rays(frame, ids, 0.0, 0.0, ucam, torch.float32)
    assert torch.equal(o, o2) and torch.equal(d, d2)
    got = pt.radiance(pt.Scene(cfg, "cpu"), o2, d2, depth,
                      cfg["camera"]["max_contribution"], lambda s: ulev[s])
    gap = (got - want).abs().sum(-1)
    # the same paths: a few rays may part at a grazing hit, by rounding
    assert float((gap > 1e-4).float().mean()) < 0.03
    assert float(gap.mean()) < 1e-3


def test_k1_bound_of_a_cornell_call():
    # 131,072 lanes x 8 levels: 72 B + 8 x 16 B a lane, bytes-bound
    bound = roofline.k1_bound_seconds(1, 131072, 8, 0.9 * 131072 * 8, 480)
    assert bound == pytest.approx(0.0078e-3, rel=5e-3)
    assert roofline.k1_call(131072, 8, 0, 480)[0] == 26214400


def test_closest_hit_bound_of_a_mesh_level():
    b = roofline.closest_hit_bytes(65536, 131072)
    assert b == 36 * 65536 + 36 * 131072
    assert roofline.closest_hit_bound_seconds(1, 65536, 131072) == \
        pytest.approx(b / 3.35e12)
    assert roofline.share_percent(1e-6, 0.0) is None
    assert roofline.share_percent(1e-6, 4e-6) == pytest.approx(25.0)


def test_render_numbers_on_fixed_images():
    rng = np.random.default_rng(0)
    mu = rng.uniform(0.1, 1.0, (2000, 3))
    draw = lambda k, scale=1.0: mu + scale * 0.1 * rng.standard_normal((k, 2000, 3))
    refs = draw(4)
    sound = check_render.numbers(draw(40), refs)
    assert sound["bias"] == pytest.approx(0.0, abs=0.15)
    assert sound["noise"] < 0.1 and sound["worst_image"] < 0.3
    half = check_render.numbers(draw(40, math.sqrt(2)), refs)
    assert half["noise"] > 0.6
    zeros = check_render.numbers(np.zeros((40, 2000, 3)), refs)
    assert zeros["bias"] > 100
    same = check_render.numbers(np.stack([draw(1)[0]] * 5), refs)
    assert same["noise"] > 20
    assert abs(sound["energy"]) < 4
    # 10% of the energy lost everywhere: `energy` sees it where `bias`
    # barely moves
    dim = check_render.numbers(0.9 * draw(40), refs)
    assert dim["energy"] > 50 and dim["bias"] < 15
    altered = draw(40)
    altered[3, :1000] = 0.0
    assert check_render.numbers(altered, refs)["worst_image"] > 4
    # the sample of images that bias, noise and energy read; worst_image
    # reads every image
    pick = check_render.sample_images(2**31 + 1, 40, 16)
    assert len(set(pick.tolist())) == 16 and pick.max() < 40
    assert np.array_equal(pick, check_render.sample_images(2**31 + 1, 40, 16))
    assert np.array_equal(check_render.sample_images(5, 7, 16), np.arange(7))
    sub = check_render.numbers(altered, refs, pick)
    assert sub["worst_image"] > 4
    assert sub["bias"] == check_render.numbers(altered[pick], refs)["bias"]


def test_train_numbers_on_fixed_leaves():
    ref = {"losses": [1.0, 0.5, 0.25],
           "grad1": {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([1.0]),
                     "c": torch.zeros(1)},
           "delta": {"a": torch.tensor([0.1]), "b": torch.tensor([0.2]),
                     "c": torch.tensor([0.0])}}
    prog = {"losses": [1.0, 0.55, 0.25],
            "grad1": {"a": torch.tensor([0.0, 5.5]), "b": torch.tensor([1.0]),
                      "c": torch.zeros(1)},
            "delta": {"a": torch.tensor([0.1]), "b": torch.tensor([0.0]),
                      "c": torch.tensor([9.0])}}
    got = check_train.numbers(prog, ref)
    assert got["loss"] == pytest.approx(0.1)
    assert got["grad"] == pytest.approx(0.1)     # |5.5 - 5| / 5
    assert got["step"] == pytest.approx(1.0)     # b unmoved; c not counted


def test_trace_reduction():
    layers = {"k1": ("K1", __import__("re").compile(r"\bfused_q_level\b")),
              "copies": ("copies", __import__("re").compile(r"^Memcpy"))}
    dev = [(0, 10, "fused_q_level<0>", False), (5, 20, "fused_q_level<0>", True),
           (30, 40, "Memcpy DtoH", False), (70, 100, "other_kernel", True)]
    host = [(0, 100, "bench"), (21, 29, "aten::copy_"), (41, 60, "cudaLaunchKernel")]
    s = devtrace.reduce_events(dev, host, 100e-9, layers)
    assert s.busy_s == pytest.approx(60e-9)
    assert s.n_kernels == 3
    assert s.layer_s["k1"] == pytest.approx(25e-9)
    assert s.graph_layer_s["k1"] == pytest.approx(15e-9)
    assert s.graph_layer_s["copies"] == 0.0
    assert s.kernel_count("fused_q_level") == 2
    assert s.kernel_count("fused_q_level", graph=True) == 1
    assert s.unclaimed_s == pytest.approx(30e-9)
    assert s.idle_gaps[0] == ["cudaLaunchKernel", pytest.approx(30e-9)]
    assert s.idle_gaps[1] == ["aten::copy_", pytest.approx(10e-9)]
    run = types.SimpleNamespace(trace=s)
    assert devtrace.idle_percent(run) == pytest.approx(40.0)


def test_metric_readers_on_fixed_runs():
    cell = R.Cell("cornellBox.final")
    summary = devtrace.TraceSummary(
        window_s=1.0, busy_s=0.5, n_kernels=900,
        kernels={"void fused_q_level<0, 0, 0, 0, 0, 0>(FusedQArgs, int)": [800, 0.09],
                 "count_dead(int const*, int*)": [100, 0.01]},
        layer_s={"k1": 0.1}, layer_n={"k1": 900}, graph_layer_s={"k1": 0.0},
        graph_kernels={}, unclaimed_s=0.0, device_ops=[], idle_gaps=[])
    units = [{"segments": 100 * 131072 * 8 * 0.5, "occupancy": 0.5,
              "start": 0.0, "end": 0.03}]
    run = types.SimpleNamespace(trace=summary, traced_units=units, units=units,
                                workload=cell.workload, config=cell.config)
    k1 = R.load_module(cell.readers["k1_roofline"], "m").read(run)
    want = 100 * 100 * roofline.least_seconds(
        *roofline.k1_call(131072, 8, 131072 * 4, 480)) / 0.1
    assert k1 == pytest.approx(want)
    assert R.load_module(cell.readers["occupancy"], "m").read(run) == \
        pytest.approx(50.0)
    assert R.load_module(cell.readers["image_p95_ms.host"], "m").read(run) is None
    # a quantity split by cells: read by the quantity's reader
    mcell = R.Cell("modelExample.final")
    assert mcell.readers["occupancy.mesh"].name == "occupancy.py"
    assert mcell.readers["device_idle.mesh"].name == "device_idle.py"
    assert R.quantity("paths_per_s.mesh") == "paths_per_s"
    # the closest hit: its own kernels, and the tensor kernels the level's
    # graph launched; none of it where no K5 launch came from a graph
    k5 = "void bvh8_closest_kernel<64>(Args)"
    ch = R.load_module(mcell.readers["closest_hit_roofline"], "m")
    for graphed, want_s in ((True, 0.5 + 0.2), (False, None)):
        summary = devtrace.TraceSummary(
            window_s=1.0, busy_s=0.9, n_kernels=0,
            kernels={k5: [10, 0.5], "elementwise_kernel": [99, 0.3]},
            layer_s={"closest_hit": 0.5, "tensor_ops": 0.3},
            layer_n={}, graph_layer_s={"closest_hit": 0.5, "tensor_ops": 0.2},
            graph_kernels={k5: [9, 0.45]} if graphed else {},
            unclaimed_s=0.0, device_ops=[], idle_gaps=[])
        units = [{"segments": 1e6}]
        run = types.SimpleNamespace(trace=summary, traced_units=units,
                                    config=mcell.config)
        got = ch.read(run)
        if want_s is None:
            assert got is None
        else:
            bound = roofline.closest_hit_bound_seconds(10, 65536, 1e6)
            assert got == pytest.approx(100 * bound / want_s)


def test_traffic_inputs_come_from_the_seed():
    a = check_render.sample_pixels(2**31 + 7, 600, 600, 4096)
    assert len(set(a.tolist())) == 4096
    assert np.array_equal(a, check_render.sample_pixels(2**31 + 7, 600, 600, 4096))
    assert not np.array_equal(a, check_render.sample_pixels(2**31 + 8, 600, 600, 4096))
    cell = R.Cell("cornellBox.train")
    cell.workload["params"].update(width=8, batches=2, depth=3)
    drivers = []
    for seed in (2**33 + 1, 2**33 + 1, 2**33 + 2):
        d = R.load_module(cell.driver_path, "d").Driver(R.Run(cell, seed, "cpu"))
        d.inputs()
        drivers.append(d)
    assert torch.equal(drivers[0].target, drivers[1].target)
    assert all(torch.equal(drivers[0].leaves0[k], drivers[1].leaves0[k])
               for k in drivers[0].leaves0)
    assert not torch.equal(drivers[0].target, drivers[2].target)
