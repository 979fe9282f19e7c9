"""The port's CLI (python -m go_raytracer_tpu_torch) against the contract
of tests/test_cli.py: exit 2 with the scene list on an unknown -S, a P3
PPM and one JSON stats line, seed reproducibility; plus no silent CPU
fallback when no GPU is present. Run in subprocesses, on the CPU."""

import json
import os
import subprocess
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# no GPU visible, few threads: the suite runs several workers at once
_ENV = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "2"}


def run_cli(args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "go_raytracer_tpu_torch", *args],
        capture_output=True, text=True, timeout=timeout, env=_ENV, cwd=_ROOT)


def test_unknown_scene_exits_2_with_listing(tmp_path):
    out = tmp_path / "unknown.ppm"
    r = run_cli(["-S", "99", "-o", str(out), "--cpu"])
    assert r.returncode == 2
    assert "cornellBox" in r.stderr + r.stdout
    assert not out.exists()


def test_render_ppm_and_stats(tmp_path):
    out = tmp_path / "img.ppm"
    r = run_cli(["-S", "6", "-o", str(out), "--cpu", "--width", "24",
                 "--spp", "4", "--max-depth", "3", "--lanes", "2048",
                 "--stats", "--quiet"])
    assert r.returncode == 0, r.stderr[-2000:]
    stats = json.loads(r.stdout.strip().splitlines()[-1])
    assert stats["paths"] == 24 * 24 * 4
    assert stats["segments"] >= stats["paths"]
    assert stats["schedule"] == "queue_ik" and stats["device"] == "cpu"
    txt = out.read_text().split()
    assert txt[0] == "P3"
    w, h, maxv = int(txt[1]), int(txt[2]), int(txt[3])
    assert (w, h, maxv) == (24, 24, 255)
    vals = np.asarray(txt[4:], dtype=np.int64)
    assert vals.size == w * h * 3
    assert vals.min() >= 0 and vals.max() <= 255


import pytest


@pytest.mark.parametrize("schedule", ["queue", "positional"])
def test_schedule_flag_reaches_render_regen(tmp_path, schedule):
    """`--schedule queue|positional` render cornellBox on that schedule."""
    out = tmp_path / f"{schedule}.ppm"
    r = run_cli(["-S", "6", "-o", str(out), "--cpu", "--schedule", schedule,
                 "--width", "24", "--spp", "4", "--max-depth", "3",
                 "--lanes", "2048", "--stats", "--quiet"])
    assert r.returncode == 0, r.stderr[-2000:]
    stats = json.loads(r.stdout.strip().splitlines()[-1])
    assert stats["schedule"] == schedule and stats["device"] == "cpu"
    assert stats["paths"] == 24 * 24 * 4 <= stats["segments"]
    assert stats["nonfinite"] == 0
    assert out.read_text().split()[:4] == ["P3", "24", "24", "255"]


def test_seed_reproducibility(tmp_path):
    """Same --seed: the same image bit for bit; another seed: not."""
    outs = []
    for seed in (3, 3, 4):
        out = tmp_path / f"s{seed}_{len(outs)}.ppm"
        r = run_cli(["-S", "cornellBox", "-o", str(out), "--cpu", "--width",
                     "16", "--spp", "4", "--max-depth", "3", "--lanes",
                     "1024", "--seed", str(seed), "--quiet"])
        assert r.returncode == 0, r.stderr[-2000:]
        outs.append(out.read_text())
    assert outs[0] == outs[1]
    assert outs[0] != outs[2]


def test_without_gpu_and_without_cpu_flag_fails_clearly(tmp_path):
    r = run_cli(["-S", "6", "-o", str(tmp_path / "x.ppm"), "--quiet"])
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
    assert not (tmp_path / "x.ppm").exists()


def test_unported_paths_exit_2(tmp_path):
    """Flags naming a path a scene or integrator does not have exit 2 with
    a message, naming what it has: book2's image textures on the
    direct-record path, the in-kernel queue off the fused kernels, a
    schedule on the wavefront integrator, the kernels on a scene with
    triangle lights."""
    for extra, word in ((["--integrator", "wavefront", "--schedule",
                          "queue"], "regen"),
                        (["-S", "8", "--obj", "assets/lanternhouse.obj",
                          "--backend", "pallas"], "triangle lights"),
                        (["-S", "2", "--direct-rec"], "image textures"),
                        (["-S", "8", "--schedule", "queue_ik"], "ROADMAP")):
        r = run_cli(["-o", str(tmp_path / "x.ppm"), "--cpu", "--width", "8",
                     "--spp", "1", "--quiet", *extra])
        assert r.returncode == 2, (extra, r.stderr[-500:])
        assert word in r.stderr, (extra, r.stderr[-500:])


@pytest.mark.parametrize("scene,regen_len", [(3, 5.54), (7, 2.91)])
def test_book3_and_cornell_smoke_render(tmp_path, scene, regen_len):
    """-S 3 (book3: glass sphere, sphere light) and -S 7 (cornellSmoke: two
    media) at 32 px, 4 spp: exit 0, a finite image, and segments per path
    near the registry's mean path length (within 10%: a 4,096-path
    sample)."""
    out = tmp_path / f"s{scene}.ppm"
    r = run_cli(["-S", str(scene), "-o", str(out), "--cpu", "--width", "32",
                 "--spp", "4", "--lanes", "4096", "--stats", "--quiet"])
    assert r.returncode == 0, r.stderr[-2000:]
    stats = json.loads(r.stdout.strip().splitlines()[-1])
    assert stats["paths"] == 32 * 32 * 4 and stats["nonfinite"] == 0
    assert abs(stats["segments"] / stats["paths"] - regen_len) \
        <= 0.1 * regen_len
    txt = out.read_text().split()
    assert txt[:4] == ["P3", "32", "32", "255"]
    assert len(txt) == 4 + 32 * 32 * 3


@pytest.mark.parametrize("scene,regen_len", [(4, 1.69), (1, 2.60)])
def test_simple_light_and_book1_render(tmp_path, scene, regen_len):
    """-S 4 (simpleLight: marble noise) and -S 1 (book1: 389 spheres, a
    checker ground, glass, metal, defocus) at 32 px (18 rows), 4 spp: exit
    0, a finite image, and segments per path near the registry's mean path
    length (within 10%: a 2,304-path sample)."""
    out = tmp_path / f"s{scene}.ppm"
    r = run_cli(["-S", str(scene), "-o", str(out), "--cpu", "--width", "32",
                 "--spp", "4", "--lanes", "4096", "--stats", "--quiet"])
    assert r.returncode == 0, r.stderr[-2000:]
    stats = json.loads(r.stdout.strip().splitlines()[-1])
    assert stats["paths"] == 32 * 18 * 4 and stats["nonfinite"] == 0
    assert abs(stats["segments"] / stats["paths"] - regen_len) \
        <= 0.1 * regen_len
    txt = out.read_text().split()
    assert txt[:4] == ["P3", "32", "18", "255"]
    assert len(txt) == 4 + 32 * 18 * 3


def test_route_flags_refuse_instead_of_falling_back(tmp_path):
    """Where the JAX package would quietly take another route, the port
    exits 2 with a message: the BVH walk's option off the walk route
    (named, or the binned route that `--b1-fused` makes of auto), the
    fused round off the binned route, a mesh route on a scene without a
    mesh, and records written in place on a scene with image textures
    (scene 5)."""
    for extra, word in ((["-S", "8", "--mesh", "binned", "--no-traverse8"],
                         "traverse8"),
                        (["-S", "8", "--b1-fused", "--no-traverse8"],
                         "traverse8"),
                        (["-S", "6", "--mesh", "walk"], "no mesh"),
                        (["-S", "8", "--mesh", "walk", "--b1-fused"],
                         "b1_fused"),
                        (["-S", "5", "--direct-rec"], "image")):
        r = run_cli(["-o", str(tmp_path / "x.ppm"), "--cpu", "--width", "8",
                     "--spp", "1", "--quiet", *extra])
        assert r.returncode == 2, (extra, r.stderr[-500:])
        assert word in r.stderr, (extra, r.stderr[-500:])
        assert not (tmp_path / "x.ppm").exists()


def test_binned2_and_fused_need_their_tables(tmp_path, monkeypatch):
    """Scene 8 built without the finer cl2 partition (the budget rule set
    to nothing) refuses --mesh binned2, and with more clusters than the
    fused round holds (its limit lowered below scene 8's 128) refuses
    --b1-fused: exit 2, no image."""
    from go_raytracer_tpu_torch import cli
    from go_raytracer_tpu_torch.ops import stream
    from go_raytracer_tpu_torch.scene import builder

    out = tmp_path / "x.ppm"
    args = ["-S", "8", "-o", str(out), "--cpu", "--width", "8", "--spp",
            "1", "--quiet"]
    with monkeypatch.context() as m:
        m.setattr(builder, "CLUSTER2_TABLE_BYTES", 0)
        assert cli.main(args + ["--mesh", "binned2"]) == 2
    with monkeypatch.context() as m:
        m.setattr(stream, "MAX_ROUND_K", 64)
        assert cli.main(args + ["--b1-fused"]) == 2
    assert not out.exists()


def test_direct_rec_flag_renders_the_same_image(tmp_path):
    """`--direct-rec` on cornellBox at 32 px: exit 0, the stats say so, and
    the image equals the plane path's at the same seed."""
    imgs = []
    for extra in ([], ["--direct-rec"]):
        out = tmp_path / f"d{len(imgs)}.ppm"
        r = run_cli(["-S", "6", "-o", str(out), "--cpu", "--width", "32",
                     "--spp", "4", "--max-depth", "4", "--lanes", "2048",
                     "--stats", "--quiet", *extra])
        assert r.returncode == 0, r.stderr[-2000:]
        stats = json.loads(r.stdout.strip().splitlines()[-1])
        assert stats["direct_rec"] == bool(extra)
        imgs.append(out.read_text())
    assert imgs[0] == imgs[1]
