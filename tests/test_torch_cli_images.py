"""The port's CLI on the two reference scenes with image textures, on the
CPU at 32 px and 4 spp: -S 5 (quads: the earth map on a quad, marble
noise, metal) and -S 2 (book2: the earth map on a sphere, every other
feature of the fused kernels beside it). Run in subprocesses."""

import json

import pytest

from test_torch_cli import run_cli


@pytest.mark.parametrize("scene,height,regen_len", [(5, 32, 1.47),
                                                    (2, 32, 5.08)])
def test_image_scene_renders(tmp_path, scene, height, regen_len):
    """Exit 0, a P3 image of the right size with finite values, and
    segments per path near the registry's mean path length (within 10%:
    a 4,096-path sample)."""
    out = tmp_path / f"s{scene}.ppm"
    r = run_cli(["-S", str(scene), "-o", str(out), "--cpu", "--width", "32",
                 "--spp", "4", "--lanes", "4096", "--stats", "--quiet"])
    assert r.returncode == 0, r.stderr[-2000:]
    stats = json.loads(r.stdout.strip().splitlines()[-1])
    assert stats["paths"] == 32 * height * 4 and stats["nonfinite"] == 0
    assert stats["schedule"] == "queue_ik"
    assert abs(stats["segments"] / stats["paths"] - regen_len) \
        <= 0.1 * regen_len
    txt = out.read_text().split()
    assert txt[:4] == ["P3", "32", str(height), "255"]
    assert len(txt) == 4 + 32 * height * 3
