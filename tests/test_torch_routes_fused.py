"""The binned route's fused rounds (`--b1-fused`, K10) end to end: scene 8
at 48 px through the CLI with `--cpu`, against the walk on the same random
stream (tests/test_torch_routes.py renders the other new routes)."""

import pytest
import torch

from tests.test_torch_routes import render_routes

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    return render_routes({"walk": [], "binned+b1_fused": ["--b1-fused"]},
                         tmp_path_factory.mktemp("routes_fused"))


def test_fused_route_renders_the_walk_image(renders):
    stats, image = renders["binned+b1_fused"]
    wstats, wimage = renders["walk"]
    assert stats["mesh"]["route"] == "binned+b1_fused"
    assert stats["segments"] == wstats["segments"] > stats["paths"] == 48 * 27
    assert image == wimage
    m = stats["mesh"]
    assert m["mesh_calls"] == stats["levels"] == wstats["levels"]
    assert m["host_reads"] == m["rounds"] + m["mesh_calls"]
    assert m["rounds"] >= m["mesh_calls"]
