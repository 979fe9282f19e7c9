"""The closest-hit routes of the mesh path end to end: scene 8 at 48 px
through the CLI with `--cpu` (the kernels' plain versions), one seed, so
one random stream. Every route returns the walk's winners, so every render
traces the same segments and writes the same image; the stats name the
route and count its work. This file renders the walk on the binary BVH and
the persistent-block intersector; tests/test_torch_routes_fused.py the
binned route's fused rounds (tests/test_torch_regen_mesh.py holds the
unfused binned route to the walk)."""

import contextlib
import io
import json

import pytest
import torch

from go_raytracer_tpu_torch import cli
from go_raytracer_tpu_torch.ops import bounce, stream, stream2, traverse
from go_raytracer_tpu_torch.ops import traverse8

torch.set_num_threads(2)

ROUTES = {"walk": [], "walk+bvh2": ["--no-traverse8"], "binned2": []}


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    return render_routes(ROUTES, tmp_path_factory.mktemp("routes"))


def render_routes(routes, out_dir):
    """{route: (stats, image bytes)} of a scene-8 render per route."""
    res = {}
    for route, extra in routes.items():
        out = out_dir / f"{route}.ppm"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["-S", "8", "-o", str(out), "--cpu", "--width",
                           "48", "--spp", "1", "--max-depth", "3", "--lanes",
                           "2048", "--seed", "5", "--stats", "--quiet",
                           "--mesh", route.split("+")[0], *extra])
        assert rc == 0
        res[route] = (json.loads(buf.getvalue().strip().splitlines()[-1]),
                      out.read_bytes())
    return res


@pytest.mark.parametrize("route", [r for r in ROUTES if r != "walk"])
def test_route_renders_the_walk_image(renders, route):
    stats, image = renders[route]
    wstats, wimage = renders["walk"]
    assert stats["mesh"]["route"] == route and stats["schedule"] == "queue"
    assert stats["paths"] == 48 * 27 and stats["nonfinite"] == 0
    assert stats["segments"] == wstats["segments"] > stats["paths"]
    assert stats["levels"] == wstats["levels"]
    assert image == wimage
    m = stats["mesh"]
    assert m["mesh_calls"] == stats["levels"]
    if route.startswith("binned+"):
        assert m["host_reads"] == m["rounds"] + m["mesh_calls"]
    else:
        assert "rounds" not in m


def test_plain_versions_launch_nothing(renders):
    assert bounce.launches_bounce == stream.launches == 0
    assert stream.launches_round == stream2.launches == 0
    assert traverse.launches == traverse8.launches == 0
