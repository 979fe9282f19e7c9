"""Package rules of the port: no module of go_raytracer_tpu_torch, and not
chip_smoke.py, the port's example or the rank workers of its
multi-process tests (tests/torch_dist_workers.py, imported by every
spawned rank), imports jax, flax, optax or the JAX package — checked on
the source (AST), so a lazy import inside a function is caught too."""

import ast
import os

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "go_raytracer_tpu")


def _port_sources():
    pkg = os.path.join(_ROOT, "go_raytracer_tpu_torch")
    out = [os.path.join(_ROOT, "chip_smoke.py"),
           os.path.join(_ROOT, "examples", "inverse_rendering_torch.py"),
           os.path.join(_ROOT, "tests", "torch_dist_workers.py")]
    for d, _, files in os.walk(pkg):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, _ROOT))
def test_no_jax_imports(path):
    bad = [m for m in _imported_roots(path)
           if m.split(".")[0] in _FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, _ROOT)} imports {bad}"


def test_chip_smoke_needs_the_repo(tmp_path):
    """chip_smoke.py alone in a directory exits non-zero without a result
    line (here also for want of a GPU)."""
    import shutil
    import subprocess
    import sys

    shutil.copy(os.path.join(_ROOT, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_every_cuda_source_is_registered_and_bound():
    """Each csrc/*.cu is built by ops/_cuda (SOURCES, ENTRY) and names the
    TPU kernel it replaces (the port's own mesh-level glue says that it
    replaces none); each wrapper module counts its launches from zero and
    imports without a CUDA toolkit."""
    import importlib

    from go_raytracer_tpu_torch.ops import _cuda

    csrc = os.path.join(_ROOT, "go_raytracer_tpu_torch", "ops", "csrc")
    sources = sorted(f[:-3] for f in os.listdir(csrc) if f.endswith(".cu"))
    assert sources == sorted(_cuda.SOURCES) == sorted(_cuda.ENTRY)
    for name in sources:
        text = open(os.path.join(csrc, name + ".cu")).read()
        for entry in (_cuda.ENTRY[name],) + _cuda.MORE_ENTRIES.get(name, ()):
            assert f'extern "C" int {entry}(' in text, (name, entry)
        note = " ".join(text.replace("//", " ").split())
        assert ("Replaces no Pallas TPU kernel" if name == "mesh_level"
                else "Replaces the Pallas TPU kernel") in note, name
        assert "What bounds it" in note, name
    for mod, counters in (("bounce", ("launches", "launches_direct",
                                      "launches_bounce", "launches_fused",
                                      "launches_fused_pos")),
                          ("harvest", ("launches", "launches_rows",
                                       "launches_rows_perm")),
                          ("mesh_level", ("launches_refill",
                                          "launches_record")),
                          ("stream", ("launches", "launches_round")),
                          ("stream2", ("launches",)),
                          ("traverse", ("launches",)),
                          ("traverse8", ("launches",))):
        m = importlib.import_module(f"go_raytracer_tpu_torch.ops.{mod}")
        assert all(getattr(m, c) == 0 for c in counters), mod


def test_reference_engine_modules_import_without_a_toolkit():
    """The reference engine's modules import on a machine without CUDA or
    a compiler and expose the JAX package's names: vector math, the basis,
    the samplers, light and texture sampling, the dense trace, the
    wavefront bounce and radiance, and the renderer."""
    import importlib

    names = {"core.vecmath": ("dot", "length", "cross", "normalize",
                              "near_zero", "reflect", "refract"),
             "core.onb": ("build", "transform"),
             "core.rng": ("_sqrt0", "unit_vector", "cosine_direction",
                          "to_sphere", "unit_disk"),
             "integrator.sampling": ("texture_value", "_quad_light_pdf",
                                     "_sphere_light_pdf", "_tri_light_pdf",
                                     "lights_pdf_value", "lights_sample"),
             "ops.trace": ("Hit", "trace", "media_candidates",
                           "_sphere_attrs", "_quad_attrs", "_box_attrs",
                           "_tri_attrs", "CLS_MEDIUM"),
             "integrator.wavefront": ("clamp_contribution", "_bounce",
                                      "radiance", "N_FIXED_U", "U_MB"),
             "render.renderer": ("render", "render_to_file")}
    for mod, attrs in names.items():
        m = importlib.import_module(f"go_raytracer_tpu_torch.{mod}")
        missing = [a for a in attrs if not hasattr(m, a)]
        assert not missing, (mod, missing)
