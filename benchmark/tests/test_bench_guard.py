"""The import guard, and a run that finds no card fails without a
result."""

import ast
import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest

from benchmark import run as R

ROOT = Path(__file__).resolve().parents[2]
JAX_SIDE = {"jax", "jaxlib", "flax", "go_raytracer_tpu"}


def _imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_guard_compares_whole_top_level_names(monkeypatch):
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "go_raytracer_tpu_torch_x", types.ModuleType("x"))
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "go_raytracer_tpu.scenes", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert R.forbidden_modules() == ["go_raytracer_tpu", "jax"]


def test_reference_imports_nothing_of_either_package():
    for path in (ROOT / "benchmark/reference").glob("*.py"):
        found = _imports(path) & (JAX_SIDE | {"go_raytracer_tpu_torch"})
        assert not found, (path.name, found)


def test_harness_imports_no_jax():
    for path in (ROOT / "benchmark").rglob("*.py"):
        assert not _imports(path) & JAX_SIDE, path


def _run(cwd: Path, env_extra=None):
    env = {"PATH": "/usr/bin:/bin", "HOME": str(cwd), "CUDA_VISIBLE_DEVICES": "",
           **(env_extra or {})}
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "cornellBox.final", "--seed", str(2**31 + 3),
                           "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def _no_result(out: str) -> bool:
    lines = out.strip().splitlines()
    if not lines:
        return True
    try:
        return "correct" not in json.loads(lines[-1])
    except ValueError:
        return True


def test_run_without_a_card_fails_with_no_result():
    proc = _run(ROOT)
    assert proc.returncode != 0 and _no_result(proc.stdout)
    assert "CUDA" in proc.stderr


def test_run_with_only_the_benchmarks_files_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and _no_result(proc.stdout)


@pytest.mark.gpu
def test_a_short_run_on_the_card_is_correct(cuda):
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "cornellBox.final", "--seed", "2147483659",
                           "--seconds", "2", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]
