"""Nothing the harness runs loads JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference imports nothing of the port."""
from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from conftest import ROOT

BENCH = ROOT / "benchmark"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("name, bad", [
    ("jax", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("deep_prior_interpolation_tpu", True), ("deep_prior_interpolation_tpu.ops", True),
    ("deep_prior_interpolation_tpu_torch", False), ("deep_prior_interpolation_tpu_torch.ops", False),
    ("jaxtyping", False), ("numpy", False)])
def test_forbidden_by_whole_top_level_name(monkeypatch, name, bad):
    monkeypatch.setitem(sys.modules, name, object())
    assert (name.split(".")[0] in harness.forbidden_modules()) is bad


def test_no_source_imports_jax():
    for f in BENCH.rglob("*.py"):
        assert not set(_imports(f)) & set(harness.FORBIDDEN), f


def test_reference_imports_nothing_of_the_port():
    for f in (BENCH / "reference").glob("*.py"):
        assert set(_imports(f)) <= {"__future__", "contextlib", "typing", "torch"}, f


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "mrunet3d.solo256", "--seed", str(2 ** 31 + 5), "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          env=env, timeout=300)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _run(ROOT, env)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
