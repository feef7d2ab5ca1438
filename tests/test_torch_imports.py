"""The PyTorch port stands alone: no JAX, flax, optax or Triton import,
nothing of the JAX package, and a solver that runs on CUDA unless told to
use the CPU."""
import ast
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

import deep_prior_interpolation_tpu_torch as port  # noqa: E402

PKG = Path(port.__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "deep_prior_interpolation_tpu"}
MODULES = sorted(PKG.rglob("*.py"))


def _part(path: Path) -> str:
    """The subpackage a module lies in ('.' for the package's own)."""
    rel = path.relative_to(PKG).parts
    return rel[0] if len(rel) > 1 else "."


PARTS = sorted({_part(p) for p in MODULES})


def _imported_modules(path: Path):
    """Whole top-level names of every module ``path`` imports (relative
    imports resolve inside the port)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_package_has_the_slice_modules():
    rel = {p.relative_to(PKG).as_posix() for p in MODULES}
    for m in ("config.py", "cli.py", "ops/fused_loss.py", "ops/wgrad.py", "ops/conv_vjp.py",
              "ops/pocs.py", "ops/masks.py", "ops/filters.py", "models/mulresunet.py",
              "models/skip.py", "models/unet.py", "models/partial.py", "models/attention.py",
              "models/convgru.py",
              "engine/solver.py", "io/bridge.py", "io/checkpoint.py", "io/results.py",
              "data/patcher.py", "data/pipeline.py", "data/bundled.py", "utils/generic.py"):
        assert m in rel
    assert (PKG / "csrc" / "wgrad3d.cu").exists()
    assert (PKG / "csrc" / "fused_loss.cu").exists()


def test_no_module_imports_triton():
    # both kernels are CUDA C++ built by nvcc: the port needs no Triton
    bad = [p.relative_to(PKG).as_posix() for p in MODULES if "triton" in _imported_modules(p)]
    assert not bad, f"modules that import triton: {bad}"


@pytest.mark.parametrize("part", PARTS)
def test_module_imports_no_jax_and_nothing_of_the_jax_package(part):
    # compare whole module names: the port's own name starts with the JAX
    # package's name, and must not be mistaken for it
    bad = {p.relative_to(PKG).as_posix(): sorted(set(_imported_modules(p)) & FORBIDDEN)
           for p in MODULES if _part(p) == part}
    assert not any(bad.values()), f"forbidden imports: {bad}"


def test_scan_catches_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import deep_prior_interpolation_tpu_torch\n"
                 "from deep_prior_interpolation_tpu.ops import losses\n"
                 "import jax.numpy as jnp\n")
    assert set(_imported_modules(f)) & FORBIDDEN == {"deep_prior_interpolation_tpu", "jax"}


def test_solver_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port.Config(datadim="3d", inputdepth=4, filters=[4, 8], skip=[4])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.DIPSolver(cfg)
    assert port.DIPSolver(cfg, device="cpu").device == torch.device("cpu")
    assert port.DIPSolver(port.Config(gpu=1), device="cpu").device.type == "cpu"
