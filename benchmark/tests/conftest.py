"""Fixtures of the benchmark's own tests (``python -m pytest benchmark/tests``,
from the repository's root): cells cut to a size the CPU runs in seconds."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

TINY = {"patch3d": [32, 32, 32], "lanes": 2, "epochs": 4, "scan_chunk": 2}


def make_tiny(tmp: Path, cell: str) -> str:
    """A copy of ``cell`` in ``tmp`` at a tiny size: its configuration with
    4 iterations a solve in chunks of 2, its traffic with (32, 32, 32)
    patches and at most two lanes, its limits unchanged. Returns the tiny
    cell's name, for ``harness.run(..., extra_dir=tmp)``."""
    real = harness.load_cell(cell)
    cfg = json.loads(json.dumps(real["config"]))
    cfg["config"].update(epochs=TINY["epochs"], scan_chunk=TINY["scan_chunk"])
    tr = dict(real["traffic"], patch=TINY["patch3d"], pool=1,
              lanes=min(real["traffic"]["lanes"], TINY["lanes"]))
    name = f"tiny_{cell}"
    (tmp / f"{name}_config.json").write_text(json.dumps(cfg))
    (tmp / f"{name}_traffic.json").write_text(json.dumps(tr))
    work = dict(real["workload"], config=f"{name}_config", traffic=f"{name}_traffic")
    (tmp / f"{name}.json").write_text(json.dumps(work))
    return name


def run_cpu(tmp: Path, name: str, seed: int = 2 ** 31 + 11, trace: int = 0):
    """One harness run of a tiny cell on the CPU; (exit code, result line,
    standard error)."""
    import io
    from contextlib import redirect_stderr
    out, err = io.StringIO(), io.StringIO()
    with redirect_stderr(err):
        rc = harness.run(["--workload", name, "--seed", str(seed), "--seconds", "0",
                          "--trace", str(trace)], device="cpu", extra_dir=tmp, out=out)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
