"""Build the package's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into ``build/torch_kernels/lib<name>-<hash>.so`` at
the repository root (``.gitignore`` lists ``build/``) and loaded with
``ctypes``. The file name carries a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is reused.

``start_builds`` launches one ``nvcc`` per source, all at once, and
``load_library`` waits for its own; nothing is compiled at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("wgrad3d", "fused_loss", "upsample")

_pending: Dict[str, subprocess.Popen] = {}
_loaded: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    # CUDA_HOME / CUDA_PATH, else nvcc on PATH, else the default install
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None or not (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def start_build(name: str) -> Optional[subprocess.Popen]:
    """Launch ``nvcc`` for ``csrc/<name>.cu`` unless its library exists."""
    out = library_path(name)
    if name in _pending or out.exists():
        return _pending.get(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    _pending[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
    return _pending[name]


def start_builds() -> None:
    """One ``nvcc`` per source, all started together."""
    for name in SOURCES:
        start_build(name)


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name in _loaded:
        return _loaded[name]
    out = library_path(name)
    proc = start_build(name)
    if proc is not None:
        log, _ = proc.communicate()
        del _pending[name]
        build_log[name] = log
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
    _loaded[name] = ctypes.CDLL(str(out))
    return _loaded[name]
