"""The bundled datasets (counterpart of ``data/bundled.py``).

The lines gather and its masks are ``.npy`` files that the repository keeps
once, under ``deep_prior_interpolation_tpu/datasets``. The port reads them
there by file path; it imports nothing of that package.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

_DATASETS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "deep_prior_interpolation_tpu", "datasets")


def dataset_path(relpath: str) -> str:
    """Absolute path of a bundled dataset file, e.g. ``lines/original.npy``."""
    path = os.path.join(_DATASETS_DIR, relpath)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no bundled dataset file {relpath!r} "
                                f"(looked in {_DATASETS_DIR})")
    return path


def lines_dataset(dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """The lines 2D gather (170, 100, 1) and its 66 %-decimation mask."""
    img = np.load(dataset_path("lines/original.npy"))
    mask = np.load(dataset_path("lines/random66.npy"))
    return np.asarray(img, dtype), np.asarray(mask, dtype)


def lines_wavelet() -> Tuple[np.ndarray, float, float]:
    """The ``less_steep.npy`` bundle: (data, dt, dx)."""
    d = np.load(dataset_path("lines/less_steep.npy"), allow_pickle=True).item()
    return np.asarray(d["data"]), float(d["dt"]), float(d["dx"])
