"""Per-patch run bundles and run folders (counterpart of ``io/results.py``).

A bundle ``<name>_run.npz`` holds the keys of the JAX package's bundle
(``device``, ``elapsed``, ``elapsed_seconds``, ``outpath``, ``history`` as a
pickled dict, ``mask``, ``image``, ``output``, and ``noise`` and ``pocs`` when
given), so either package's ``reconstruct_patches`` reads a run directory
that the other wrote. A patch whose bundle exists is finished: a rerun skips
it.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..engine.history import History
from ..utils.generic import sec2time


def device_name(device: Union[str, torch.device, None] = None) -> str:
    """'<card name> (<index>)' for a CUDA device, 'cpu' for the CPU; with no
    ``device``, the current CUDA device if there is one."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return f"{torch.cuda.get_device_name(idx)} ({idx})"


def run_bundle_path(outpath: str, name: str) -> str:
    return os.path.join(outpath, f"{name}_run.npz")


def save_run(outpath: str, name: str, history: History, mask: np.ndarray,
             image: np.ndarray, output: np.ndarray, elapsed: float,
             noise: Optional[np.ndarray] = None,
             pocs: Optional[np.ndarray] = None,
             device: Union[str, torch.device, None] = None) -> str:
    """Write the patch's bundle; ``device`` is the solve's."""
    os.makedirs(outpath, exist_ok=True)
    payload = {
        "device": device_name(device),
        "elapsed": sec2time(elapsed),
        "elapsed_seconds": float(elapsed),
        "outpath": outpath,
        "history": np.asarray(history.as_dict(), dtype=object),
        "mask": mask,
        "image": image,
        "output": output,
    }
    if noise is not None:
        payload["noise"] = noise
    if pocs is not None:
        payload["pocs"] = pocs
    path = run_bundle_path(outpath, name)
    np.savez(path, **payload)
    return path


def load_run(path: str) -> Dict:
    with np.load(path, allow_pickle=True) as z:
        out = {k: z[k] for k in z.files}
    if "history" in out:
        out["history"] = out["history"].item()
    return out


def completed_patches(outpath: str) -> List[str]:
    """Names of the patches with a finished bundle."""
    if not os.path.isdir(outpath):
        return []
    return sorted(f[:-len("_run.npz")] for f in os.listdir(outpath)
                  if f.endswith("_run.npz"))


def create_run_folder(root: str, name: str) -> str:
    """A new run directory <root>/<name>, else <name>_1, <name>_2, ..."""
    path = os.path.join(root, name)
    i = 0
    while os.path.exists(path):
        i += 1
        path = os.path.join(root, f"{name}_{i}")
    os.makedirs(path)
    return path
