"""Model and solver-state checkpoints (counterpart of ``io/checkpoint.py``).

Two formats:

* the net's weights: ``torch.save`` of its state dict, ``<name>_model.pt``
  (the format of the reference code the JAX package was ported from).
  ``load_checked`` first reads the saved run's ``args.txt`` and refuses a
  net whose configuration differs (``net_args_are_same``).
* the solver's whole state for an exact resume, one ``.npz``: the flat
  parameter buffer, Adam's ``mu``, ``nu`` and ``count``, an optimised
  canvas with its moments, the states of the step's generators (input
  noise, parameter noise, dropout), the learning rate, the trackers and
  ``done`` (``save_solver_state`` / ``load_solver_state``). The solver
  adds its position and history to the same file.

A JAX ``.msgpack`` weights file needs flax to read; loading one raises
``NotImplementedError`` (ROADMAP A.15).
"""
from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..config import Config, net_args_are_same, read_args


def npz_path(path: str) -> str:
    """``np.savez`` appends '.npz' when it is missing: normalise up front so
    that saving, the existence check and loading agree on one file name."""
    return path if path.endswith(".npz") else path + ".npz"


def save_params(path: str, params: Mapping[str, torch.Tensor]) -> None:
    """``torch.save`` of a state dict, as CPU tensors."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in params.items()}, path)


def _check_like(state: Mapping[str, torch.Tensor],
                template: Optional[Mapping[str, torch.Tensor]], what: str) -> None:
    if template is None:
        return
    missing = sorted(set(template) - set(state))
    unused = sorted(set(state) - set(template))
    if missing or unused:
        raise KeyError(f"{what}: missing {missing}, unused {unused}")
    bad = [(k, tuple(state[k].shape), tuple(v.shape)) for k, v in template.items()
           if tuple(state[k].shape) != tuple(v.shape)]
    if bad:
        raise ValueError(f"{what}: shape mismatch (name, got, expected): {bad}")


def load_params(path: str, template: Optional[Mapping[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
    """A state dict saved by :func:`save_params`, on the CPU; with a
    ``template`` (e.g. ``model.state_dict()``) every name and shape must
    match it."""
    if path.endswith(".msgpack"):
        raise NotImplementedError("loading the JAX package's .msgpack weights "
                                  "needs flax: ROADMAP A.15")
    state = torch.load(path, map_location="cpu", weights_only=True)
    _check_like(state, template, f"load_params({path})")
    return state


def load_checked(netpath: str, cfg: Config,
                 template: Optional[Mapping[str, torch.Tensor]] = None,
                 results_root: str = "./results") -> Dict[str, torch.Tensor]:
    """Load weights after checking that the saved run's configuration (its
    ``args.txt``, beside the weights) builds the same net as ``cfg``.

    ``netpath`` is absolute or relative to ``results_root``.
    """
    full = netpath if os.path.isabs(netpath) else os.path.join(results_root, netpath)
    saved_cfg = read_args(os.path.join(os.path.dirname(full), "args.txt"))
    if not net_args_are_same(cfg, saved_cfg):
        raise ValueError("saved network config is incompatible with the current one")
    return load_params(full, template)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    # numpy has no bfloat16; float32 holds every bfloat16 value exactly
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def save_solver_state(path: str, state: Mapping[str, torch.Tensor],
                      extra: Optional[Mapping[str, np.ndarray]] = None) -> str:
    """Write the named tensors of a solver state, and ``extra`` arrays, into
    one ``.npz``; returns its path."""
    path = npz_path(path)
    arrays = {k: _to_numpy(v) for k, v in state.items()}
    arrays.update(extra or {})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)
    return path


def load_solver_state(path: str, template: Mapping[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """The tensors of ``template``'s names from a :func:`save_solver_state`
    file, each with its template's shape, dtype and device."""
    out = {}
    with np.load(npz_path(path), allow_pickle=False) as z:
        for k, like in template.items():
            if k not in z.files:
                raise KeyError(f"{path} holds no {k!r}")
            arr = z[k]
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"{path}: {k!r} has shape {arr.shape}, "
                                 f"expected {tuple(like.shape)}")
            out[k] = torch.from_numpy(np.array(arr)).to(device=like.device,
                                                        dtype=like.dtype)
    return out
