"""Parameter bridge between the JAX package's flax tree and the port's state dict.

A flax parameter tree (nested dicts of numpy arrays, e.g. from
``jax.device_get(params)``) maps onto the port's ``state_dict`` name for
name: the nested keys joined with '.' (``nn.scan``'s broadcast parameters
sit under the scan's own scope name, ``Scan_<Module>_0``, in both), and
each ``kernel`` moved to PyTorch's layout:

* a conv kernel (``Conv``, flax's ``nn.Conv``), channels-last DHWIO (HWIO
  in 2D) -> OIDHW (OIHW);
* an ``nn.ConvTranspose`` kernel (a module named ``ConvTranspose_<n>``),
  which flax applies unflipped, (*window, in, out) -> PyTorch's
  ``conv_transpose`` weight (in, out, *window), flipped along every window
  dim;
* a ``Dense`` kernel (rank 2), (in, out) -> (out, in).

``scale`` and ``bias`` are unchanged. Both directions refuse a leaf left
unused on either side and any shape that does not match.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(_flatten(v, name + "."))
        else:
            flat[name] = np.asarray(v)
    return flat


def _kind(name: str, a: np.ndarray) -> str:
    """'conv', 'transpose', 'dense' for a kernel, else ''."""
    parts = name.split(".")
    if parts[-1] != "kernel" or a.ndim < 2:
        return ""
    if a.ndim == 2:
        return "dense"
    return "transpose" if len(parts) > 1 and parts[-2].startswith("ConvTranspose") else "conv"


def _to_port(name: str, k: np.ndarray) -> np.ndarray:
    kind, nd = _kind(name, k), k.ndim - 2
    if kind == "dense":
        return np.ascontiguousarray(k.T)
    if kind == "conv":
        return np.ascontiguousarray(np.transpose(k, (nd + 1, nd) + tuple(range(nd))))
    if kind == "transpose":
        k = np.flip(k, tuple(range(nd)))
        return np.ascontiguousarray(np.transpose(k, (nd, nd + 1) + tuple(range(nd))))
    return k


def _to_jax(name: str, k: np.ndarray) -> np.ndarray:
    kind, nd = _kind(name, k), k.ndim - 2
    if kind == "dense":
        return np.ascontiguousarray(k.T)
    if kind == "conv":
        return np.ascontiguousarray(np.transpose(k, tuple(range(2, nd + 2)) + (1, 0)))
    if kind == "transpose":
        k = np.transpose(k, tuple(range(2, nd + 2)) + (0, 1))
        return np.ascontiguousarray(np.flip(k, tuple(range(nd))))
    return k


def _check(converted: Dict[str, np.ndarray],
           reference: Optional[Mapping[str, Any]], what: str) -> None:
    if reference is None:
        return
    ref = {k: tuple(np.shape(v)) for k, v in reference.items()}
    missing = sorted(set(ref) - set(converted))
    unused = sorted(set(converted) - set(ref))
    if missing or unused:
        raise KeyError(f"{what}: missing {missing}, unused {unused}")
    bad = [(k, converted[k].shape, ref[k]) for k in ref
           if tuple(converted[k].shape) != ref[k]]
    if bad:
        raise ValueError(f"{what}: shape mismatch (name, got, expected): {bad}")


def jax_params_to_state_dict(params: Mapping[str, Any],
                             like: Optional[Mapping[str, Any]] = None
                             ) -> Dict[str, torch.Tensor]:
    """flax params -> port state dict (float32 CPU tensors).

    ``like`` (e.g. ``model.state_dict()``) names every leaf the result must
    hold, with its shape: any leaf missing or left over raises.
    """
    flat = _flatten(params)
    out = {k: _to_port(k, v) for k, v in flat.items()}
    _check(out, like, "jax_params_to_state_dict")
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}


def state_dict_to_jax_params(state: Mapping[str, Any],
                             like: Optional[Mapping[str, Any]] = None
                             ) -> Dict[str, Any]:
    """port state dict -> nested flax params (float32 numpy).

    ``like`` (a flax params tree) names every leaf the result must hold.
    """
    flat = {}
    for k, v in state.items():
        a = v.detach().cpu().float().numpy() if torch.is_tensor(v) else np.asarray(v)
        flat[k] = _to_jax(k, a)
    _check(flat, None if like is None else _flatten(like), "state_dict_to_jax_params")
    tree: Dict[str, Any] = {}
    for k, v in flat.items():
        node = tree
        *parents, leaf = k.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.array(v, np.float32)
    return tree
