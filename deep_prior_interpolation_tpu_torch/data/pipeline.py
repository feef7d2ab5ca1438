"""Volume -> patches -> volume pipeline (counterpart of ``data/pipeline.py``).

``extract_patches`` loads the original and the corrupted volume (``.npy``),
turns NaN-marked traces into a binary mask, tiles both into patches
(channels-last: 2D (t, x, 1), 2.5D slices as channels, 3D (t, x, y, 1)),
scales the image by the gain and, with ``adirandel``, drops more traces at
random from ``np.random.default_rng(cfg.seed)``. ``reconstruct_patches``
overlap-adds per-patch outputs back into the volume and undoes the gain,
from an array or from a run directory of ``<name>_run.npz`` bundles.
"""
from __future__ import annotations

import os
from glob import glob
from typing import Dict, List, Optional

import numpy as np

from ..config import Config
from ..ops.filters import bool2bin
from ..ops.masks import add_rand_mask
from ..utils.generic import ten_digit
from .patcher import PatchExtractor, patch_array_shape


def get_patch_extractor(in_shape: tuple, patch_shape, patch_stride,
                        datadim: str, imgchannel: Optional[int] = None
                        ) -> PatchExtractor:
    """Resolve -1 extents (the full axis) and build the extractor; a
    ``patch_shape`` shorter than the volume's rank is extended with -1."""
    ndim = len(in_shape)
    patch_shape = list(patch_shape) + [-1] * (ndim - len(patch_shape))
    patch_stride = list(patch_stride) + [-1] * (ndim - len(patch_stride))
    dim = [patch_shape[d] if patch_shape[d] != -1 else in_shape[d]
           for d in range(ndim)]
    if datadim == "2.5d" and imgchannel is not None:
        dim[-1] = imgchannel
    stride = [patch_stride[d] if patch_stride[d] != -1 else dim[d]
              for d in range(len(dim))]
    return PatchExtractor(dim=tuple(dim), stride=tuple(stride))


def transpose_patches_25d(x: np.ndarray, slice_: str = "xy",
                          adj: bool = False) -> np.ndarray:
    """2.5D slice-orientation transposes of a (B, ...) patch stack."""
    s = slice_.lower()
    s = {"xt": "tx", "yt": "ty"}.get(s, s)
    if adj:
        if s == "xy":    # BXYT -> BTXY
            return x.transpose((0, 3, 1, 2))
        if s == "ty":    # BTYX -> BTXY
            return x.transpose((0, 1, 3, 2))
        return x
    if s == "xy":        # BTXY -> BXYT
        return x.transpose((0, 2, 3, 1))
    if s == "ty":        # BTXY -> BTYX
        return x.transpose((0, 1, 3, 2))
    return x


def extract_patches(cfg: Config,
                    original: Optional[np.ndarray] = None,
                    corrupted: Optional[np.ndarray] = None
                    ) -> List[Dict[str, np.ndarray]]:
    """List of {'image', 'mask', 'name'} patch dicts.

    The volumes are passed in, or loaded from ``cfg.imgdir/cfg.imgname`` and
    ``cfg.imgdir/cfg.maskname``.
    """
    if original is None:
        original = np.load(os.path.join(cfg.imgdir, cfg.imgname), allow_pickle=True)
    if corrupted is None:
        corrupted = np.load(os.path.join(cfg.imgdir, cfg.maskname), allow_pickle=True)

    if original.shape != corrupted.shape:
        raise ValueError("Original and Corrupted data must have the same dimension")
    if original.ndim not in (2, 3):
        raise ValueError("Data volumes have to be 2D or 3D")

    if np.isnan(corrupted).any():
        corrupted = bool2bin(corrupted)

    pe = get_patch_extractor(original.shape, cfg.patch_shape, cfg.patch_stride,
                             cfg.datadim, cfg.imgchannel)

    if cfg.datadim == "2.5d" or (cfg.datadim == "2d" and pe.ndim == 3):
        final_shape = (-1,) + pe.dim
    else:
        final_shape = (-1,) + pe.dim + (1,)

    patches_img = pe.extract(original.astype(np.float32)).reshape(final_shape)
    patches_msk = pe.extract(corrupted.astype(np.float32)).reshape(final_shape)

    if cfg.datadim == "2.5d":
        patches_img = transpose_patches_25d(patches_img, cfg.slice)
        patches_msk = transpose_patches_25d(patches_msk, cfg.slice)

    rng = np.random.default_rng(cfg.seed)
    outputs = []
    zeros = ten_digit(patches_img.shape[0])
    for p in range(patches_img.shape[0]):
        m = patches_msk[p]
        if cfg.adirandel > 0:
            m = add_rand_mask(m, cfg.adirandel, rng)
        outputs.append({"image": patches_img[p] * cfg.gain, "mask": m,
                        "name": str(p).zfill(zeros)})
    return outputs


def _to_patch_layout(patches_out: np.ndarray, cfg: Config) -> np.ndarray:
    """Undo the channels-last layout back to patch (t, x[, y]) order."""
    if cfg.datadim == "2.5d":
        return transpose_patches_25d(patches_out, cfg.slice, adj=True)
    if patches_out.ndim >= 4 and patches_out.shape[-1] == 1:
        return patches_out[..., 0]
    return patches_out


def reconstruct_patches(cfg: Config,
                        patches_out: Optional[np.ndarray] = None,
                        results_dir: Optional[str] = None,
                        return_history: bool = False,
                        original: Optional[np.ndarray] = None):
    """Assemble per-patch outputs into the full volume: the overlap-add
    average, divided by the gain.

    ``patches_out``: (P, *patch_spatial, C) in extraction order, or
    ``results_dir``: a directory of ``<name>_run.npz`` bundles.
    """
    if original is None:
        original = np.load(os.path.join(cfg.imgdir, cfg.imgname), allow_pickle=True)
    pe = get_patch_extractor(original.shape, cfg.patch_shape, cfg.patch_stride,
                             cfg.datadim, cfg.imgchannel)
    pe.extract(original.astype(np.float32))  # sets the extractor's geometry
    pas = patch_array_shape(original.shape, pe.dim, pe.stride)

    history = []
    if patches_out is None:
        if results_dir is None:
            raise ValueError("need patches_out or results_dir")
        outs = []
        for path in sorted(glob(os.path.join(results_dir, "*_run.npz"))):
            with np.load(path, allow_pickle=True) as z:
                outs.append(z["output"])
                if return_history and "history" in z:
                    history.append(z["history"].item())
        patches_out = np.asarray(outs)

    patches_out = _to_patch_layout(np.asarray(patches_out), cfg)
    out = pe.reconstruct(patches_out.reshape(pas)) / cfg.gain
    if return_history:
        return out, history
    return out
