"""N-dimensional patch tiling and overlap-add reconstruction (counterpart of
``data/patcher.py``).

Extraction is numpy (``sliding_window_view``) with the JAX package's whole
option surface: offset, stride, edge padding when the patch exceeds the
volume, random / scored / ``num`` / ``indexes`` selection and the 2D
Hanning / cosine tapers. Reconstruction is one ``index_add_`` over a static
flat index map (:func:`overlap_add`), on whatever device the patches are.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch


# ----------------------------------------------------------------------
# taper windows
# ----------------------------------------------------------------------

def hanningtaper(nmask: int, ntap: int) -> np.ndarray:
    if ntap > 0 and (nmask // ntap) < 2:
        ntap_min = nmask / 2 if nmask % 2 == 0 else (nmask - 1) / 2
        raise ValueError(f"ntap={ntap} must be smaller or equal than {ntap_min:.0f}")
    win = np.hanning(ntap * 2 - 1)
    return np.concatenate([win[:ntap], np.ones(nmask - 2 * ntap), win[:ntap][::-1]])


def cosinetaper(nmask: int, ntap: int, square: bool = False) -> np.ndarray:
    exp = 2 if square else 1
    n = np.arange(ntap * 2 - 1)
    win = (0.5 * (np.cos((n - (ntap * 2 - 2) / 2) * np.pi / ((ntap * 2 - 2) / 2)) + 1.0)) ** exp
    return np.concatenate([win[:ntap], np.ones(nmask - 2 * ntap), win[:ntap][::-1]])


def taper2d(nmask: Tuple[int, int], ntap: Tuple[int, int],
            tapertype: str = "hanning") -> np.ndarray:
    """2-D separable taper; an unknown ``tapertype`` gives ones."""
    builders = {
        "hanning": lambda n, t: hanningtaper(n, t),
        "cosine": lambda n, t: cosinetaper(n, t, False),
        "cosinesquare": lambda n, t: cosinetaper(n, t, True),
    }
    b = builders.get(tapertype, lambda n, t: np.ones(n))
    return np.outer(b(nmask[0], ntap[0]), b(nmask[1], ntap[1]))


def taper3d(nt: int, nmask: Tuple[int, int], ntap: Tuple[int, int],
            tapertype: str = "hanning") -> np.ndarray:
    """The 2-D (y, x) taper repeated along a trailing time axis:
    shape (nmask[0], nmask[1], nt)."""
    return np.repeat(taper2d(tuple(nmask), tuple(ntap), tapertype)[:, :, None],
                     nt, axis=2)


# ----------------------------------------------------------------------
# score function and shape helpers
# ----------------------------------------------------------------------

def mid_intensity_high_texture(x: np.ndarray) -> float:
    """Empirical quality score in [0, 1]: mid intensity, high texture."""
    if x.dtype == np.uint8:
        x = x / 255.0
    x = x.flatten()
    mean_val, std_val = x.mean(), x.std()
    ch_mean = -4 * mean_val ** 2 + 4 * mean_val
    ch_std = 1 - np.exp(-2 * np.log(10) * std_val)
    return 0.7 * ch_mean + 0.3 * ch_std


def count_patches(in_size, patch_size, patch_stride) -> int:
    idx = (np.array(in_size) - np.array(patch_size)) // np.array(patch_stride) + 1
    return int(np.prod(idx))


def patch_array_shape(in_size, patch_size, patch_stride) -> tuple:
    idx = (np.array(in_size) - np.array(patch_size)) // np.array(patch_stride) + 1
    return tuple(idx) + tuple(patch_size)


def in_content_cropped_shape(in_size, patch_size, patch_stride) -> tuple:
    assert len(in_size) == len(patch_size) == len(patch_stride)
    idx = patch_array_shape(in_size, patch_size, patch_stride)[:len(in_size)]
    return tuple((np.asarray(idx) - 1) * np.asarray(patch_stride) + np.asarray(patch_size))


# ----------------------------------------------------------------------
# overlap-add
# ----------------------------------------------------------------------

def _grid_starts(image_shape, dim, stride):
    """Start coordinates of every patch, in C order."""
    axes = [np.arange(0, image_shape[d] - dim[d] + 1, stride[d])
            for d in range(len(dim))]
    grids = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1)  # (P, ndim)


def flat_index_map(image_shape, dim, stride) -> np.ndarray:
    """(P, prod(dim)) int32 flat indices of each patch element."""
    starts = _grid_starts(image_shape, dim, stride)
    offsets = np.indices(dim).reshape(len(dim), -1)  # (ndim, prod)
    strides = np.array([int(np.prod(image_shape[d + 1:])) for d in range(len(dim))])
    flat = np.zeros((starts.shape[0], offsets.shape[1]), np.int64)
    for d in range(len(dim)):
        flat += (starts[:, d:d + 1] + offsets[d][None, :]) * strides[d]
    return flat.astype(np.int32)


def add_tiles(vol: torch.Tensor, tiles, starts: np.ndarray,
              dim: Sequence[int]) -> torch.Tensor:
    """Add tile j (``tiles[j]``, or the number ``tiles``) into ``vol`` at the
    box of ``starts[j]``, one box after another in tile order: a fixed
    order with no atomic scatter, so two calls are bit-equal on any
    device."""
    for j, st in enumerate(starts):
        box = tuple(slice(int(a), int(a) + int(d)) for a, d in zip(st, dim))
        vol[box] += tiles if isinstance(tiles, float) else tiles[j]
    return vol


def overlap_add(patches: torch.Tensor, image_shape: Sequence[int],
                dim: Sequence[int], stride: Sequence[int],
                normalize: bool = True) -> torch.Tensor:
    """Overlap-add assembly on the patches' device (:func:`add_tiles`: tile
    order, no atomics).

    ``patches``: (P, *dim). Returns the volume of ``image_shape``, averaged
    over the overlaps when ``normalize``.
    """
    patches = torch.as_tensor(patches)
    starts = _grid_starts(tuple(image_shape), tuple(dim), tuple(stride))
    zeros = dict(dtype=patches.dtype, device=patches.device)
    vol = add_tiles(torch.zeros(tuple(image_shape), **zeros), patches, starts, dim)
    if normalize:
        vol = vol / add_tiles(torch.zeros(tuple(image_shape), **zeros), 1.0, starts, dim)
    return vol


# ----------------------------------------------------------------------
# PatchExtractor
# ----------------------------------------------------------------------

class PatchExtractor:
    """N-dim patch extractor.

    ``rand`` shuffles the patches (numpy's global generator); ``function``
    scores each patch and keeps those at or above ``threshold``, best first;
    ``num`` keeps the first ``num``; ``indexes`` picks patches by index.
    ``tapering`` ('hanning', 'cosine', 'cosinesquare') applies to 2D only.
    ``padding`` (a ``np.pad`` mode) pads a volume smaller than the patch.
    """

    def __init__(self, dim: tuple, offset: Optional[tuple] = None,
                 stride: Optional[tuple] = None, rand: Optional[bool] = None,
                 function: Optional[Callable] = None,
                 threshold: Optional[float] = None, num: Optional[int] = None,
                 indexes=None, tapering: str = "rect",
                 padding: Optional[str] = None):
        if not isinstance(dim, tuple):
            raise ValueError("dim must be a tuple")
        self.dim = dim
        self.ndim = len(dim)

        offset = offset if offset is not None else (0,) * self.ndim
        if not isinstance(offset, tuple) or len(offset) != self.ndim:
            raise ValueError(f"offset must be a tuple of length {self.ndim}")
        self.offset = offset

        stride = stride if stride is not None else dim
        if not isinstance(stride, tuple) or len(stride) != self.ndim:
            raise ValueError(f"stride must be a tuple of length {self.ndim}")
        self.stride = stride

        if rand is not None and function is not None:
            raise ValueError("choose either random selection or a scoring "
                             "function, not both")
        self.rand = bool(rand) if rand is not None else False
        if function is not None and not callable(function):
            raise ValueError("function must be a function handler")
        self.function_handler = function
        self.threshold = float(threshold) if threshold is not None else 0.0
        if num is not None and indexes is not None:
            raise ValueError("num and indexes cannot be set at the same time")
        self.num = num
        self.indexes = np.array(indexes).flatten() if indexes is not None else None

        self.in_content_original_shape = None
        self.in_content_cropped_shape = None
        self.patch_array_shape = None
        self.tapering = tapering
        if self.tapering != "rect" and self.ndim != 2:
            self.tapering = "rect"  # tapering is 2D only
        self.padding = padding

    def _compute_padding(self, in_shape):
        pad = []
        for d in range(self.ndim):
            n = self.dim[d] - in_shape[d]
            half = n // 2
            pad.append((half, n - half))
        return pad

    def crop_padding(self, patch_array: np.ndarray, in_shape) -> np.ndarray:
        pad = self._compute_padding(in_shape)
        for d in range(self.ndim):
            patch_array = patch_array.take(
                range(pad[d][0], self.dim[d] - pad[d][1]), axis=d + self.ndim)
        return patch_array.squeeze()

    def extract(self, x: np.ndarray) -> np.ndarray:
        if not isinstance(x, np.ndarray):
            raise ValueError("in_content must be a numpy array")
        if x.ndim != self.ndim:
            raise ValueError(f"in_content must have {self.ndim} dims")
        self.in_content_original_shape = x.shape

        if self.padding is not None and x.shape < self.dim:
            x = np.pad(x, self._compute_padding(x.shape), mode=self.padding)

        for d, off in enumerate(self.offset):
            x = x.take(range(off, x.shape[d]), axis=d)

        if self.dim == self.stride:
            crop = x
            for d in range(self.ndim):
                dim_max = (x.shape[d] // self.dim[d]) * self.dim[d]
                crop = crop.take(range(0, dim_max), axis=d)
            windows = np.lib.stride_tricks.sliding_window_view(crop, self.dim)
            patch_array = windows[tuple(slice(None, None, s) for s in self.dim)]
        else:
            windows = np.lib.stride_tricks.sliding_window_view(x, self.dim)
            patch_array = windows[tuple(slice(None, None, s) for s in self.stride)]
        patch_array = np.ascontiguousarray(patch_array)

        patch_idx = patch_array.shape[:self.ndim]
        self.in_content_cropped_shape = tuple(
            (np.asarray(patch_idx) - 1) * np.asarray(self.stride) + np.asarray(self.dim))

        if self.rand:
            patch_array = patch_array.reshape((-1,) + self.dim)
            perm = np.random.permutation(patch_array.shape[0])
            patch_array = patch_array[perm]
        elif self.function_handler is not None:
            patch_array = patch_array.reshape((-1,) + self.dim)
            scores = np.asarray([self.function_handler(p) for p in patch_array])
            order = np.argsort(scores)[::-1]
            scores, patch_array = scores[order], patch_array[order]
            patch_array = patch_array[scores >= self.threshold]
        if self.num is not None:
            patch_array = patch_array.reshape((-1,) + self.dim)[:self.num]
        if self.indexes is not None:
            patch_array = patch_array.reshape((-1,) + self.dim)[self.indexes]

        self.patch_array_shape = patch_array.shape

        if self.tapering != "rect":
            ntap = tuple(np.array(self.dim) - np.array(self.stride))
            patch_array = patch_array * taper2d(self.dim, ntap, self.tapering)
        return patch_array

    def reconstruct(self, patch_array: Union[np.ndarray, torch.Tensor]
                    ) -> Union[np.ndarray, torch.Tensor]:
        """Overlap-add the (*grid, *dim) patch array into the volume: a
        numpy array for a numpy input, else a tensor on the input's device."""
        if not isinstance(patch_array, (np.ndarray, torch.Tensor)):
            raise ValueError("patch_array must be a numpy array or a tensor")
        ndim = patch_array.ndim // 2
        image_shape = self.in_content_cropped_shape
        expected = tuple((np.array(patch_array.shape[:ndim]) - 1)
                         * np.array(self.stride) + np.array(self.dim))
        if tuple(image_shape) != expected:
            raise ValueError(
                f"patch grid {tuple(patch_array.shape[:ndim])} with dim "
                f"{self.dim} / stride {self.stride} implies image shape "
                f"{expected}, but extractor was built for {tuple(image_shape)}")
        n = count_patches(image_shape, self.dim, self.stride)
        patches = torch.as_tensor(patch_array).reshape((n,) + self.dim)
        out = overlap_add(patches, image_shape, self.dim, self.stride,
                          normalize=(self.tapering == "rect"))
        if isinstance(patch_array, np.ndarray):
            return out.cpu().numpy().astype(patch_array.dtype)
        return out
