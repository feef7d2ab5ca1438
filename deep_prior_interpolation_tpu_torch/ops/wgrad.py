"""3D conv weight gradient: a CUDA kernel for sm_90a and its plain version.

Replaces the Pallas TPU kernel ``deep_prior_interpolation_tpu/ops/pallas_wgrad.py``
(``_make_kernel`` via ``_pallas_wgrad_unpadded``, entry ``pallas_wgrad_s1``).
The kernel source, with its design and what bounds it on an H100, is
``csrc/wgrad3d.cu``; ``ops/_build.py`` compiles it with ``nvcc`` at first use.

Layout is the port's: ``x`` (1, Ci, D, H, W) and ``dy`` (1, Co, D, H, W), both
bfloat16 or both float32, give dW (Co, Ci, k, k, k) in float32, for a same-pad
stride-1 conv with an odd cubic kernel ``k``:

    dW[co, ci, t] = sum_s dy[co, s] * x[ci, s + t - p],   p = (k - 1) // 2

``wgrad3d`` takes the plain version for tensors on the CPU and launches the
kernel for CUDA tensors (``wgrad3d.launches`` counts the launches).
``wgrad_supported`` is the gate ``conv_vjp.conv_same`` applies before it asks
for the kernel: Hopper's own rules, not the TPU's ``H, W % 8`` and VMEM ones.
"""
from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["wgrad3d", "wgrad3d_plain", "wgrad_supported"]

_TARGET_BLOCKS = 132 * 8  # blocks to launch: 8 per SM of the H100
_MIN_SLAB = 8192          # float32 kernel: positions per block, >= 32 per thread
_MIN_ROWS = 16            # bfloat16 kernel: (d, h) rows per block, 4 per warp
_CO_TILES = (4, 8, 16)    # float32 kernel: co tile; ci tile = 64 // co tile
_NT = (1, 2, 4)           # bfloat16 kernel: co tile of 8 * NT; ci tile 16
_MAX_K = 7                # bfloat16 kernel: k * NT * 4 accumulators a thread

Padding = Union[int, Sequence[int], Sequence[Tuple[int, int]]]


def _pairs(padding: Padding, nd: int) -> Tuple[Tuple[int, int], ...]:
    if isinstance(padding, int):
        return ((padding, padding),) * nd
    return tuple((p, p) if isinstance(p, int) else tuple(p) for p in padding)


def wgrad_supported(x_shape: Sequence[int], w_shape: Sequence[int], stride: int,
                    padding: Padding) -> bool:
    """Gate: 3D, batch 1, stride 1, odd cubic kernel 1 < k <= 7 (the bf16
    kernel keeps k * 16 float32 accumulators a thread), symmetric same-pad
    zero padding. Any Ci and Co (the kernels tile both)."""
    if len(w_shape) != 5 or len(x_shape) != 5 or stride != 1 or x_shape[0] != 1:
        return False
    k = w_shape[2]
    if k % 2 == 0 or not 1 < k <= _MAX_K or w_shape[3] != k or w_shape[4] != k:
        return False
    p = (k - 1) // 2
    return _pairs(padding, 3) == ((p, p),) * 3


def wgrad3d_plain(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """Per-tap shifted slices and a float32 matmul; independent of cuDNN."""
    _, ci, d, h, w = x.shape
    co = dy.shape[1]
    p = (k - 1) // 2
    xp = F.pad(x[0].float(), (p, p, p, p, p, p))
    dyf = dy[0].float().reshape(co, -1)
    dw = torch.empty((co, ci, k, k, k), dtype=torch.float32, device=x.device)
    for t0 in range(k):
        for t1 in range(k):
            for t2 in range(k):
                xs = xp[:, t0:t0 + d, t1:t1 + h, t2:t2 + w].reshape(ci, -1)
                dw[:, :, t0, t1, t2] = dyf @ xs.T
    return dw


def _plan(ci: int, co: int, d: int, h: int, w: int, k: int,
          bf16: bool) -> Tuple[int, int]:
    """(tile, splits) of the grid. bfloat16: tile = NT (co tile 8 * NT),
    splits of (d, h) rows over k^2 tap pairs; float32: tile = co tile,
    splits of positions over k^3 taps."""
    if bf16:
        nt = next((t for t in _NT if co <= 8 * t), _NT[-1])
        tiles = math.ceil(co / (8 * nt)) * math.ceil(ci / 16)
        splits = math.ceil(_TARGET_BLOCKS / (k ** 2 * tiles))
        return nt, max(1, min(splits, math.ceil(d * h / _MIN_ROWS)))
    co_tile = next((t for t in _CO_TILES if co <= t), _CO_TILES[-1])
    tiles = math.ceil(co / co_tile) * math.ceil(ci / (64 // co_tile))
    splits = math.ceil(_TARGET_BLOCKS / (k ** 3 * tiles))
    return co_tile, max(1, min(splits, math.ceil(d * h * w / _MIN_SLAB)))


def _library() -> ctypes.CDLL:
    lib = _build.load_library("wgrad3d")
    fn = lib.dpi_wgrad3d
    # without argtypes ctypes would pass each pointer as a 32-bit int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def wgrad3d(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """dW (Co, Ci, k, k, k) float32 of a same-pad stride-1 k^3 conv."""
    if x.dim() != 5 or dy.dim() != 5 or x.shape[0] != 1 or dy.shape[0] != 1:
        raise ValueError(f"wgrad3d takes (1, C, D, H, W) tensors, got "
                         f"{tuple(x.shape)} and {tuple(dy.shape)}")
    if x.shape[2:] != dy.shape[2:]:
        raise ValueError(f"spatial mismatch: {tuple(x.shape)} vs {tuple(dy.shape)}")
    if k % 2 == 0 or k < 1:
        raise ValueError(f"wgrad3d needs an odd kernel size, got {k}")
    if x.device.type == "cpu" and dy.device.type == "cpu":
        return wgrad3d_plain(x, dy, k)
    if not (x.is_cuda and dy.device == x.device):
        raise ValueError(f"wgrad3d needs both inputs on one CUDA device, got "
                         f"{x.device} and {dy.device}")
    if x.dtype != dy.dtype or x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"wgrad3d takes two bfloat16 or two float32 tensors, "
                        f"got {x.dtype} and {dy.dtype}")
    bf16 = x.dtype == torch.bfloat16
    if bf16 and k > _MAX_K:
        raise ValueError(f"the bfloat16 wgrad3d kernel takes k <= {_MAX_K}, got {k}")
    x, dy = x.contiguous(), dy.contiguous()
    _, ci, d, h, w = x.shape
    co = dy.shape[1]
    tile, splits = _plan(ci, co, d, h, w, k, bf16)
    # 16-byte staging loads need every row of x and dy 16-byte aligned
    vec = w % 8 == 0 and x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0
    out = torch.empty((co, ci, k, k, k), dtype=torch.float32, device=x.device)
    ws = torch.empty((splits, co * ci * k ** 3), dtype=torch.float32,
                     device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.dpi_wgrad3d(x.data_ptr(), dy.data_ptr(), ws.data_ptr(),
                             out.data_ptr(), ci, co, d, h, w, k, splits, tile,
                             int(bf16), int(vec), stream)
    if rc != 0:
        raise RuntimeError(f"wgrad3d kernel launch failed: CUDA error {rc} "
                           f"(x {tuple(x.shape)}, dy {tuple(dy.shape)}, k {k})")
    wgrad3d.launches += 1
    return out


wgrad3d.launches = 0
