"""The x2 half-pixel linear upsample with a deterministic backward: a CUDA
kernel for sm_90a and its plain version.

``linear_upsample2x`` is the bilinear (2D) or trilinear (3D) resize by 2 with
``align_corners=False`` (the JAX package's ``jax.image.resize(...,
"linear")`` at factor 2). Its forward is ``F.interpolate``, a gather.
PyTorch's CUDA backward of it scatters with atomic adds, whose order changes
from run to run; here the backward is a gather in a fixed order, so two runs
from one state stay bit-equal, which an exact resume needs. No TPU kernel
stands behind it: the JAX package leaves that backward to XLA.

Along each axis of n input samples, input i gathers its four output
gradients with fixed weights:
``0.25 g[2i-1] + w0 g[2i] + w1 g[2i+1] + 0.25 g[2i+2]``, with w0 = 0.75
(1 at i = 0), w1 = 0.75 (1 at i = n-1) and g outside [0, 2n) read as 0;
the axes in the order W, H, D, in float32, rounded once to the gradient's
dtype. ``csrc/upsample.cu`` holds the kernel, its design and what bounds it
on an H100 (bytes); ``ops/_build.py`` compiles it at first use.

``upsample_bwd`` takes the plain version for tensors on the CPU and launches
one of two kernels for CUDA tensors (any other device raises), chosen up
front by ``plan``: ``tma`` (a ring of TMA boxes over D planes) wherever TMA
can read the gradient (rows of 2W elements a multiple of 16 bytes, a
16-byte aligned base), ``direct`` (plain loads) for every other gradient.
``upsample_bwd.launches`` counts the launches, ``upsample_bwd.tma_launches``
and ``upsample_bwd.direct_launches`` each kernel's.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function

from . import _build

__all__ = ["linear_upsample2x", "upsample_bwd", "upsample_bwd_plain"]

_MODES = {2: "bilinear", 3: "trilinear"}
_SMS = 132   # H100 SXM
_THREADS = 256
# an H100 SM's limits: shared memory of the SM, of one block; registers
_SMEM_SM, _SMEM_BLOCK, _REGS_SM = 233472, 232448, 65536
_BAR_BYTES, _MAX_STAGES = 128, 8   # csrc/upsample.cu: kBarBytes, kMaxStages

# upsample_bwd_tma's tile configurations, as csrc/upsample.cu instantiates
# them (index = its `cfg`), one for each tile width: TW input columns and TH
# rows of a tile, K rows a thread (of 4 columns), P planes a block; picked
# from 10 tile shapes x 4 ring depths timed on an H100 at the main and the
# lane paths' shapes (PERF.md)
TMA_CONFIGS = ((64, 16, 4, 1), (32, 16, 4, 2), (16, 16, 4, 4), (8, 8, 4, 16))
# registers a thread (ptxas, sm_90a), 3D and 2D, for the blocks an SM holds
_TMA_REGS = {True: 120, False: 68}
# the ring's depth, and the shortest D range a block walks (its D halo adds
# 1/span to the reads)
_STAGES = 3
_MIN_SPAN = 4


def _axis_bwd(g: torch.Tensor, axis: int) -> torch.Tensor:
    """The gather along ``axis`` (2n samples -> n), each product and sum
    rounded in the kernel's order."""
    gm = g.movedim(axis, -1)
    n = gm.shape[-1] // 2
    even, odd = gm[..., 0::2], gm[..., 1::2]
    before = F.pad(odd[..., :-1], (1, 0))   # g[2i - 1]
    after = F.pad(even[..., 1:], (0, 1))    # g[2i + 2]
    w0 = torch.full((n,), 0.75, dtype=g.dtype, device=g.device)
    w1 = w0.clone()
    w0[0] = 1.0
    w1[-1] = 1.0
    s = before * 0.25
    s = s + even * w0
    s = s + odd * w1
    s = s + after * 0.25
    return s.movedim(-1, axis)


def upsample_bwd_plain(grad_out: torch.Tensor, ndim: int) -> torch.Tensor:
    """d/dx of ``<grad_out, linear_upsample2x(x)>`` as plain tensor code: the
    gather along the last ``ndim`` dims (W, then H, then D) in float32 (float64
    for a float64 gradient), then rounded to grad_out's dtype."""
    g = grad_out.to(torch.promote_types(grad_out.dtype, torch.float32))
    for axis in range(g.ndim - 1, g.ndim - 1 - ndim, -1):
        g = _axis_bwd(g, axis)
    return g.to(grad_out.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("upsample")
    # without argtypes ctypes would pass each pointer as a 32-bit int
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dpi_upsample_bwd_direct.argtypes = [p, p, ll, i, i, i, i, i, i, i, i, p]
    lib.dpi_upsample_bwd_direct.restype = i
    lib.dpi_upsample_bwd_tma.argtypes = [p, p, i, i, i, i, i, i, i, i, i, p]
    lib.dpi_upsample_bwd_tma.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def launch_grid(planes: int, d: int, h: int, w: int) -> Tuple[int, int, int]:
    """(th, tw, span) of the direct kernel: a block of tw x th threads over a
    tile of the input (tw 8, 16 or 32 columns, at most 256 threads) and
    ``span`` D planes a block walks, as many as leave about 16 blocks an SM."""
    tw = 32 if w > 16 else 16 if w > 8 else 8
    th = min(_THREADS // tw, 1 << max(0, (h - 1).bit_length()))
    tiles = planes * -(-h // th) * -(-w // tw)
    ranges = max(1, min(d, -(-16 * _SMS // tiles)))
    return th, tw, -(-d // ranges)


class Plan(NamedTuple):
    """One launch of ``upsample_bwd``: which kernel and how it is cut."""
    kernel: str           # "tma" or "direct"
    cfg: int              # index of TMA_CONFIGS (-1: direct)
    th: int               # input rows and columns of a block's tile
    tw: int
    stages: int           # boxes in the ring (0: direct)
    span: int             # D planes (3D; 2D tma: plane groups) a block walks
    threads: int          # a block's
    smem: int             # dynamic shared memory bytes of a block
    blocks: int
    box: Tuple[int, ...]  # the TMA box, innermost first (direct: ())


def tma_readable(w: int, elem_size: int, ptr: int = 0) -> bool:
    """Whether TMA can read a gradient of input width ``w``: rows of 2 w
    elements a multiple of 16 bytes and a 16-byte aligned base."""
    return (2 * w * elem_size) % 16 == 0 and ptr % 16 == 0


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _best_span(work: int, units: int, slots: int, halo: int) -> int:
    """The span (units a block walks) whose grid of ``work`` x ranges blocks
    finishes first when ``slots`` blocks run at once and a block takes
    span + ``halo`` steps: the fewest waves x steps, the longest span on a
    tie, no span under ``_MIN_SPAN`` (or ``units``)."""
    best = None
    for ranges in range(1, units + 1):
        span = _ceil(units, ranges)
        if span < min(units, _MIN_SPAN):
            break
        cost = _ceil(work * _ceil(units, span), slots) * (span + halo)
        if best is None or cost < best[0]:
            best = (cost, span)
    return best[1]


def tma_plan(planes: int, d: int, h: int, w: int, has_d: bool, elem_size: int, cfg: int,
             stages: Optional[int] = None) -> Plan:
    """The ``tma`` launch in configuration ``cfg``: a ring of ``stages``
    boxes (as deep as ``_STAGES`` and shared memory allow, if not given) and
    the span whose grid finishes first."""
    tw, th, k, p = TMA_CONFIGS[cfg]
    threads = p * (th // k) * (tw // 4)
    ndp = 2 if has_d else 1
    # a box row starts 16 bytes left of the tile: 2 tw + 32 bytes of columns
    cols, rows = 2 * tw + 32 // elem_size, 2 * th + 2
    pitch = _ceil(p * ndp * rows * cols * elem_size, 128) * 128
    tiles = _ceil(h, th) * _ceil(w, tw)
    groups, units = (_ceil(planes, p), d) if has_d else (1, _ceil(planes, p))
    ring = stages or max(1, min(_STAGES, (_SMEM_BLOCK - _BAR_BYTES) // pitch))
    per_sm = max(1, min(32, 2048 // threads, _REGS_SM // (threads * _TMA_REGS[has_d]),
                        _SMEM_SM // (_BAR_BYTES + ring * pitch + 1024)))
    span = _best_span(tiles * groups, units, per_sm * _SMS, ndp - 1)
    loads = min(span, units) + ndp - 1
    ring = stages or min(ring, loads)
    box = (cols, rows, 2, p) if has_d else (cols, rows, p)
    return Plan("tma", cfg, th, tw, ring, span, threads, _BAR_BYTES + ring * pitch,
                tiles * groups * _ceil(units, span), box)


@functools.lru_cache(maxsize=None)
def plan(planes: int, d: int, h: int, w: int, has_d: bool, elem_size: int,
         aligned: bool = True) -> Plan:
    """The launch of ``upsample_bwd`` for ``planes`` input planes of (d, h, w)
    (d = 1 in 2D) of ``elem_size``-byte elements: ``tma`` wherever TMA can
    read the gradient (``tma_readable``; ``aligned``: its base is 16-byte
    aligned), else ``direct``. Decided from these alone, before the launch."""
    if aligned and tma_readable(w, elem_size):
        cfg = 0 if w > 32 else 1 if w > 16 else 2 if w > 8 else 3   # by tile width
        return tma_plan(planes, d, h, w, has_d, elem_size, cfg)
    return direct_plan(planes, d, h, w, has_d)


def direct_plan(planes: int, d: int, h: int, w: int, has_d: bool) -> Plan:
    """The ``direct`` launch: ``launch_grid``'s tile and span."""
    th, tw, span = launch_grid(planes, d, h, w)
    smem = 4 * 2 * (2 * th + 2) * ((2 * tw + 2) + tw)
    blocks = planes * _ceil(h, th) * _ceil(w, tw) * (_ceil(d, span) if has_d else 1)
    return Plan("direct", -1, th, tw, 0, span, th * tw, smem, blocks, ())


def _validate(grad_out: torch.Tensor, ndim: int) -> None:
    if ndim not in _MODES or grad_out.dim() != ndim + 2:
        raise ValueError(f"upsample_bwd takes an (N, C, *spatial) gradient of 2 or 3 "
                         f"spatial dims, got {tuple(grad_out.shape)} with ndim={ndim}")
    if any(s % 2 for s in grad_out.shape[2:]):
        raise ValueError(f"the gradient of a x2 upsample has even spatial sizes, got "
                         f"{tuple(grad_out.shape)}")


def upsample_bwd(grad_out: torch.Tensor, ndim: int) -> torch.Tensor:
    """The gradient (N, C, *spatial / 2) of the x2 linear upsample, in
    grad_out's dtype. Plain version on the CPU; on CUDA tensors (bfloat16 or
    float32; any other device raises) one launch of the kernel ``plan``
    names."""
    _validate(grad_out, ndim)
    if grad_out.device.type == "cpu":
        return upsample_bwd_plain(grad_out, ndim)
    if not grad_out.is_cuda:
        raise ValueError(f"upsample_bwd runs on the CPU or a CUDA device, got {grad_out.device}")
    if grad_out.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"upsample_bwd takes bfloat16 or float32, got {grad_out.dtype}")
    g = grad_out.contiguous()
    n, c, *sp = g.shape
    sp = [s // 2 for s in sp]
    d, h, w = ([1] + sp) if ndim == 2 else sp
    gin = torch.empty((n, c, *sp), dtype=g.dtype, device=g.device)
    if gin.numel():
        p = plan(n * c, d, h, w, ndim == 3, g.element_size(), g.data_ptr() % 16 == 0)
        _launch(g, gin, p)
    return gin


def _launch(g: torch.Tensor, gin: torch.Tensor, p: Plan) -> None:
    """One launch of ``p``'s kernel from the contiguous gradient ``g`` into
    ``gin``, counted on ``upsample_bwd``; raises if it is refused."""
    planes = gin.shape[0] * gin.shape[1]
    d, h, w = ([1] + list(gin.shape[2:])) if gin.dim() == 4 else gin.shape[2:]
    args = (g.data_ptr(), gin.data_ptr(), planes, d, h, w, int(gin.dim() == 5),
            int(g.dtype == torch.bfloat16))
    stream = torch._C._cuda_getCurrentRawStream(g.device.index)
    with _build.on_device(g.device):
        if p.kernel == "tma":
            rc = _library().dpi_upsample_bwd_tma(*args, p.cfg, p.stages, p.span, stream)
        else:
            rc = _library().dpi_upsample_bwd_direct(*args, p.th, p.tw, p.span, stream)
    if rc != 0:
        raise RuntimeError(f"upsample_bwd {p.kernel} kernel launch failed: CUDA error {rc} "
                           f"(grad_out {tuple(g.shape)}, {p})")
    upsample_bwd.launches += 1
    if p.kernel == "tma":
        upsample_bwd.tma_launches += 1
    else:
        upsample_bwd.direct_launches += 1


upsample_bwd.launches = 0
upsample_bwd.tma_launches = 0
upsample_bwd.direct_launches = 0


class _LinearUpsample2x(torch.autograd.Function):
    """``F.interpolate`` forward; the gather backward of ``upsample_bwd``.
    Under ``torch.func.vmap`` the lanes fold into the batch dim, (B*N, C,
    *spatial): the upsample is per plane, so the one kernel launch of the
    backward covers all lanes' planes."""

    @staticmethod
    def forward(x):
        return F.interpolate(x, scale_factor=2, mode=_MODES[x.dim() - 2], align_corners=False)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.ndim = inputs[0].dim() - 2

    @staticmethod
    def backward(ctx, g):
        return upsample_bwd(g, ctx.ndim)

    @staticmethod
    def vmap(info, in_dims, x):
        x = x.movedim(in_dims[0], 0)
        y = _LinearUpsample2x.apply(x.reshape((-1,) + tuple(x.shape[2:])))
        return y.reshape(tuple(x.shape[:2]) + tuple(y.shape[1:])), 0


def linear_upsample2x(x: torch.Tensor) -> torch.Tensor:
    """The x2 half-pixel linear resize of an (N, C, H, W) or (N, C, D, H, W)
    tensor, with a deterministic backward; a list of spatial shards
    (``__torch_function__``) takes its own route."""
    if has_torch_function((x,)):
        return handle_torch_function(linear_upsample2x, (x,), x)
    if x.dim() - 2 not in _MODES:
        raise ValueError(f"linear_upsample2x takes 2 or 3 spatial dims, got {tuple(x.shape)}")
    return _LinearUpsample2x.apply(x)
