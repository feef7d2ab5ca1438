"""Fused masked-loss + metrics reduction and its gradient: CUDA kernels for
sm_90a and their plain versions.

Replaces the Pallas TPU kernel ``deep_prior_interpolation_tpu/ops/pallas_kernels.py``
(``_metrics_kernel`` reached through ``_fused_sums``) and the one pass that
XLA fuses its plain backward ``_loss_sums_bwd`` into. With ``d = (o-t)*m``
one pass over ``out`` (o), ``img`` (t) and ``mask`` (m) yields eight float32
sums: sum|d|, sum d^2, sum t^2, sum (t-o)^2, sum t, sum o, sum o^2, sum t*o.
``fused_loss_metrics`` combines them into mae, mse, snr and pcorr exactly as
the JAX package does (one-pass covariance included), through
``metrics_from_sums``, which a spatially sharded step applies to the sums of
its shards.

Both kernels are in ``csrc/fused_loss.cu``, with their design and what bounds
them on an H100 (bytes); ``ops/_build.py`` compiles it with ``nvcc`` at first
use. The forward is one launch that ends in the 8 sums, bit-identical from
call to call; the backward one elementwise pass that computes the gradient
in float32 and rounds it once to ``out``'s dtype, as the JAX package does.

``fused_sums`` and ``loss_sums_grad`` take their plain versions for tensors
on the CPU and launch the kernels for CUDA tensors (any other device raises);
``fused_sums.launches`` and ``loss_sums_grad.launches`` count the launches.

``fused_sums_lanes`` and ``loss_sums_grad_lanes`` are the same for B lanes
at once, the counterpart of the batching rule of ``pallas_call`` under
``jax.vmap``: inputs (B, ...) give (B, 8) sums in one launch, and the
gradient of all B lanes from (B, 8) incoming gradients in one launch, each
lane bit-identical to a one-lane launch on its inputs (their own counters).
Under ``torch.func.vmap``, ``fused_loss_metrics`` reaches them through the
vmap rule of its autograd function.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from . import _build

__all__ = ["fused_loss_metrics", "fused_loss_sums", "fused_sums", "fused_sums_lanes", "fused_sums_lanes_plain",
           "fused_sums_plain", "loss_sums_grad", "loss_sums_grad_lanes",
           "loss_sums_grad_lanes_plain", "loss_sums_grad_plain", "metrics_from_sums"]

_FORWARD, _BACKWARD = 0, 1


def fused_sums_plain(out: torch.Tensor, img: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """The eight float32 sums as plain tensor code."""
    o, t, m = out.float(), img.float(), mask.float()
    d = (o - t) * m
    r = t - o
    return torch.stack([d.abs().sum(), (d * d).sum(), (t * t).sum(),
                        (r * r).sum(), t.sum(), o.sum(), (o * o).sum(),
                        (t * o).sum()])


def loss_sums_grad_plain(out: torch.Tensor, img: torch.Tensor, mask: torch.Tensor,
                         g: torch.Tensor) -> torch.Tensor:
    """d/d_out of ``g . fused_sums(out, img, mask)`` as plain tensor code, in
    float32 and then rounded to out's dtype (the JAX package's
    ``_loss_sums_bwd``)."""
    o, t, m = out.float(), img.float(), mask.float()
    d = (o - t) * m
    # d/d_out of each sum that depends on out:
    #   s0 = sum|d|      -> sign(d) * mask
    #   s1 = sum d^2     -> 2 d mask
    #   s3 = sum (t-o)^2 -> -2 (t-o)
    #   s5 = sum o       -> 1
    #   s6 = sum o^2     -> 2 o
    #   s7 = sum t o     -> t
    grad = (g[0] * torch.sign(d) * m
            + g[1] * 2.0 * d * m
            + g[3] * (-2.0) * (t - o)
            + g[5] * torch.ones_like(d)
            + g[6] * 2.0 * o
            + g[7] * t)
    return grad.to(out.dtype)


def fused_sums_lanes_plain(out: torch.Tensor, img: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """The eight float32 sums of each lane (dim 0), (B, 8), as plain tensor
    code."""
    o, t, m = (v.float().flatten(1) for v in (out, img, mask))
    d = (o - t) * m
    r = t - o
    return torch.stack([d.abs().sum(1), (d * d).sum(1), (t * t).sum(1), (r * r).sum(1),
                        t.sum(1), o.sum(1), (o * o).sum(1), (t * o).sum(1)], dim=1)


def loss_sums_grad_lanes_plain(out: torch.Tensor, img: torch.Tensor, mask: torch.Tensor,
                               g: torch.Tensor) -> torch.Tensor:
    """d/d_out of each lane's ``g[b] . fused_sums(out[b], ...)``, g (B, 8),
    as plain tensor code: ``loss_sums_grad_plain`` with g's columns
    broadcast over each lane."""
    return loss_sums_grad_plain(out, img, mask,
                                g.float().t().reshape((8, -1) + (1,) * (out.dim() - 1)))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library("fused_loss")
    # without argtypes ctypes would pass each pointer as a 32-bit int
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dpi_loss_blocks.argtypes = [i, i, ctypes.POINTER(i)]
    lib.dpi_loss_sums.argtypes = [p, p, p, ll, i, i, i, p, p, p, p]
    lib.dpi_loss_sums_grad.argtypes = [p, p, p, p, p, ll, i, i, i, p]
    for fn in (lib.dpi_loss_blocks, lib.dpi_loss_sums, lib.dpi_loss_sums_grad):
        fn.restype = i
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")


@functools.cache
def _blocks(device: int, which: int, bf16: bool) -> int:
    """Blocks of a kernel that fit on the card at once: its persistent grid."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        _check(_library().dpi_loss_blocks(which, int(bf16), ctypes.byref(n)),
               "the fused loss occupancy query")
    return n.value


@functools.cache
def _scratch(device: int, stream: int, lanes: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward's workspace (8 floats a block of the largest grid, for
    each lane) and its ticket counters (one a lane), zeroed once; the kernel
    leaves them at zero. One pair for each stream and lane count, so
    launches that may overlap never share one."""
    blocks = max(_blocks(device, _FORWARD, bf16) for bf16 in (False, True))
    dev = torch.device("cuda", device)
    return (torch.empty(lanes * blocks * 8, dtype=torch.float32, device=dev),
            torch.zeros(lanes, dtype=torch.int32, device=dev))


def _cuda_inputs(name: str, out: torch.Tensor, img: torch.Tensor, mask: torch.Tensor):
    """The contiguous inputs of a launch, after the checks the kernels need:
    one CUDA device, bfloat16 or float32 ``out``, float32 ``img`` and
    ``mask``."""
    if not out.is_cuda or not (img.device == mask.device == out.device):
        raise ValueError(f"{name} needs all inputs on one CUDA device, got "
                         f"{out.device}, {img.device}, {mask.device}")
    if out.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes a float32 or bfloat16 out, got {out.dtype}")
    if img.dtype != torch.float32 or mask.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 img and mask, got {img.dtype}, {mask.dtype}")
    return tuple(v if v.is_contiguous() else v.contiguous() for v in (out, img, mask))


def _check_shapes(out: torch.Tensor, img: torch.Tensor, mask: torch.Tensor) -> None:
    if not (out.shape == img.shape == mask.shape):
        raise ValueError(f"shape mismatch: {out.shape} {img.shape} {mask.shape}")


def _sums_launch(name: str, out: torch.Tensor, img: torch.Tensor, mask: torch.Tensor,
                 lanes: int) -> torch.Tensor:
    """One launch of the forward over ``lanes`` lanes: (lanes, 8) sums."""
    o, t, m = _cuda_inputs(name, out, img, mask)
    dev = o.device.index
    bf16 = o.dtype == torch.bfloat16
    stream = torch._C._cuda_getCurrentRawStream(dev)
    ws, ticket = _scratch(dev, stream, lanes)
    sums = torch.empty((lanes, 8), dtype=torch.float32, device=o.device)
    with _build.on_device(o.device):
        _check(_library().dpi_loss_sums(
            o.data_ptr(), t.data_ptr(), m.data_ptr(), o.numel() // lanes, lanes, int(bf16),
            _blocks(dev, _FORWARD, bf16), ws.data_ptr(), ticket.data_ptr(), sums.data_ptr(),
            stream), "the fused loss kernel launch")
    return sums


def _grad_launch(name: str, out: torch.Tensor, img: torch.Tensor, mask: torch.Tensor,
                 g: torch.Tensor, lanes: int) -> torch.Tensor:
    """One launch of the backward over ``lanes`` lanes, g (lanes x 8)."""
    o, t, m = _cuda_inputs(name, out, img, mask)
    if g.device != o.device or g.dtype != torch.float32:
        raise ValueError(f"{name} takes float32 g on {o.device}, got "
                         f"{g.dtype} on {g.device}")
    g = g.contiguous()
    dev = o.device.index
    bf16 = o.dtype == torch.bfloat16
    grad = torch.empty(out.shape, dtype=o.dtype, device=o.device)
    with _build.on_device(o.device):
        _check(_library().dpi_loss_sums_grad(
            o.data_ptr(), t.data_ptr(), m.data_ptr(), g.data_ptr(), grad.data_ptr(),
            o.numel() // lanes, lanes, int(bf16), _blocks(dev, _BACKWARD, bf16),
            torch._C._cuda_getCurrentRawStream(dev)), "the fused loss gradient kernel launch")
    return grad


def fused_sums(out: torch.Tensor, img: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """The eight float32 sums, shape (8,). Plain version on the CPU; one
    launch of the CUDA kernel on CUDA tensors (any other device raises)."""
    _check_shapes(out, img, mask)
    if out.device.type == "cpu":
        return fused_sums_plain(out, img, mask)
    sums = _sums_launch("fused_sums", out, img, mask, 1)[0]
    fused_sums.launches += 1
    return sums


fused_sums.launches = 0


def loss_sums_grad(out: torch.Tensor, img: torch.Tensor, mask: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """d/d_out of ``g . fused_sums(out, img, mask)`` in out's dtype and shape.
    Plain version on the CPU; one launch of the CUDA kernel on CUDA tensors
    (``g`` then on the same device; any other device raises)."""
    _check_shapes(out, img, mask)
    if g.numel() != 8:
        raise ValueError(f"loss_sums_grad takes the 8 gradients of the sums, got {g.numel()}")
    if out.device.type == "cpu":
        return loss_sums_grad_plain(out, img, mask, g)
    grad = _grad_launch("loss_sums_grad", out, img, mask, g, 1)
    loss_sums_grad.launches += 1
    return grad


loss_sums_grad.launches = 0


def _check_lanes(name: str, out: torch.Tensor, img: torch.Tensor, mask: torch.Tensor) -> None:
    _check_shapes(out, img, mask)
    if out.dim() < 2 or out.shape[0] < 1:
        raise ValueError(f"{name} takes (B, ...) tensors of B >= 1 lanes, got "
                         f"{tuple(out.shape)}")


def fused_sums_lanes(out: torch.Tensor, img: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """The eight float32 sums of each of the B lanes of (B, ...) inputs,
    shape (B, 8). Plain version on the CPU; one launch of the CUDA kernel
    on CUDA tensors."""
    _check_lanes("fused_sums_lanes", out, img, mask)
    if out.device.type == "cpu":
        return fused_sums_lanes_plain(out, img, mask)
    sums = _sums_launch("fused_sums_lanes", out, img, mask, out.shape[0])
    fused_sums_lanes.launches += 1
    return sums


fused_sums_lanes.launches = 0


def loss_sums_grad_lanes(out: torch.Tensor, img: torch.Tensor, mask: torch.Tensor,
                         g: torch.Tensor) -> torch.Tensor:
    """d/d_out of each lane's ``g[b] . fused_sums(out[b], img[b], mask[b])``,
    g (B, 8), in out's dtype and shape. Plain version on the CPU; one launch
    of the CUDA kernel on CUDA tensors."""
    _check_lanes("loss_sums_grad_lanes", out, img, mask)
    if tuple(g.shape) != (out.shape[0], 8):
        raise ValueError(f"loss_sums_grad_lanes takes (B, 8) gradients, got {tuple(g.shape)}")
    if out.device.type == "cpu":
        return loss_sums_grad_lanes_plain(out, img, mask, g)
    grad = _grad_launch("loss_sums_grad_lanes", out, img, mask, g, out.shape[0])
    loss_sums_grad_lanes.launches += 1
    return grad


loss_sums_grad_lanes.launches = 0


def _lane_first(t: torch.Tensor, dim: Optional[int], size: int) -> torch.Tensor:
    """A vmapped input with its lane dim first (an unbatched one repeated)."""
    return t.movedim(dim, 0) if dim is not None else t.expand((size,) + tuple(t.shape))


class _LossSums(torch.autograd.Function):
    """The eight sums with the analytic elementwise gradient in ``out``;
    under ``torch.func.vmap`` the lane-batched pair."""

    @staticmethod
    def forward(out, img, mask):
        return fused_sums(out, img, mask)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        out, img, mask = ctx.saved_tensors
        return loss_sums_grad(out, img, mask, g), None, None

    @staticmethod
    def vmap(info, in_dims, out, img, mask):
        b = info.batch_size
        return _LossSumsLanes.apply(*(_lane_first(v, d, b)
                                      for v, d in zip((out, img, mask), in_dims))), 0


class _LossSumsLanes(torch.autograd.Function):
    """(B, 8) sums of B lanes with the gradient in ``out``, one launch each."""

    @staticmethod
    def forward(ctx, out, img, mask):
        ctx.save_for_backward(out, img, mask)
        return fused_sums_lanes(out, img, mask)

    @staticmethod
    def backward(ctx, g):
        out, img, mask = ctx.saved_tensors
        return loss_sums_grad_lanes(out, img, mask, g), None, None


def fused_loss_sums(out: torch.Tensor, img: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The eight sums (``fused_sums``), differentiable in ``out`` through the
    gradient kernel; ``img`` and ``mask`` are data."""
    return _LossSums.apply(out, img, mask)


def metrics_from_sums(s: torch.Tensor, n: float, loss: str = "mae"
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {'snr', 'pcorr', 'mae', 'mse'}) from the eight sums ``s`` over
    ``n`` elements, as the JAX package combines them (one-pass covariance)."""
    mae_v = s[0] / n
    mse_v = s[1] / n
    snr_v = 10.0 * torch.log10(s[2] / s[3])
    mean_t = s[4] / n
    mean_o = s[5] / n
    cov = s[7] / n - mean_t * mean_o
    var_t = s[2] / n - mean_t * mean_t
    var_o = s[6] / n - mean_o * mean_o
    pcorr_v = cov / torch.sqrt(var_t * var_o)
    loss_v = mae_v if loss in ("mae", "l1") else mse_v
    return loss_v, {"snr": snr_v, "pcorr": pcorr_v, "mae": mae_v, "mse": mse_v}


def fused_loss_metrics(out: torch.Tensor, img: torch.Tensor, mask: torch.Tensor,
                       loss: str = "mae") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {'snr', 'pcorr', 'mae', 'mse'}) from one pass over the inputs.

    Differentiable in ``out``; ``img`` and ``mask`` are data.
    """
    return metrics_from_sums(fused_loss_sums(out, img, mask), float(out.numel()), loss)
