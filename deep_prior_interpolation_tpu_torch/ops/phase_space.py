"""Phase-space (space-to-depth) execution of same-pad convs, channels-first.

Counterpart of ``ops/phase_space.py``. Blocking the B = 2^d spatial phases
of a plain (N, C, *sp) tensor into its channels gives a phase tensor
(N, C*B, *sp/2) on which every same-pad conv of the plain tensor is an
exact conv with B times the channels on each side at half resolution. The
JAX package runs its small-channel levels so to fill the TPU's 128 matrix
lanes; the port runs the same net, so that one set of parameters gives the
same function in both.

Layout: channel-major, phase-minor. Channel ``c*B + lin(phi)`` of a phase
tensor holds the voxels of channel ``c`` at parity ``phi`` (one bit a
spatial dim, C order, the last dim fastest), so a channel concat of phase
tensors is the phase tensor of the concat, and a channel's statistics pool
B consecutive channels.

The identities, per dim (products of dims in N-D, all exact; ``p = (k-1)//2``):

* entry (plain -> phase), same-pad k: a stride-2 conv with kernel k+1 over
  the plain input padded by p, ``W4[(n, psi), c, rho] = W[n, c, rho - psi]``;
* interior (phase -> phase): a stride-1 conv with kernel 2S+1, S = (p+1)//2,
  and zero padding (S, S) over the phase tensor,
  ``W'[(n, psi), (c, phi), s] = W[n, c, 2s + phi - psi + p]``;
* stride-2 exit (phase -> plain, half resolution): a stride-1 conv with
  kernel ceil(p/2) + p//2 + 1 and padding (ceil(p/2), p//2),
  ``W''[n, (c, phi), s] = W[n, c, 2s + phi + p]``;
* a x2 upsample from half resolution into phase layout: nearest is a
  channel repeat, linear a separable edge-clamped 2-tap stencil (weights
  1/4, 3/4: half-pixel centres).

The kernel transforms select entries of the net's own weight by tables made
with numpy once, and run as one product with a constant 0/1 selection
matrix. Each entry of the phase weight is one entry of the weight or zero,
so the product is exact; its backward, which carries the phase weight's
gradient (from the wgrad kernel, for a phase conv) back to the net's
weight, is a product too and sums in a fixed order, where the backward of
an indexed gather would add with atomics on a card and break an exact
resume. The product runs in the weight's dtype: a float32 net needs TF32
off for it, as the solver sets.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
from torch.overrides import handle_torch_function, has_torch_function

__all__ = [
    "space_to_depth", "depth_to_space", "phase_pad", "phase_kernel",
    "phase_paddings", "entry_kernel", "conv_dimension_numbers",
    "phase_entry_conv", "phase_conv", "phase_exit_conv",
    "upsample_into_phase", "phase_channels",
]


def conv_dimension_numbers(d: int) -> Tuple[str, str, str]:
    """The layouts of activation, kernel and output: PyTorch's channels-first
    ones (the JAX package's channels-last ``N...C``, ``...IO``, ``N...C``)."""
    sp = "DHW"[-d:] if d <= 3 else "".join(chr(ord("A") + i) for i in range(d))
    return (f"NC{sp}", f"OI{sp}", f"NC{sp}")


def phase_channels(c_phase: int, d: int) -> int:
    """Original channel count of a phase tensor with ``c_phase`` channels."""
    return c_phase // 2 ** d


# ----------------------------------------------------------------------
# layout transforms (at the boundaries of the phased levels)
# ----------------------------------------------------------------------

def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(N, C, D1..Dd) -> (N, C*2^d, D1/2..Dd/2), channel-major."""
    if has_torch_function((x,)):
        return handle_torch_function(space_to_depth, (x,), x)
    n, c, *sp = x.shape
    d = len(sp)
    shp = [n, c]
    for s in sp:
        shp += [s // 2, 2]
    perm = [0, 1] + [3 + 2 * i for i in range(d)] + [2 + 2 * i for i in range(d)]
    return x.reshape(shp).permute(perm).reshape([n, c * 2 ** d] + [s // 2 for s in sp])


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    if has_torch_function((x,)):
        return handle_torch_function(depth_to_space, (x,), x)
    n, cb, *sp = x.shape
    d = len(sp)
    c = cb // 2 ** d
    perm = [0, 1]
    for i in range(d):
        perm += [2 + d + i, 2 + i]
    return x.reshape([n, c] + [2] * d + sp).permute(perm).reshape(
        [n, c] + [2 * s for s in sp])


def _zeros_cat(t: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    """``t`` with ``lo`` zeros before and ``hi`` after along ``axis``."""
    parts = []
    for m in (lo, hi):
        shp = list(t.shape)
        shp[axis] = m
        parts.append(t.new_zeros(shp))
    return torch.cat([parts[0], t, parts[1]], dim=axis)


def phase_pad(x: torch.Tensor) -> torch.Tensor:
    """Re-phase a phase tensor as if the plain tensor were zero-padded by 1:
    per dim the two phases swap, one of them shifted by one."""
    n, cb, *sp = x.shape
    d = len(sp)
    c = cb // 2 ** d
    x = x.reshape([n, c] + [2] * d + sp)
    for i in range(d):
        pax, ax = 2 + i, 2 + d + i
        hi = x.narrow(pax, 1, 1)
        lo = x.narrow(pax, 0, 1)
        # new phi = 0: the old phi = 1 shifted by one; new phi = 1: the old
        # phi = 0, a zero at the end
        x = torch.cat([_zeros_cat(hi, ax, 1, 0), _zeros_cat(lo, ax, 0, 1)], dim=pax)
    return x.reshape([n, cb] + [s + 1 for s in sp])


# ----------------------------------------------------------------------
# weight transforms: constant 0/1 selections, tables from numpy
# ----------------------------------------------------------------------

def _grid(n: int, d: int, lo: int = 0) -> np.ndarray:
    """All points of {lo..lo+n-1}^d, (n^d, d), C order."""
    return np.stack(np.meshgrid(*[np.arange(n) + lo] * d, indexing="ij"), -1).reshape(-1, d)


@functools.lru_cache(maxsize=None)
def _table(kind: str, k: int, d: int) -> np.ndarray:
    """For each entry of the transformed kernel, in the order of the
    selection product's output axes, the flat tap of ``w`` it takes, or -1
    for a zero:

    * "phase": axes (psi, phi, s), ``t = 2s + phi - psi + p``;
    * "exit": axes (phi, s), ``t = 2s + phi + p``;
    * "entry": axes (psi, rho), ``t = rho - psi``."""
    p = (k - 1) // 2
    phi = _grid(2, d)
    if kind == "phase":
        lo = (p + 1) // 2
        s = _grid(2 * lo + 1, d, -lo)
        t = (2 * s[None, None] + phi[None, :, None] - phi[:, None, None]) + p
    elif kind == "exit":
        lo, hi = -(-p // 2), p // 2
        s = _grid(lo + hi + 1, d, -lo)
        t = 2 * s[None] + phi[:, None] + p
    else:
        rho = _grid(k + 1, d)
        t = rho[None] - phi[:, None]
    valid = ((t >= 0) & (t < k)).all(-1)
    flat = np.ravel_multi_index(tuple(np.clip(t, 0, k - 1)[..., i] for i in range(d)),
                                (k,) * d)
    return np.where(valid, flat, -1).reshape(-1)


@functools.lru_cache(maxsize=None)
def _selection(kind: str, k: int, d: int, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """The 0/1 matrix (k^d, entries) of :func:`_table`."""
    table = _table(kind, k, d)
    sel = np.zeros((k ** d, table.size), np.float32)
    hit = np.nonzero(table >= 0)[0]
    sel[table[hit], hit] = 1.0
    return torch.from_numpy(sel).to(device=device, dtype=dtype)


def _select(w: torch.Tensor, kind: str) -> torch.Tensor:
    """(O, I, k^d) @ selection: (O, I, <the table's axes flattened>)."""
    o, i, k = w.shape[0], w.shape[1], w.shape[2]
    d = w.ndim - 2
    sel = _selection(kind, k, d, w.dtype, w.device)
    return torch.matmul(w.reshape(o * i, k ** d), sel).reshape(o, i, -1)


def phase_paddings(k: int, stride: int = 1) -> Tuple[int, int]:
    """(lo, hi) spatial zero padding of the conv with :func:`phase_kernel`."""
    p = (k - 1) // 2
    if stride == 1:
        lo = hi = (p + 1) // 2
        return lo, hi
    return -(-p // 2), p // 2


def phase_kernel(w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """(O, I, k^d) -> the kernel over the raw phase tensor (the phase swap
    lives in its zero pattern, with the padding of :func:`phase_paddings`).

    stride 1 -> (O*B, I*B, ks^d), ks = 2*((p+1)//2) + 1:
    ``y[psi] = sum_{s, phi} W[2s + phi - psi + p] x[q + s, phi]``.
    stride 2 -> (O, I*B, ke^d), ke = ceil(p/2) + p//2 + 1, the phase ->
    plain exit on the stride-2 grid: ``y[m] = sum_{s, phi} W[2s + phi + p]
    x[m + s, phi]``."""
    o, i, k = w.shape[0], w.shape[1], w.shape[2]
    d = w.ndim - 2
    b = 2 ** d
    lo, hi = phase_paddings(k, stride)
    ks = lo + hi + 1
    if stride == 1:
        m = _select(w, "phase").reshape(o, i, b, b, ks ** d)   # (O, I, psi, phi, s)
        return m.permute(0, 2, 1, 3, 4).reshape((o * b, i * b) + (ks,) * d)
    return _select(w, "exit").reshape((o, i * b) + (ks,) * d)   # (O, (I, phi), s)


def entry_kernel(w: torch.Tensor) -> torch.Tensor:
    """(O, I, k^d) -> (O*B, I, (k+1)^d): the stride-2 kernel whose output
    is the phase tensor of the same-pad conv of the plain input padded by p."""
    o, i, k = w.shape[0], w.shape[1], w.shape[2]
    d = w.ndim - 2
    b = 2 ** d
    m = _select(w, "entry").reshape(o, i, b, (k + 1) ** d)      # (O, I, psi, rho)
    return m.permute(0, 2, 1, 3).reshape((o * b, i) + (k + 1,) * d)


# ----------------------------------------------------------------------
# the convs: x plain (N, C, *sp) or phase (N, C*B, *sp/2)
# ----------------------------------------------------------------------

def phase_entry_conv(x: torch.Tensor, w: torch.Tensor, depth: int = 1) -> torch.Tensor:
    """Same-pad stride-1 conv, plain input -> phase output. ``depth > 1``
    blocks deeper (channels x 2^(d*depth) at 1/2^depth resolution): the
    entry conv gives depth 1, :func:`space_to_depth` each further level."""
    from .conv_vjp import conv_same
    p = (w.shape[2] - 1) // 2
    y = conv_same(x, entry_kernel(w), 2, p)
    for _ in range(depth - 1):
        y = space_to_depth(y)
    return y


def phase_conv(x: torch.Tensor, w: torch.Tensor, depth: int = 1) -> torch.Tensor:
    """Same-pad stride-1 conv, phase input -> phase output: a plain conv
    with the swap-folded kernel. ``depth > 1`` folds the kernel ``depth``
    times, for a ``depth``-blocked tensor; ``depth == 0`` is the plain
    same-pad conv of a plain tensor."""
    from .conv_vjp import conv_same
    d = w.ndim - 2
    wk, k = w, w.shape[2]
    if depth == 0:
        p = (k - 1) // 2
        return conv_same(x, w, 1, ((p, p),) * d)
    for _ in range(depth):
        wk, k_prev = phase_kernel(wk, 1), k
        k = 2 * (((k - 1) // 2 + 1) // 2) + 1
    return conv_same(x, wk, 1, (phase_paddings(k_prev, 1),) * d)


def phase_exit_conv(x: torch.Tensor, w: torch.Tensor, depth: int = 1) -> torch.Tensor:
    """Same-pad stride-2 conv, phase input -> plain output at half
    resolution. ``depth > 1`` unblocks to depth 1 first
    (:func:`depth_to_space`), then takes the stride-2 exit."""
    from .conv_vjp import conv_same
    d = w.ndim - 2
    for _ in range(depth - 1):
        x = depth_to_space(x)
    return conv_same(x, phase_kernel(w, 2), 1, (phase_paddings(w.shape[2], 2),) * d)


# ----------------------------------------------------------------------
# upsampling into phase space (plain half resolution -> phase)
# ----------------------------------------------------------------------

def _shifted(y: torch.Tensor, axis: int, step: int) -> torch.Tensor:
    """``y`` moved by one along ``axis`` with its edge sample repeated
    (``step`` -1: each sample's predecessor; +1: its successor). A cat of
    slices: its backward is slices and adds, no atomics."""
    n = y.shape[axis]
    if step < 0:
        return torch.cat([y.narrow(axis, 0, 1), y.narrow(axis, 0, n - 1)], dim=axis)
    return torch.cat([y.narrow(axis, 1, n - 1), y.narrow(axis, n - 1, 1)], dim=axis)


def upsample_into_phase(x: torch.Tensor, mode: str = "nearest") -> torch.Tensor:
    """x2 upsample of a plain (N, C, *sp) tensor whose output is the phase
    tensor (N, C*2^d, *sp) of the upsampled one: 'nearest' repeats each
    channel 2^d times; 'linear' is the half-pixel-centre linear resize, a
    separable edge-clamped 2-tap stencil (1/4, 3/4) a dim."""
    if has_torch_function((x,)):
        return handle_torch_function(upsample_into_phase, (x,), x, mode)
    n, c, *sp = x.shape
    d = len(sp)
    b = 2 ** d
    if mode == "nearest":
        return x.unsqueeze(2).expand([n, c, b] + sp).reshape([n, c * b] + sp)
    y = x
    for i in range(d):
        ax = 2 + 2 * i          # spatial dim i, behind the i phase axes made so far
        lo = 0.25 * _shifted(y, ax, -1) + 0.75 * y      # psi_i = 0: q - 1/4
        hi = 0.75 * y + 0.25 * _shifted(y, ax, 1)       # psi_i = 1: q + 1/4
        # each new phase axis behind the earlier ones: channel-major,
        # psi C-order, after the flatten
        y = torch.stack([lo, hi], dim=2 + i)
    return y.reshape([n, c * b] + sp).to(x.dtype)

