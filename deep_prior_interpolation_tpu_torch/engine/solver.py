"""The DIP solver: per-patch optimisation (counterpart of ``engine/solver.py``).

The optimisation of a net on one patch *is* the inference. Each step:

  * adds fresh input noise ``reg_noise_std * N(0, 1)`` to the canvas, and
    with ``data_forgetting_factor`` f the decimated data, tiled to the input
    depth and std-matched, weighted by a 1 -> 1e-4 ramp for f iterations;
  * with ``param_noise`` perturbs every conv kernel (rank >= 4) by
    ``N(0, 1) * std(kernel) * 0.02`` (population std); the gradient is
    taken and the update applied at the perturbed parameters, so the noise
    stays in them, except where ``done`` keeps the unperturbed ones;
  * runs the net forward (with the sampling mask, for a net that takes it;
    with dropout drawn from its own generator; every conv as a sum of
    per-tap products under ``vmap_conv_mode="tapmm"``) and crops the
    padding away;
  * computes the masked loss and the SNR / Pearson metrics in float32, from
    the fused loss kernel when ``fused_loss`` (``ops/fused_loss.py``) and
    from ``ops/losses.py`` otherwise;
  * applies Adam written as tensor ops, exactly ``optax.scale_by_adam(0.9,
    0.999, 1e-8)`` followed by ``p - lr * d``, on one flat float32 buffer
    that all the net's parameters view, and with ``opt_over="net,input"``
    on the canvas too, a leaf of its own with its own moments;
  * tracks the best output with ``<=``, ReduceLROnPlateau (relative
    threshold; the cut only when ``lr - new_lr > 1e-8``) and EarlyStopping
    (percentage min-delta, NaN abort, reset at ``it == 0``);
  * sets the ``done`` flag, which freezes params, Adam state and trackers.

With ``pocs`` the loss gains the POCS term (``pocs_term``); with
``save_every`` the last output is tracked and snapshot at every multiple of
``save_every``; with ``checkpoint_path`` the whole state is saved every
``checkpoint_every`` chunks and a later ``solve`` resumes from it exactly,
also in another process: the solve then runs with deterministic cuDNN (the
flag is set back afterwards), and the checkpoint carries the wgrad kernel's
tuned grids, which the resume pins before its first step.

The canvas is drawn from a generator of its own, seeded from ``seed``, and
shaped along the first spatial axis by a Butterworth low-pass
(``lowpass_fs``, ``lowpass_fc``). ``virtual_input`` draws it again from that
generator's first state every step instead of storing it, bit for bit the
stored canvas (not with input optimisation or shaping). The step noise,
the parameter noise and dropout draw from three more generators, seeded
from ``seed`` too; a checkpoint holds the state of each.

All of that state stays on the device as tensors. The host reads it once
per chunk: one copy of the chunk's metrics and the ``done`` flag, which is
also the chunk's synchronisation point.

The same step serves B patches at once (``parallel/mesh.py``), each lane
with its own parameters, Adam state, generators, trackers and ``done``
flag: the parameters are (B, *shape) leaves viewing one (B, P) buffer, the
net runs under ``torch.func.vmap`` over ``functional_call`` (its convs,
loss and upsamples through their vmap rules, which batch the kernels over
the lanes), every draw is made lane by lane from that lane's generators,
and every tracker is a (B,) tensor. Lane i computes what a solve with seed
``cfg.seed + i`` computes, but for the rounding of the batched ops. And it
serves one patch split along a spatial axis over several shards
(``spatial_mesh``, ``parallel/spatial.py``): the net walked over the
shards, the canvas, data and outputs split, everything else whole, each
draw made whole and split, and the POCS term taken on the gathered
output.

Where the JAX package refuses a configuration the port raises the same
error class: under ``dtype="bfloat16"`` input optimisation, and a net output
that is not bfloat16 (data forgetting, the partial-conv U-Net), raise
``TypeError``. Features the port does not serve yet raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from torch.func import functional_call, vmap

from ..config import Config
from ..io import checkpoint as ckpt_io
from ..models import get_net, init_weights, set_dropout_generator
from ..ops import losses as L
from ..ops import wgrad as wgrad_ops
from ..ops.conv_vjp import conv_impl
from ..ops.filters import convolve_kernel_1d, lowpass_butterworth_taps
from ..ops.fused_loss import fused_loss_metrics
from ..ops.noise import build_forgetting_data, data_forgetting_weights, get_noise
from ..ops.pocs import fk_projection
from ..utils.generic import nextpow2
from .history import History, HistoryPOCS

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


@dataclass(frozen=True)
class StepSettings:
    """Static structure of the step (the JAX package's jit cache key, cut to
    what the ported step reads)."""
    loss: str = "mae"
    reg_noise_std: float = 0.03
    param_noise: bool = False
    forget_factor: int = 0
    orig_spatial: Tuple[int, ...] = ()
    fused_loss: bool = False
    pocs: bool = False
    pocs_adaptive: bool = True  # eps = main / reg, else the fixed pocs_weight
    # eps attached to the graph: eps * reg equals main as a function, so the
    # term doubles main's gradient (the reference code as it ran); detached,
    # eps is a constant weight each iteration (the default)
    pocs_eps_attached: bool = False
    track_last: bool = False  # keep the last output (snapshots)
    takes_mask: bool = False  # the net takes (x, mask)
    opt_input: bool = False   # optimise the canvas with the net
    # draw the canvas again every step instead of storing it: only for a raw
    # noise canvas (no shaping, no input optimisation)
    virtual_input: bool = False
    input_shape: Tuple[int, ...] = ()  # (1, inputdepth, *padded)
    # the conv formulation of the step (ops/conv_vjp.py conv_impl): "conv"
    # (cuDNN) or "tapmm" (a float32 matrix product a kernel tap)
    conv_mode: str = "conv"

    @classmethod
    def from_config(cls, cfg: Config, orig_spatial: Tuple[int, ...],
                    takes_mask: bool = False,
                    input_shape: Tuple[int, ...] = ()) -> "StepSettings":
        opt_input = "input" in cfg.opt_over.split(",")
        shaped = bool(cfg.filter_noise_with_wavelet or (cfg.lowpass_fs and cfg.lowpass_fc)
                      or cfg.data_forgetting_factor)
        return cls(loss=cfg.loss, reg_noise_std=cfg.reg_noise_std,
                   param_noise=cfg.param_noise, forget_factor=cfg.data_forgetting_factor,
                   orig_spatial=tuple(orig_spatial),
                   fused_loss=(cfg.fused_loss
                               and cfg.loss in ("mae", "l1", "mse")),
                   pocs=cfg.pocs, pocs_adaptive=cfg.pocs_weight is None,
                   pocs_eps_attached=cfg.pocs_eps_mode == "attached",
                   track_last=cfg.save_every is not None, takes_mask=takes_mask,
                   opt_input=opt_input,
                   virtual_input=cfg.virtual_input and not opt_input and not shaped,
                   input_shape=tuple(input_shape),
                   conv_mode="tapmm" if cfg.vmap_conv_mode == "tapmm" else "conv")


def build_hyper(cfg: Config, device: torch.device) -> Dict[str, Any]:
    """Scalar hyperparameters of the step, as device tensors where the step
    does arithmetic with them."""
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "epochs": int(cfg.epochs),
        "reduce_lr": bool(cfg.reduce_lr),
        "lr_factor": torch.tensor(cfg.lr_factor, **f32),
        "lr_thresh": torch.tensor(cfg.lr_thresh, **f32),
        "lr_patience": int(cfg.lr_patience),
        "es_patience": int(cfg.earlystop_patience or cfg.epochs),
        "es_min_delta": torch.tensor(cfg.earlystop_min_delta, **f32),
        "pocs_thresh": torch.tensor(cfg.pocs_thresh, **f32),
        "pocs_weight": torch.tensor(cfg.pocs_weight if cfg.pocs_weight is not None
                                    else 0.0, **f32),
    }


def pad_multiple_for(cfg: Config) -> int:
    """What the padded spatial dims are multiples of: ``pad_multiple``, or
    what the net's levels need, with phase space what its phased levels
    need (resolution r at depth q: 2^(r+q))."""
    if cfg.pad_multiple and cfg.pad_multiple > 0:
        return cfg.pad_multiple
    mult = 2 ** (len(cfg.filters) - 1)
    if cfg.phase_space:
        levels = len(cfg.filters) if cfg.phase_levels < 0 else cfg.phase_levels
        mult = max(mult, 2 ** min(levels, len(cfg.filters)))
        if cfg.phase_deep_levels > 0:
            deep = min(cfg.phase_deep_levels, levels, len(cfg.filters))
            mult = max(mult, 2 ** (deep + 1))
    return mult


def padded_spatial(spatial: Tuple[int, ...], mult: int) -> Tuple[int, ...]:
    return tuple(int(math.ceil(d / mult)) * mult for d in spatial)


def _crop_center(x: torch.Tensor, spatial: Tuple[int, ...]) -> torch.Tensor:
    """Crop an (N, C, *padded) tensor back to the unpadded region."""
    slices = [slice(None), slice(None)]
    for dim, tgt in zip(x.shape[2:], spatial):
        d = (dim - tgt) // 2
        slices.append(slice(d, d + tgt))
    return x[tuple(slices)]


def _to_channels_first(a: np.ndarray, device, dtype=torch.float32) -> torch.Tensor:
    """(*spatial, C) numpy -> (1, C, *spatial) tensor."""
    t = torch.from_numpy(np.array(a, np.float32))
    return t.permute(t.ndim - 1, *range(t.ndim - 1))[None].contiguous().to(device, dtype)


def _to_channels_last(t: torch.Tensor) -> np.ndarray:
    """(1, C, *spatial) tensor -> (*spatial, C) float32 numpy."""
    a = t[0].detach().float().cpu()
    return a.permute(*range(1, a.ndim), 0).contiguous().numpy()


def build_base_input(cfg: Config, generator: torch.Generator,
                     padded: Tuple[int, ...], device,
                     wavelet: Optional[np.ndarray] = None) -> torch.Tensor:
    """The fixed input canvas (1, inputdepth, *padded): raw noise times
    ``noise_std``, stored in bfloat16 when the net computes in bfloat16.

    Optional shaping along the first spatial axis (dim 2): a ``wavelet``
    convolution (only with ``filter_noise_with_wavelet``; the solver, like
    the JAX package's, passes none) and the 4th-order Butterworth low-pass
    of ``lowpass_fc`` / ``lowpass_fs``, designed for ``nfft = 2 **
    nextpow2(padded[0])``."""
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    noise = get_noise(generator, (1, cfg.inputdepth) + tuple(padded),
                      cfg.noise_dist, dtype, device)
    inp = noise * cfg.noise_std
    if cfg.filter_noise_with_wavelet and wavelet is not None:
        inp = convolve_kernel_1d(inp, torch.as_tensor(wavelet).to(dtype), axis=2)
    if cfg.lowpass_fs and cfg.lowpass_fc:
        taps = lowpass_butterworth_taps(fc=cfg.lowpass_fc, fs=cfg.lowpass_fs,
                                        ntaps=cfg.lowpass_ntaps, order=4,
                                        nfft=2 ** nextpow2(padded[0]))
        inp = convolve_kernel_1d(inp, torch.as_tensor(taps).to(dtype), axis=2)
    return inp


def _pop_std(t: torch.Tensor) -> torch.Tensor:
    """``jnp.std``: population std (ddof 0), the variance rounded to the
    tensor's dtype before the square root."""
    return torch.sqrt(t.float().var(correction=0).to(t.dtype))


def _centre_pad(t: torch.Tensor, spatial: Tuple[int, ...]) -> torch.Tensor:
    """Zero-pad the spatial dims of an (N, C, *s) tensor, centred, to ``spatial``."""
    pads = []
    for dim, tgt in reversed(list(zip(t.shape[2:], spatial))):
        d = (tgt - dim) // 2
        pads += [d, tgt - dim - d]
    return torch.nn.functional.pad(t, pads)


def build_data(img: np.ndarray, mask: np.ndarray, base_input: Optional[torch.Tensor],
               device, pocs_alpha: Optional[float] = None, forget_factor: int = 0,
               net_mask_shape: Optional[Tuple[int, ...]] = None
               ) -> Dict[str, torch.Tensor]:
    """The per-patch tensors of the step: img/mask (1, C, *spatial) float32
    and the canvas (None when it is virtual); with ``pocs_alpha``, the POCS
    re-insertion weights ``alpha * img * mask`` and ``1 - alpha * mask``;
    with ``forget_factor``, the forgetting data (``img * mask`` tiled to the
    canvas's depth, scaled by ``std(canvas) / std(itself)``, centred on the
    canvas) and its ramp, with a 0 after it; with ``net_mask_shape`` (the
    canvas's shape), the mask tiled to its depth and centred on it, for a
    net that takes the mask."""
    data = {"img": _to_channels_first(img, device),
            "mask": _to_channels_first(mask, device),
            "base_input": base_input}
    if pocs_alpha is not None:
        data["pocs_wdata"] = pocs_alpha * (data["img"] * data["mask"])
        data["pocs_wmask"] = torch.ones_like(data["mask"]) - pocs_alpha * data["mask"]
    if forget_factor > 0:
        fd = build_forgetting_data(data["img"] * data["mask"], base_input.shape[1])
        fd = fd * (_pop_std(base_input) / _pop_std(fd))
        data["forget_data"] = _centre_pad(fd, tuple(base_input.shape[2:]))
        data["forget_w"] = torch.from_numpy(np.append(
            data_forgetting_weights(forget_factor), np.float32(0.0))).to(device)
    if net_mask_shape is not None:
        nm = build_forgetting_data(data["mask"], net_mask_shape[1])
        data["net_mask"] = _centre_pad(nm, tuple(net_mask_shape[2:]))
    return data


def extract_noise_canvas(s: StepSettings, st: Dict[str, Any], data,
                         regenerate, spatial: Tuple[int, ...]) -> np.ndarray:
    """The canvas as (*spatial, inputdepth) float32, the bundle's 'noise':
    the optimised one under input optimisation, drawn again under
    ``virtual_input``, else the stored one."""
    if s.opt_input:
        canvas = st["flat"].canvas
    elif s.virtual_input:
        canvas = regenerate()
    else:
        canvas = data["base_input"]
    return _to_channels_last(_crop_center(canvas.detach().float(), spatial))


def _lane(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-lane (B,) tensor shaped to broadcast against ``like`` (B, ...);
    a scalar (one lane) as it is."""
    return t if t.dim() == 0 else t.reshape(tuple(t.shape) + (1,) * (like.dim() - t.dim()))


def _where(cond: torch.Tensor, a, b):
    """``torch.where(cond, a, b)`` of one lane, of B lanes (``cond`` (B,)),
    or of the shards of a spatially sharded output (lists of shards,
    ``cond`` moved to each shard's device)."""
    if isinstance(a, list):
        return [torch.where(cond.to(x.device), x, y) for x, y in zip(a, b)]
    return torch.where(_lane(cond, a), a, b)


def _whole(st: Dict[str, Any], v):
    """A state entry as one tensor: a sharded one (a list of shards)
    gathered on the mesh's first device."""
    return st["spatial"].layout.gather(v) if isinstance(v, list) else v


def pocs_term(out: torch.Tensor, main: torch.Tensor, data, hyper,
              s: StepSettings):
    """``(total, reg, eps, th)``: the f-k projection of ``out`` (no gradient
    flows through it), ``reg = mse(out, proj)``, the weight ``eps`` (``main /
    reg``, or the fixed ``pocs_weight``) and ``total = main + eps * reg``."""
    with torch.no_grad():
        proj, th = fk_projection(out, data["pocs_wdata"], data["pocs_wmask"],
                                 hyper["pocs_thresh"], return_threshold=True)
    reg = L.mse(out, proj)
    if s.pocs_adaptive:
        eps = main / reg
        if not s.pocs_eps_attached:
            eps = eps.detach()
    else:
        eps = hyper["pocs_weight"].to(main.dtype)
    return main + eps * reg, reg, eps, th


def _with_pocs(out: torch.Tensor, main: torch.Tensor, ys: Dict[str, torch.Tensor], data,
               hyper, s: StepSettings) -> torch.Tensor:
    """The step's loss: ``main``, or with POCS ``main + eps * reg``
    (``pocs_term`` of the whole cropped output ``out``), whose terms (df,
    reg, eps, th) go into ``ys``."""
    if not s.pocs:
        return main
    loss, reg, eps, th = pocs_term(out, main, data, hyper, s)
    ys.update({"df": main.detach(), "reg": reg.detach(), "eps": eps.detach().float(),
               "th": th.float()})
    return loss


class _FlatParams:
    """The net's parameters as views into one float32 buffer, with Adam's
    moments beside it, so the update is a handful of large tensor ops. An
    optimised canvas is a leaf of its own beside it (its dtype, its own
    moments), sharing Adam's count, as ``optax.scale_by_adam`` keeps one
    count for its whole tree.

    With ``rows`` (B flat parameter vectors, one a lane) the buffer is
    (B, P) and the parameters are (B, *shape) leaves viewing it, by the
    model's names (``names``); the model's own parameters are left alone.
    The canvas is then (B, ...), the count (B,)."""

    def __init__(self, model: torch.nn.Module, canvas: Optional[torch.Tensor] = None,
                 rows: Optional[List[torch.Tensor]] = None):
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.lead: Tuple[int, ...] = () if rows is None else (len(rows),)
        with torch.no_grad():
            if rows is None:
                self.params = [p for _, p in named]
                self.flat = torch.cat([p.detach().reshape(-1) for p in self.params])
            else:
                self.flat = torch.stack(rows)
                self.params = []
            off = 0
            for _, p in named:
                n = p.numel()
                if rows is None:
                    p.data = self.flat[off:off + n].view_as(p)
                else:
                    self.params.append(self.flat[:, off:off + n].view(
                        self.lead + tuple(p.shape)).requires_grad_(True))
                off += n
        self._sizes = [p.numel() for _, p in named]
        self.mu = torch.zeros_like(self.flat)
        self.nu = torch.zeros_like(self.flat)
        self.count = torch.zeros(self.lead, dtype=torch.int32, device=self.flat.device)
        self.canvas = None
        if canvas is not None:
            self.canvas = canvas.detach().clone().requires_grad_(True)
            self.canvas_mu = torch.zeros_like(self.canvas, requires_grad=False)
            self.canvas_nu = torch.zeros_like(self.canvas, requires_grad=False)
        # the conv kernels (rank >= 4) that parameter noise perturbs: their
        # leaves, their flat positions and each leaf's size, made at the
        # first perturbation (the positions take 8 bytes a parameter)
        self._kernels = [i for i, (_, p) in enumerate(named) if p.ndim >= 4]
        self._kernel_idx = self._kernel_sizes = None

    def leaves(self) -> List[torch.Tensor]:
        """What the loss is differentiated by: the net's parameters, then
        the canvas when it is optimised."""
        return self.params + ([self.canvas] if self.canvas is not None else [])

    @torch.no_grad()
    def perturb(self, generator: Union[torch.Generator, List[torch.Generator]]) -> torch.Tensor:
        """Add ``N(0, 1) * std(kernel) * 0.02`` to every conv kernel, in
        place (population std of each kernel; with lanes, lane i's kernels
        from ``generator[i]``); returns the parameters as they were, which
        ``adam_step`` keeps where ``done``."""
        before = self.flat.clone()
        if self._kernel_idx is None:
            offs = np.cumsum([0] + self._sizes)
            dev = self.flat.device
            self._kernel_idx = torch.cat(
                [torch.arange(int(offs[i]), int(offs[i + 1]), device=dev)
                 for i in self._kernels] or [torch.zeros(0, dtype=torch.int64, device=dev)])
            self._kernel_sizes = torch.tensor([self._sizes[i] for i in self._kernels],
                                              dtype=torch.int64, device=dev)
        n = self._kernel_idx.numel()
        if not n:
            return before
        if self.lead:
            rows = [(self.flat[b], [p[b] for p in self.params], generator[b])
                    for b in range(self.lead[0])]
        else:
            rows = [(self.flat, self.params, generator)]
        for flat, params, gen in rows:
            stds = torch.stack([params[i].std(correction=0) for i in self._kernels])
            std = torch.repeat_interleave(stds, self._kernel_sizes, output_size=n)
            noise = torch.randn(n, generator=gen, device=self.flat.device)
            flat.index_add_(0, self._kernel_idx, noise * std * 0.02)
        return before

    @staticmethod
    def _adam(g, mu_old, nu_old, bc1, bc2):
        mu = (1 - _B1) * g + _B1 * mu_old
        nu = (1 - _B2) * (g ** 2) + _B2 * nu_old
        return mu, nu, (mu / bc1) / (torch.sqrt(nu / bc2) + _EPS)

    @torch.no_grad()
    def adam_step(self, grads, lr: torch.Tensor, done: torch.Tensor,
                  frozen: Optional[torch.Tensor] = None) -> None:
        """``optax.scale_by_adam(0.9, 0.999, 1e-8)`` then ``p - lr * d``;
        nothing moves where ``done``, and the parameters are then
        ``frozen`` (the unperturbed ones under parameter noise). With lanes,
        ``lr`` and ``done`` are (B,), one a lane."""
        n_net = len(self.params)
        g = torch.cat([gi.reshape(self.lead + (-1,)) for gi in grads[:n_net]], dim=-1).float()
        count_inc = self.count + 1
        one = torch.ones((), dtype=torch.float32, device=g.device)
        bc1 = 1 - (one * _B1) ** count_inc
        bc2 = 1 - (one * _B2) ** count_inc
        f = self.flat
        mu, nu, d = self._adam(g, self.mu, self.nu, _lane(bc1, f), _lane(bc2, f))
        keep = f if frozen is None else frozen
        self.flat.copy_(torch.where(_lane(done, f), keep, f - _lane(lr, f) * d))
        self.mu.copy_(torch.where(_lane(done, f), self.mu, mu))
        self.nu.copy_(torch.where(_lane(done, f), self.nu, nu))
        if self.canvas is not None:
            c = self.canvas
            mu, nu, d = self._adam(grads[n_net], self.canvas_mu, self.canvas_nu,
                                   _lane(bc1, c), _lane(bc2, c))
            self.canvas.copy_(torch.where(_lane(done, c), c, c - _lane(lr, c) * d))
            self.canvas_mu.copy_(torch.where(_lane(done, c), self.canvas_mu, mu))
            self.canvas_nu.copy_(torch.where(_lane(done, c), self.canvas_nu, nu))
        self.count.copy_(torch.where(done, self.count, count_inc))


@dataclass
class SolveResult:
    out_best: np.ndarray          # (*spatial, C), best-loss network output
    history: History
    params: Dict[str, torch.Tensor]
    elapsed: float
    iters_run: int
    stopped_early: bool
    # the input canvas (*spatial, inputdepth), float32: the optimised one
    # under opt_over="net,input"
    noise: Optional[np.ndarray] = None
    # wall seconds of each chunk, each ending at the chunk's host read
    chunk_seconds: List[float] = field(default_factory=list)
    # save_every: the last output (*spatial, C) float32 at each multiple of
    # save_every below epochs
    snapshots: Dict[int, np.ndarray] = field(default_factory=dict)
    # pocs: the f-k projection of the best output (*spatial, C) float32
    pocs: Optional[np.ndarray] = None


def _profiled(profile_dir: str, fn):
    """Run ``fn`` under ``torch.profiler``; write ``trace.json`` (Chrome
    trace) and ``ops.txt`` into ``profile_dir``: the window's wall time, the
    device kernels' summed time and busy share, then the kernels by time
    (on a CPU-only run: the operators by self CPU time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(profile_dir, exist_ok=True)
    t0 = time.time()
    with profile(activities=acts) as prof:
        out = fn()
    wall_us = (time.time() - t0) * 1e6
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    if cuda:  # kernel rows only: operator rows repeat their kernels' time
        rows = [(e.self_device_time_total, e) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
    else:
        rows = [(e.self_cpu_time_total, e) for e in prof.key_averages()]
    rows.sort(key=lambda r: r[0], reverse=True)
    busy = sum(t for t, _ in rows)
    with open(os.path.join(profile_dir, "ops.txt"), "w") as fh:
        fh.write(f"window {wall_us / 1e3:.3f} ms, {'device kernels' if cuda else 'cpu ops'} "
                 f"{busy / 1e3:.3f} ms, busy share {busy / wall_us:.4f}\n")
        for t, e in rows:
            fh.write(f"{t / 1e3:12.3f} ms {e.count:7d}x  {e.key}\n")
    return out


_TRACKERS = ("lr", "loss_min", "out_best", "out_last", "plateau_best",
             "plateau_bad", "es_best", "es_bad", "done")
# the generators the step draws from: its input noise, the parameter noise
# and dropout
_STEP_GENERATORS = ("noise", "param", "dropout")


def _generators(seed: int, device) -> Dict[str, torch.Generator]:
    """The canvas's generator and the step's, each seeded from ``seed`` by
    a CPU generator, so no two share a stream."""
    seeds = torch.randint(2 ** 62, (4,), generator=torch.Generator().manual_seed(seed))
    return {name: torch.Generator(device=device).manual_seed(int(sd))
            for name, sd in zip(("canvas",) + _STEP_GENERATORS, seeds)}


def _solver_state(st: Dict[str, Any], gens: Mapping[str, torch.Generator]
                  ) -> Dict[str, torch.Tensor]:
    """Every tensor of the solver's state, by name: the flat parameters,
    Adam's moments and count, an optimised canvas with its moments, the
    step generators' states (CPU uint8 tensors, also for CUDA generators)
    and the trackers."""
    flat = st["flat"]
    state = {"params": flat.flat, "mu": flat.mu, "nu": flat.nu, "count": flat.count}
    if flat.canvas is not None:
        state.update({"canvas": flat.canvas.detach(), "canvas_mu": flat.canvas_mu,
                      "canvas_nu": flat.canvas_nu})
    state.update({f"rng_{k}": gens[k].get_state() for k in _STEP_GENERATORS})
    state.update({k: _whole(st, st[k]) for k in _TRACKERS if k in st})
    return state


def _restore_state(st: Dict[str, Any], gens: Mapping[str, torch.Generator],
                   saved: Mapping[str, torch.Tensor]) -> None:
    """Put a saved state back. The flat buffers are copied in place: the
    net's parameters are views into them."""
    flat = st["flat"]
    with torch.no_grad():
        for name, t in (("params", flat.flat), ("mu", flat.mu), ("nu", flat.nu),
                        ("count", flat.count)):
            t.copy_(saved[name])
        if flat.canvas is not None:
            for name, t in (("canvas", flat.canvas), ("canvas_mu", flat.canvas_mu),
                            ("canvas_nu", flat.canvas_nu)):
                t.copy_(saved[name])
    for k in _STEP_GENERATORS:
        gens[k].set_state(saved[f"rng_{k}"])
    for k in _TRACKERS:
        if isinstance(st.get(k), list):   # a sharded output
            st[k] = st["spatial"].layout.split(saved[k], cropped=True)
        elif k in st:
            st[k] = saved[k]


def _resolve_device(cfg: Config, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("DIPSolver runs on CUDA and no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return torch.device(f"cuda:{cfg.gpu}" if cfg.gpu is not None else "cuda")


class DIPSolver:
    """Single-patch DIP solver.

    Usage::

        solver = DIPSolver(cfg, outchannel=1)      # on cuda (cuda:{cfg.gpu})
        result = solver.solve(img, mask, seed=0)   # img/mask (*spatial, C)
    """

    def __init__(self, cfg: Config, outchannel: int = 1,
                 device: Union[str, torch.device, None] = None):
        self.cfg = cfg
        self.outchannel = outchannel
        self.device = _resolve_device(cfg, device)
        if cfg.dtype == "float32":
            # float32 means float32: no TF32 in cuDNN convs or in matmuls
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.model = get_net(cfg, outchannel)

    def _init_model(self, seed: int, init_params: Optional[Mapping[str, Any]]):
        model = self.model
        if init_params is None:
            init_weights(model, torch.Generator().manual_seed(seed),
                         self.cfg.inittype, self.cfg.initgain)
        else:
            model.load_state_dict({k: torch.as_tensor(np.asarray(v))
                                   for k, v in init_params.items()}, strict=True)
        return model.to(self.device)

    @staticmethod
    def _net_input(it: int, st: Dict[str, Any], data, s: StepSettings,
                   gens, regenerate) -> torch.Tensor:
        """The canvas plus this step's perturbations, through which no
        gradient flows. A function of its own, so that the perturbations
        and a drawn canvas are freed before the forward. With lanes
        (``gens`` a list, one dict a lane) each lane's noise is drawn from
        its own generator, at one lane's shape."""
        if s.opt_input:
            base = st["flat"].canvas
        elif s.virtual_input:
            base = regenerate()
        else:
            base = data["base_input"]
        extra = None
        if s.reg_noise_std > 0:
            if isinstance(gens, list):
                extra = s.reg_noise_std * torch.stack([
                    get_noise(g["noise"], base.shape[1:], "n", base.dtype, base.device)
                    for g in gens])
            else:
                extra = s.reg_noise_std * get_noise(gens["noise"], base.shape, "n",
                                                    base.dtype, base.device)
        if s.forget_factor > 0:
            # float32 data: a bfloat16 canvas makes a float32 net input
            fe = data["forget_w"][min(it, s.forget_factor)] * data["forget_data"]
            extra = fe if extra is None else extra + fe
        return base if extra is None else base + extra

    @staticmethod
    def _loss_terms(out: torch.Tensor, img: torch.Tensor, mask: torch.Tensor, data, hyper,
                    s: StepSettings, out_dtype: torch.dtype):
        """The cropped output, the loss and the step's metrics (snr, pcorr,
        and with POCS df, reg, eps, th) of one lane's net output."""
        if out.dtype != out_dtype:
            raise TypeError(f"the net's output is {out.dtype}, the tracked best output "
                            f"{out_dtype}: the JAX package's scan refuses a carry whose "
                            f"dtype changes")
        out = _crop_center(out, s.orig_spatial)
        if s.fused_loss:
            main, mets = fused_loss_metrics(out, img, mask, loss=s.loss)
            ys = {"snr": mets["snr"].detach(), "pcorr": mets["pcorr"].detach()}
        else:
            main = L.masked_fit([out], [img], [mask], s.loss)
            with torch.no_grad():
                ys = L.snr_pcorr([out.detach().float()], [img])
        return out, _with_pocs(out, main, ys, data, hyper, s), ys

    def _lane_forward(self, inp: torch.Tensor, st: Dict[str, Any], data, hyper,
                      s: StepSettings):
        """The net and the loss of B lanes at once: ``torch.func.vmap`` over
        ``functional_call`` with each lane's parameters and data."""
        flat = st["flat"]
        keys = [k for k in ("img", "mask", "net_mask", "pocs_wdata", "pocs_wmask")
                if data.get(k) is not None]
        out_dtype = st["out_best"].dtype

        def one(params, x, lane_data):
            net_in = (x, lane_data["net_mask"]) if s.takes_mask else (x,)
            out = functional_call(self.model, dict(zip(flat.names, params)), net_in)
            return self._loss_terms(out, lane_data["img"], lane_data["mask"], lane_data,
                                    hyper, s, out_dtype)
        return vmap(one)(flat.params, inp, {k: data[k] for k in keys})

    def _step(self, it: int, st: Dict[str, Any], data, hyper, s: StepSettings,
              gens, regenerate) -> Dict[str, torch.Tensor]:
        """One iteration of one lane (``gens`` a dict) or of B lanes (a list
        of B dicts; every tracker a (B,) tensor); of one lane over spatial
        shards where ``st["spatial"]`` holds a ``parallel.spatial.ShardedStep``
        (the canvas, data and outputs lists of shards)."""
        flat = st["flat"]
        lanes = isinstance(gens, list)
        sharded = st.get("spatial")
        if sharded is not None:
            inp = sharded.net_input(it, data, s, gens, regenerate)
        else:
            inp = self._net_input(it, st, data, s, gens, regenerate)
        frozen = None
        if s.param_noise:
            frozen = flat.perturb([g["param"] for g in gens] if lanes else gens["param"])
        if lanes:
            out, loss, ys = self._lane_forward(inp, st, data, hyper, s)
            grads = torch.autograd.grad(loss.sum(), flat.leaves())
        elif sharded is not None:
            out, main, ys = sharded.loss_terms(sharded(inp), data, s, st["out_best"][0].dtype,
                                               flat.flat.device)
            whole = sharded.layout.gather(out, main.device) if s.pocs else None
            loss = _with_pocs(whole, main, ys, data, hyper, s)
            grads = torch.autograd.grad(loss, flat.leaves())
        else:
            net_out = (self.model(inp, data["net_mask"]) if s.takes_mask
                       else self.model(inp))
            out, loss, ys = self._loss_terms(net_out, data["img"], data["mask"], data, hyper,
                                             s, st["out_best"].dtype)
            grads = torch.autograd.grad(loss, flat.leaves())
        done, lr = st["done"], st["lr"]
        flat.adam_step(grads, lr, done, frozen)

        with torch.no_grad():
            loss = loss.detach()
            out = [o.detach() for o in out] if sharded is not None else out.detach()
            better = (loss <= st["loss_min"]) & ~done
            st["out_best"] = _where(better, out, st["out_best"])
            if s.track_last:
                st["out_last"] = _where(done, st["out_last"], out)
            st["loss_min"] = torch.where(better, loss, st["loss_min"])

            # ReduceLROnPlateau (rel threshold, min mode)
            if hyper["reduce_lr"]:
                pb, pbad = st["plateau_best"], st["plateau_bad"]
                is_b = loss < pb * (1.0 - hyper["lr_thresh"])
                pb2 = torch.where(is_b, loss, pb)
                pbad2 = torch.where(is_b, torch.zeros_like(pbad), pbad + 1)
                reduce = pbad2 > hyper["lr_patience"]
                new_lr = lr * hyper["lr_factor"]
                lr2 = torch.where(reduce & (lr - new_lr > 1e-8), new_lr, lr)
                pbad2 = torch.where(reduce, torch.zeros_like(pbad2), pbad2)
                st["plateau_best"] = torch.where(done, pb, pb2)
                st["plateau_bad"] = torch.where(done, pbad, pbad2)
                st["lr"] = torch.where(done, lr, lr2)

            # EarlyStopping (percentage min-delta, NaN abort); patience 0
            # disables stopping
            eb, ebad = st["es_best"], st["es_bad"]
            if it == 0:
                eb2, ebad2 = loss, torch.zeros_like(ebad)
                stop = torch.zeros_like(done)
            else:
                is_b = loss < eb - eb * hyper["es_min_delta"] / 100.0
                eb2 = torch.where(is_b, loss, eb)
                ebad2 = torch.where(is_b, torch.zeros_like(ebad), ebad + 1)
                stop = ((ebad2 >= hyper["es_patience"]) if hyper["es_patience"] > 0
                        else torch.zeros_like(done))
            st["es_best"] = torch.where(done, eb, eb2)
            st["es_bad"] = torch.where(done, ebad, ebad2)
            st["done"] = done | stop | torch.isnan(loss) | (it + 1 >= hyper["epochs"])
        ys.update({"loss": loss, "snr": ys["snr"].float(), "pcorr": ys["pcorr"].float(),
                   "lr": lr, "recorded": (~done).float()})
        return ys

    def _save_checkpoint(self, path: str, st: Dict[str, Any],
                         gens: Mapping[str, torch.Generator], hist: History,
                         chunk_idx: int, iters_run: int) -> None:
        """The whole state, the position and the history in one ``.npz``.
        ``stopped`` says whether the solve had ended, so that a resume knows
        whether stepping again is allowed (only after an epoch-budget stop);
        ``wgrad_plans`` the wgrad kernel's tuned grids, so that a resume in
        another process sums as this one does."""
        extra = {"__meta__": np.asarray(json.dumps(
            {"chunk": chunk_idx, "iters_run": iters_run, "epochs": int(self.cfg.epochs),
             "stopped": bool(st["done"]), "wgrad_plans": wgrad_ops.tuned_plans()}))}
        for f in hist.FIELDS:
            extra[f"__hist_{f}__"] = np.asarray(getattr(hist, f), np.float64)
        ckpt_io.save_solver_state(path, _solver_state(st, gens), extra)

    def _resume(self, path: str, st: Dict[str, Any], gens: Mapping[str, torch.Generator],
                hist: History) -> Tuple[int, int, bool]:
        """Restore a checkpoint into ``st``, ``gens`` and ``hist``; returns
        ``(start_chunk, iters_run, final)``. An early-stopped or NaN-aborted
        state is final: stepping it again would undo the stop decision or
        write NaN gradients into the frozen parameters. A stop at the epoch
        budget is reopened when ``epochs`` has grown. The saved wgrad grids
        are pinned before the first resumed step."""
        _restore_state(st, gens, ckpt_io.load_solver_state(path, _solver_state(st, gens)))
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"])) if "__meta__" in z.files else {}
            for f in hist.FIELDS:
                if f"__hist_{f}__" in z.files:
                    getattr(hist, f).extend(z[f"__hist_{f}__"].tolist())
        wgrad_ops.pin_plans(meta.get("wgrad_plans", []))
        start_chunk = int(meta.get("chunk", 0))
        iters_run = int(meta.get("iters_run", 0))
        if bool(meta.get("stopped", False)):
            last_nan = bool(hist.loss) and not np.isfinite(hist.loss[-1])
            budget_stop = iters_run >= int(meta.get("epochs", 0)) and not last_nan
            if not (budget_stop and self.cfg.epochs > iters_run):
                return start_chunk, iters_run, True
        st["done"] = torch.zeros_like(st["done"])
        return start_chunk, iters_run, False

    def solve(self, img: np.ndarray, mask: np.ndarray, seed: int = 0,
              init_params: Optional[Mapping[str, Any]] = None,
              noise: Optional[np.ndarray] = None, verbose: bool = False,
              checkpoint_path: Optional[str] = None, checkpoint_every: int = 0,
              profile_dir: Optional[str] = None, spatial_mesh=None,
              spatial_axis: int = 1) -> SolveResult:
        """Optimise one patch; ``img``/``mask`` are (*spatial, C) float32.

        ``init_params`` is a state dict of the net (transfer learning, or a
        JAX tree through ``io.bridge``); ``noise`` is the input canvas as
        (*padded_spatial, inputdepth), as it goes into the net (shaped, and
        stored even under ``virtual_input``), drawn from ``seed`` when None.
        ``checkpoint_path`` with ``checkpoint_every`` (in chunks) saves the
        whole state; a later ``solve`` with the same path, problem and seed
        resumes where it stopped, exactly, in this process or another. With
        a ``checkpoint_path`` the solve runs with
        ``torch.backends.cudnn.deterministic`` set, and sets it back after.
        ``profile_dir`` captures a ``torch.profiler`` trace of the second
        chunk (see ``_profiled``).

        ``spatial_mesh`` (``parallel.make_spatial_mesh``: a list of devices,
        repeats allowed) splits the patch's volume along ``spatial_axis``
        (0 = the first spatial dim) over its shards
        (``parallel/spatial.py``): the same solve up to the order of its
        sums; a checkpoint holds whole tensors and resumes on the same mesh.
        What it does not cover yet raises ``NotImplementedError`` (ROADMAP
        A.13c) before anything is drawn.
        """
        args = (img, mask, seed, init_params, noise, verbose)
        if not checkpoint_path:
            return self._solve(*args, None, 0, profile_dir, spatial_mesh, spatial_axis)
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            return self._solve(*args, checkpoint_path, checkpoint_every, profile_dir,
                               spatial_mesh, spatial_axis)
        finally:
            torch.backends.cudnn.deterministic = deterministic

    def _solve(self, img: np.ndarray, mask: np.ndarray, seed: int,
               init_params: Optional[Mapping[str, Any]], noise: Optional[np.ndarray],
               verbose: bool, checkpoint_path: Optional[str], checkpoint_every: int,
               profile_dir: Optional[str], spatial_mesh=None,
               spatial_axis: int = 1) -> SolveResult:
        cfg, dev = self.cfg, self.device
        if img.shape != mask.shape:
            raise ValueError("image and mask shapes must match")
        spatial = tuple(img.shape[:-1])
        padded = padded_spatial(spatial, pad_multiple_for(cfg))
        s = StepSettings.from_config(cfg, spatial,
                                     takes_mask=getattr(self.model, "takes_mask", False),
                                     input_shape=(1, cfg.inputdepth) + padded)
        if noise is not None:
            s = dataclasses.replace(s, virtual_input=False)
        if s.opt_input and cfg.dtype == "bfloat16":
            raise TypeError("opt_over with 'input' under dtype='bfloat16': the update "
                            "p - lr * d of the bfloat16 canvas is float32, and the JAX "
                            "package's scan refuses a carry whose dtype changes")
        layout = None
        if spatial_mesh is not None:
            from ..parallel.spatial import ShardedStep, SpatialLayout, check_supported
            check_supported(cfg)
            layout = SpatialLayout(spatial_mesh, spatial_axis, padded, spatial,
                                   2 ** (len(cfg.filters) - 1))

        gens = _generators(seed, dev)
        canvas_start = gens["canvas"].get_state()

        def regenerate() -> torch.Tensor:
            """The raw canvas again, from its generator's first state."""
            gens["canvas"].set_state(canvas_start)
            return build_base_input(cfg, gens["canvas"], padded, dev)

        if noise is not None:
            if tuple(noise.shape) != padded + (cfg.inputdepth,):
                raise ValueError(f"noise must be {padded + (cfg.inputdepth,)}, "
                                 f"got {tuple(noise.shape)}")
            base_input = _to_channels_first(
                noise, dev, torch.bfloat16 if cfg.dtype == "bfloat16"
                else torch.float32)
        elif s.virtual_input:
            base_input = None
        else:
            base_input = build_base_input(cfg, gens["canvas"], padded, dev)
        data = build_data(img, mask, base_input, dev,
                          pocs_alpha=cfg.pocs_alpha if s.pocs else None,
                          forget_factor=s.forget_factor,
                          net_mask_shape=s.input_shape if s.takes_mask else None)
        hyper = build_hyper(cfg, dev)
        self._init_model(seed, init_params)
        set_dropout_generator(self.model, gens["dropout"])

        f32 = dict(dtype=torch.float32, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        out_dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        out_shape = (1, self.outchannel) + spatial
        st: Dict[str, Any] = {
            "flat": _FlatParams(self.model, base_input if s.opt_input else None),
            "lr": torch.tensor(cfg.lr, **f32),
            "loss_min": torch.tensor(math.inf, **f32),
            "out_best": torch.zeros(out_shape, dtype=out_dtype, device=dev),
            "plateau_best": torch.tensor(math.inf, **f32),
            "plateau_bad": torch.tensor(0, **i32),
            "es_best": torch.tensor(0.0, **f32),
            "es_bad": torch.tensor(0, **i32),
            "done": torch.tensor(False, device=dev),
        }
        if s.opt_input:  # the optimised leaf replaces the stored canvas
            data["base_input"] = base_input = None
        if s.track_last:
            st["out_last"] = torch.zeros(out_shape, dtype=out_dtype, device=dev)
        if layout is not None:   # the whole canvas and data go once split
            data, st = layout.shard(data, st)
            st["spatial"] = ShardedStep(self.model, layout)
            base_input = None

        chunk = max(1, min(cfg.scan_chunk, cfg.epochs))
        if cfg.save_every:
            chunk = math.gcd(chunk, int(cfg.save_every)) or 1
        n_chunks = math.ceil(cfg.epochs / chunk)
        hist = HistoryPOCS(cfg.epochs) if s.pocs else History(cfg.epochs)
        snapshots: Dict[int, np.ndarray] = {}
        chunk_seconds: List[float] = []
        start = time.time()
        start_chunk, iters_run, stopped = 0, 0, False

        if checkpoint_path:
            checkpoint_path = ckpt_io.npz_path(checkpoint_path)
        if checkpoint_path and os.path.exists(checkpoint_path):
            start_chunk, iters_run, final = self._resume(checkpoint_path, st, gens, hist)
            if final:
                start_chunk, stopped = n_chunks, iters_run < cfg.epochs

        fields = ("loss", "snr", "pcorr", "lr", "recorded")
        if s.pocs:
            fields += ("df", "reg", "eps", "th")

        def run_chunk(c: int) -> np.ndarray:
            # the step's conv formulation, for its forward and its backward
            with conv_impl(s.conv_mode):
                ys = [self._step(it, st, data, hyper, s, gens, regenerate)
                      for it in range(c * chunk, (c + 1) * chunk)]
            # the one host read of the chunk (and its synchronisation point)
            return torch.stack(
                [torch.stack([y[f] for y in ys]) for f in fields]
                + [st["done"].float().expand(len(ys))]).cpu().numpy()

        for c in range(start_chunk, n_chunks):
            t0 = time.time()
            if profile_dir and c == 1:
                packed = _profiled(profile_dir, lambda: run_chunk(c))
            else:
                packed = run_chunk(c)
            chunk_seconds.append(time.time() - t0)
            host = dict(zip(fields + ("done",), packed))
            n_rec = min(int(host["recorded"].sum()), cfg.epochs - iters_run)
            hist.extend(host, n_rec)
            iters_run += n_rec
            if verbose and n_rec:
                print(hist.log_message(iters_run - 1), end="\r")
            end_iter = (c + 1) * chunk
            if cfg.save_every and end_iter % cfg.save_every == 0 and end_iter < cfg.epochs:
                snapshots[end_iter] = _to_channels_last(_whole(st, st["out_last"]))
            if checkpoint_path and checkpoint_every and (c + 1) % checkpoint_every == 0:
                self._save_checkpoint(checkpoint_path, st, gens, hist, c + 1, iters_run)
            if bool(host["done"][0]):
                stopped = iters_run < cfg.epochs
                break
        elapsed = time.time() - start
        if layout is not None and not s.virtual_input:
            data = dict(data, base_input=layout.gather(data["base_input"]))

        pocs = None
        if s.pocs:
            with torch.no_grad():
                pocs = _to_channels_last(fk_projection(
                    _whole(st, st["out_best"]).float(), data["pocs_wdata"],
                    data["pocs_wmask"], hyper["pocs_thresh"]))
        return SolveResult(
            out_best=_to_channels_last(_whole(st, st["out_best"])), history=hist,
            params={k: v.detach().cpu().clone()
                    for k, v in self.model.state_dict().items()},
            elapsed=elapsed, iters_run=iters_run, stopped_early=stopped,
            noise=extract_noise_canvas(s, st, data, regenerate, spatial),
            chunk_seconds=chunk_seconds, snapshots=snapshots, pocs=pocs)
