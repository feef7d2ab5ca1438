"""The DIP solver: per-patch optimisation (counterpart of ``engine/solver.py``).

The optimisation of a MulResUnet on one patch *is* the inference. Each step:

  * adds fresh input noise ``reg_noise_std * N(0, 1)`` to the fixed canvas;
  * runs the net forward and crops the padding away;
  * computes the masked loss and the SNR / Pearson metrics in float32, from
    the fused loss kernel when ``fused_loss`` (``ops/fused_loss.py``) and
    from ``ops/losses.py`` otherwise;
  * applies Adam written as tensor ops, exactly ``optax.scale_by_adam(0.9,
    0.999, 1e-8)`` followed by ``p - lr * d``, on one flat float32 buffer
    that all the net's parameters view;
  * tracks the best output with ``<=``, ReduceLROnPlateau (relative
    threshold; the cut only when ``lr - new_lr > 1e-8``) and EarlyStopping
    (percentage min-delta, NaN abort, reset at ``it == 0``);
  * sets the ``done`` flag, which freezes params, Adam state and trackers.

All of that state stays on the device as tensors. The host reads it once
per ``scan_chunk`` iterations: one copy of the chunk's metrics and the
``done`` flag, which is also the chunk's synchronisation point.

Features the port does not serve yet raise ``NotImplementedError`` naming
their ROADMAP item.
"""
from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..config import Config
from ..models import get_net, init_weights
from ..ops import losses as L
from ..ops.fused_loss import fused_loss_metrics
from ..ops.noise import get_noise
from .history import History

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


@dataclass(frozen=True)
class StepSettings:
    """Static structure of the step (the JAX package's jit cache key, cut to
    what the ported step reads)."""
    loss: str = "mae"
    reg_noise_std: float = 0.03
    orig_spatial: Tuple[int, ...] = ()
    fused_loss: bool = False

    @classmethod
    def from_config(cls, cfg: Config, orig_spatial: Tuple[int, ...]) -> "StepSettings":
        return cls(loss=cfg.loss, reg_noise_std=cfg.reg_noise_std,
                   orig_spatial=tuple(orig_spatial),
                   fused_loss=(cfg.fused_loss
                               and cfg.loss in ("mae", "l1", "mse")))


def check_supported(cfg: Config) -> None:
    """Raise ``NotImplementedError`` for a solver feature the port lacks
    (the net's own, such as remat or phase space, raise in ``get_net``)."""
    todo = [
        (cfg.virtual_input, "virtual_input", "A.2"),
        ("input" in cfg.opt_over.split(","), "opt_over with 'input'", "A.2"),
        (cfg.save_every is not None, "save_every snapshots", "A.4"),
        (cfg.param_noise, "param_noise", "A.5"),
        (cfg.data_forgetting_factor > 0, "data_forgetting_factor", "A.5"),
        (cfg.pocs, "pocs", "A.6"),
        (cfg.filter_noise_with_wavelet, "filter_noise_with_wavelet", "A.7"),
        (bool(cfg.lowpass_fs and cfg.lowpass_fc), "low-pass canvas shaping", "A.7"),
        (cfg.vmap_conv_mode != "grouped", "vmap_conv_mode 'tapmm'", "A.12"),
        (bool(cfg.spatial_shards and cfg.spatial_shards > 1), "spatial_shards", "A.13"),
    ]
    for on, what, item in todo:
        if on:
            raise NotImplementedError(f"{what} is not ported yet: ROADMAP {item}")


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
    }


def pad_multiple_for(cfg: Config) -> int:
    if cfg.pad_multiple and cfg.pad_multiple > 0:
        return cfg.pad_multiple
    return 2 ** (len(cfg.filters) - 1)


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
                     padded: Tuple[int, ...], device) -> torch.Tensor:
    """The fixed input canvas (1, inputdepth, *padded): raw noise times
    ``noise_std``, stored in bfloat16 when the net computes in bfloat16."""
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    noise = get_noise(generator, (1, cfg.inputdepth) + tuple(padded),
                      cfg.noise_dist, dtype, device)
    return noise * cfg.noise_std


def build_data(img: np.ndarray, mask: np.ndarray, base_input: torch.Tensor,
               device) -> Dict[str, torch.Tensor]:
    """The per-patch tensors of the step: img/mask (1, C, *spatial) float32
    and the canvas."""
    return {"img": _to_channels_first(img, device),
            "mask": _to_channels_first(mask, device),
            "base_input": base_input}


class _FlatParams:
    """The net's parameters as views into one float32 buffer, with Adam's
    moments beside it, so the update is a handful of large tensor ops."""

    def __init__(self, model: torch.nn.Module):
        self.params = [p for p in model.parameters()]
        with torch.no_grad():
            self.flat = torch.cat([p.detach().reshape(-1) for p in self.params])
            off = 0
            for p in self.params:
                n = p.numel()
                p.data = self.flat[off:off + n].view_as(p)
                off += n
        self.mu = torch.zeros_like(self.flat)
        self.nu = torch.zeros_like(self.flat)
        self.count = torch.zeros((), dtype=torch.int32, device=self.flat.device)

    @torch.no_grad()
    def adam_step(self, grads, lr: torch.Tensor, done: torch.Tensor) -> None:
        """``optax.scale_by_adam(0.9, 0.999, 1e-8)`` then ``p - lr * d``;
        nothing moves where ``done``."""
        g = torch.cat([gi.reshape(-1) for gi in grads]).float()
        mu = (1 - _B1) * g + _B1 * self.mu
        nu = (1 - _B2) * (g ** 2) + _B2 * self.nu
        count_inc = self.count + 1
        one = torch.ones((), dtype=torch.float32, device=g.device)
        bc1 = 1 - (one * _B1) ** count_inc
        bc2 = 1 - (one * _B2) ** count_inc
        d = (mu / bc1) / (torch.sqrt(nu / bc2) + _EPS)
        self.flat.copy_(torch.where(done, self.flat, self.flat - lr * d))
        self.mu.copy_(torch.where(done, self.mu, mu))
        self.nu.copy_(torch.where(done, self.nu, nu))
        self.count.copy_(torch.where(done, self.count, count_inc))


@dataclass
class SolveResult:
    out_best: np.ndarray          # (*spatial, C), best-loss network output
    history: History
    params: Dict[str, torch.Tensor]
    elapsed: float
    iters_run: int
    stopped_early: bool
    # the fixed input canvas (*spatial, inputdepth), float32
    noise: Optional[np.ndarray] = None
    # wall seconds of each chunk, each ending at the chunk's host read
    chunk_seconds: List[float] = field(default_factory=list)


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
        check_supported(cfg)
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

    def _step(self, it: int, st: Dict[str, Any], data, hyper, s: StepSettings,
              gen: torch.Generator) -> Dict[str, torch.Tensor]:
        model, flat = self.model, st["flat"]
        img, mask, base = data["img"], data["mask"], data["base_input"]
        inp = base
        if s.reg_noise_std > 0:
            inp = base + s.reg_noise_std * get_noise(gen, base.shape, "n",
                                                     base.dtype, base.device)
        out = _crop_center(model(inp), s.orig_spatial)
        if s.fused_loss:
            loss, mets = fused_loss_metrics(out, img, mask, loss=s.loss)
        else:
            loss = L.get_loss_fn(s.loss)(out, img, mask)
        grads = torch.autograd.grad(loss, flat.params)
        done, lr = st["done"], st["lr"]
        flat.adam_step(grads, lr, done)

        with torch.no_grad():
            loss = loss.detach()
            out = out.detach()
            if s.fused_loss:
                snr_v, pcorr_v = mets["snr"].detach(), mets["pcorr"].detach()
            else:
                out32 = out.float()
                snr_v, pcorr_v = L.snr(out32, img), L.pcorr(out32, img)

            better = (loss <= st["loss_min"]) & ~done
            st["out_best"] = torch.where(better, out, st["out_best"])
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
        return {"loss": loss, "snr": snr_v.float(), "pcorr": pcorr_v.float(),
                "lr": lr, "recorded": (~done).float()}

    def solve(self, img: np.ndarray, mask: np.ndarray, seed: int = 0,
              init_params: Optional[Mapping[str, Any]] = None,
              noise: Optional[np.ndarray] = None, verbose: bool = False,
              checkpoint_path: Optional[str] = None, checkpoint_every: int = 0,
              profile_dir: Optional[str] = None, spatial_mesh=None,
              spatial_axis: int = 1) -> SolveResult:
        """Optimise one patch; ``img``/``mask`` are (*spatial, C) float32.

        ``init_params`` is a state dict of the net (transfer learning, or a
        JAX tree through ``io.bridge``); ``noise`` is the fixed input canvas
        as (*padded_spatial, inputdepth), drawn from ``seed`` when None.
        ``profile_dir`` captures a ``torch.profiler`` trace of the second
        chunk (see ``_profiled``).
        """
        if checkpoint_path or checkpoint_every:
            raise NotImplementedError("checkpoint and resume: ROADMAP A.3")
        if spatial_mesh is not None:
            raise NotImplementedError("spatial sharding: ROADMAP A.13")
        cfg, dev = self.cfg, self.device
        if img.shape != mask.shape:
            raise ValueError("image and mask shapes must match")
        spatial = tuple(img.shape[:-1])
        padded = padded_spatial(spatial, pad_multiple_for(cfg))
        s = StepSettings.from_config(cfg, spatial)

        gen = torch.Generator(device=dev).manual_seed(seed)
        if noise is None:
            base_input = build_base_input(cfg, gen, padded, dev)
        else:
            if tuple(noise.shape) != padded + (cfg.inputdepth,):
                raise ValueError(f"noise must be {padded + (cfg.inputdepth,)}, "
                                 f"got {tuple(noise.shape)}")
            base_input = _to_channels_first(
                noise, dev, torch.bfloat16 if cfg.dtype == "bfloat16"
                else torch.float32)
        data = build_data(img, mask, base_input, dev)
        hyper = build_hyper(cfg, dev)
        self._init_model(seed, init_params)

        f32 = dict(dtype=torch.float32, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        out_dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        st: Dict[str, Any] = {
            "flat": _FlatParams(self.model),
            "lr": torch.tensor(cfg.lr, **f32),
            "loss_min": torch.tensor(math.inf, **f32),
            "out_best": torch.zeros((1, self.outchannel) + spatial,
                                    dtype=out_dtype, device=dev),
            "plateau_best": torch.tensor(math.inf, **f32),
            "plateau_bad": torch.tensor(0, **i32),
            "es_best": torch.tensor(0.0, **f32),
            "es_bad": torch.tensor(0, **i32),
            "done": torch.tensor(False, device=dev),
        }

        chunk = max(1, min(cfg.scan_chunk, cfg.epochs))
        n_chunks = math.ceil(cfg.epochs / chunk)
        hist = History(cfg.epochs)
        chunk_seconds: List[float] = []
        start = time.time()
        iters_run, stopped = 0, False

        def run_chunk(c: int) -> np.ndarray:
            ys = [self._step(it, st, data, hyper, s, gen)
                  for it in range(c * chunk, (c + 1) * chunk)]
            # the one host read of the chunk (and its synchronisation point)
            return torch.stack(
                [torch.stack([y[f] for y in ys]) for f in
                 ("loss", "snr", "pcorr", "lr", "recorded")]
                + [st["done"].float().expand(len(ys))]).cpu().numpy()

        for c in range(n_chunks):
            t0 = time.time()
            if profile_dir and c == 1:
                packed = _profiled(profile_dir, lambda: run_chunk(c))
            else:
                packed = run_chunk(c)
            chunk_seconds.append(time.time() - t0)
            host = dict(zip(("loss", "snr", "pcorr", "lr", "recorded", "done"),
                            packed))
            n_rec = min(int(host["recorded"].sum()), cfg.epochs - iters_run)
            hist.extend(host, n_rec)
            iters_run += n_rec
            if verbose and n_rec:
                print(hist.log_message(iters_run - 1), end="\r")
            if bool(host["done"][0]):
                stopped = iters_run < cfg.epochs
                break
        elapsed = time.time() - start

        canvas = _crop_center(base_input.float(), spatial)
        return SolveResult(
            out_best=_to_channels_last(st["out_best"]), history=hist,
            params={k: v.detach().cpu().clone()
                    for k, v in self.model.state_dict().items()},
            elapsed=elapsed, iters_run=iters_run, stopped_early=stopped,
            noise=_to_channels_last(canvas),
            chunk_seconds=chunk_seconds)
