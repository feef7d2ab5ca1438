"""The first steps of one patch's optimisation, in plain float32.

A deep-prior solve fits a freshly drawn net to one decimated patch: each step
feeds the net a fixed noise canvas plus fresh noise, takes the masked L1 (or
L2) misfit of its output, and applies Adam (beta 0.9 and 0.999, eps 1e-8,
then ``p - lr * d``). This module runs those steps from the benchmark's
weights and data and reports what the comparison reads: each step's loss, the
norm of each parameter's gradient at the first step, and the norm of each
parameter's change after the last.

The canvas and the per-step noise are drawn as the program under test draws
them from a solve's seed (four generator seeds from a CPU generator seeded
with it; the canvas from the first, the step noise from the second, each a
generator on the solve's device, in the compute dtype), so both sides see the
same inputs. The sum of canvas and noise, and everything after it, is float32
here. TF32 is off while the steps run.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Sequence

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def generator_seeds(seed: int) -> List[int]:
    g = torch.Generator().manual_seed(int(seed))
    return [int(s) for s in torch.randint(2 ** 62, (4,), generator=g)]


def net_inputs(seed: int, shape: Sequence[int], device, dtype: torch.dtype,
               noise_std: float, reg_noise_std: float, n_steps: int) -> Iterator[torch.Tensor]:
    """The float32 net input of each of ``n_steps`` steps of a solve with
    ``seed``: canvas plus step noise, each drawn in ``dtype``."""
    seeds = generator_seeds(seed)
    g_canvas = torch.Generator(device=device).manual_seed(seeds[0])
    g_noise = torch.Generator(device=device).manual_seed(seeds[1])
    shape = tuple(shape)
    canvas = (torch.randn(shape, generator=g_canvas, device=device, dtype=dtype)
              * noise_std).float()
    for _ in range(n_steps):
        extra = reg_noise_std * torch.randn(shape, generator=g_noise, device=device,
                                            dtype=dtype)
        yield canvas + extra.float()


@contextlib.contextmanager
def no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def crop(x: torch.Tensor, spatial: Sequence[int]) -> torch.Tensor:
    idx = [slice(None), slice(None)]
    for d, tgt in zip(x.shape[2:], spatial):
        lo = (d - tgt) // 2
        idx.append(slice(lo, lo + tgt))
    return x[tuple(idx)]


def first_steps(net, params0: Dict[str, torch.Tensor], img: torch.Tensor, mask: torch.Tensor,
                seed: int, padded: Sequence[int], *, dtype: torch.dtype, noise_std: float,
                reg_noise_std: float, lr: float, loss: str = "mae",
                n_steps: int = 3, precision: torch.dtype = torch.float32,
                keep_grad: bool = False) -> Dict[str, object]:
    """``n_steps`` steps of one patch. ``params0``: float32 tensors on the
    device, by name; ``img``, ``mask``: (1, 1, *spatial) float32. Returns
    ``losses`` (one a step), ``grad_norms`` (each parameter's gradient norm
    at the first step) and ``step_norms`` (the norm of each parameter's
    change after the last step), as float64 numbers. ``precision`` float64
    runs the same steps in float64 (the rule that finds the gradients that
    are nought to rounding reads it). ``keep_grad`` adds ``grad0``: each
    parameter's first gradient, float32 on the host."""
    names = list(params0)
    p = [params0[n].detach().clone().to(precision).requires_grad_(True) for n in names]
    mu = [torch.zeros_like(t) for t in p]
    nu = [torch.zeros_like(t) for t in p]
    shape = (1, net.in_channels) + tuple(padded)
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    grad0: Dict[str, torch.Tensor] = {}
    with no_tf32():
        for k, x in enumerate(net_inputs(seed, shape, img.device, dtype, noise_std,
                                         reg_noise_std, n_steps)):
            out = crop(net(dict(zip(names, p)), x.to(precision)), img.shape[2:])
            d = (out - img.to(precision)) * mask.to(precision)
            misfit = (d.abs() if loss in ("mae", "l1") else d * d).sum() / out.numel()
            grads = torch.autograd.grad(misfit, p)
            del out, d, x
            losses.append(float(misfit.detach()))
            if k == 0:
                grad_norms = {n: float(g.double().norm()) for n, g in zip(names, grads)}
                if keep_grad:
                    grad0 = {n: g.detach().float().cpu() for n, g in zip(names, grads)}
            with torch.no_grad():
                bc1, bc2 = 1 - B1 ** (k + 1), 1 - B2 ** (k + 1)
                for t, m, v, g in zip(p, mu, nu, grads):
                    m.mul_(B1).add_(g, alpha=1 - B1)
                    v.mul_(B2).addcmul_(g, g, value=1 - B2)
                    t.sub_(lr * (m / bc1) / (torch.sqrt(v / bc2) + EPS))
            del grads
    step_norms = {n: float((t.detach().double() - params0[n].double()).norm())
                  for n, t in zip(names, p)}
    out = {"losses": losses, "grad_norms": grad_norms, "step_norms": step_norms}
    if keep_grad:
        out["grad0"] = grad0
    return out
