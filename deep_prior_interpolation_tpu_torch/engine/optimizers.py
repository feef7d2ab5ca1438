"""Langevin optimizers (counterpart of ``engine/optimizers.py``).

SGLD: SGD (with momentum, Nesterov and weight decay as ``torch.optim.SGD``
has them) plus Gaussian noise of std ``sqrt(noise_scale)`` in every update.
pSGLD: RMSprop-preconditioned Langevin dynamics, ``V <- beta V + (1 - beta)
g^2``, ``G = sqrt(V) + Lambda``, the update ``-lr g / G`` plus noise of std
``sqrt(2 lr / G)``. Both are ``torch.optim.Optimizer``s whose noise comes
from the explicit ``torch.Generator`` they are given (on the parameters'
device), or one seeded from ``seed``. The JAX package's versions are optax
transformations with the PRNG key in their state; they are exported here
under the same names, ``sgld`` and ``psgld``.
"""
from __future__ import annotations

import math
from typing import Iterable, Optional

import torch

__all__ = ["PSGLD", "SGLD", "psgld", "sgld"]


def _generator(groups: list, generator: Optional[torch.Generator],
               seed: int) -> torch.Generator:
    """``generator``, or one on the first parameter's device seeded from
    ``seed``."""
    if generator is not None:
        return generator
    return torch.Generator(device=groups[0]["params"][0].device).manual_seed(seed)


class SGLD(torch.optim.Optimizer):
    """Stochastic gradient Langevin dynamics: ``p <- p + (-lr d_p +
    sqrt(noise_scale) N(0, 1))``, with torch-SGD momentum (the buffer is
    ``d_p`` itself at the first step, dampening from the second on)."""

    def __init__(self, params: Iterable, lr: float, noise_scale: float = 0.1,
                 momentum: float = 0.0, dampening: float = 0.0, weight_decay: float = 0.0,
                 nesterov: bool = False, generator: Optional[torch.Generator] = None,
                 seed: int = 0):
        if lr < 0.0:
            raise ValueError(f"Invalid learning rate: {lr}")
        if momentum < 0.0:
            raise ValueError(f"Invalid momentum value: {momentum}")
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError("Nesterov momentum requires a momentum and zero dampening")
        super().__init__(params, dict(lr=lr, noise_scale=noise_scale, momentum=momentum,
                                      dampening=dampening, weight_decay=weight_decay,
                                      nesterov=nesterov))
        self.generator = _generator(self.param_groups, generator, seed)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            mom, damp = group["momentum"], group["dampening"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                d_p = p.grad
                if group["weight_decay"]:
                    d_p = d_p + group["weight_decay"] * p
                if mom:
                    state = self.state[p]
                    if "momentum_buffer" not in state:
                        buf = d_p.clone()
                    else:
                        buf = mom * state["momentum_buffer"] + (1 - damp) * d_p
                    state["momentum_buffer"] = buf
                    d_p = d_p + mom * buf if group["nesterov"] else buf
                noise = torch.randn(p.shape, generator=self.generator, device=p.device,
                                    dtype=p.dtype)
                p.add_(-group["lr"] * d_p + math.sqrt(group["noise_scale"]) * noise)
        return loss


class PSGLD(torch.optim.Optimizer):
    """Preconditioned SGLD on RMSprop: ``V <- beta V + (1 - beta) g^2``,
    ``G = sqrt(V) + Lambda`` (``sqrt(V - avg^2) + Lambda`` when
    ``centered``), ``p <- p + (-lr g / G + sqrt(2 lr / G) N(0, 1))``."""

    def __init__(self, params: Iterable, lr: float = 1e-2, beta: float = 0.99,
                 Lambda: float = 1e-8, weight_decay: float = 0.0, centered: bool = False,
                 generator: Optional[torch.Generator] = None, seed: int = 0):
        for name, v in [("learning rate", lr), ("epsilon", Lambda),
                        ("weight_decay", weight_decay), ("beta", beta)]:
            if v < 0.0:
                raise ValueError(f"Invalid {name} value: {v}")
        super().__init__(params, dict(lr=lr, beta=beta, Lambda=Lambda,
                                      weight_decay=weight_decay, centered=centered))
        self.generator = _generator(self.param_groups, generator, seed)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, beta = group["lr"], group["beta"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g + group["weight_decay"] * p
                state = self.state[p]
                if not state:
                    state["V"] = torch.zeros_like(p)
                    if group["centered"]:
                        state["grad_avg"] = torch.zeros_like(p)
                state["V"] = beta * state["V"] + (1 - beta) * g * g
                if group["centered"]:
                    state["grad_avg"] = beta * state["grad_avg"] + (1 - beta) * g
                    G = torch.sqrt(state["V"] - state["grad_avg"] * state["grad_avg"])
                else:
                    G = torch.sqrt(state["V"])
                G = G + group["Lambda"]
                noise = torch.randn(p.shape, generator=self.generator, device=p.device,
                                    dtype=p.dtype)
                p.add_(-lr * g / G + torch.sqrt(2 * lr / G) * noise)
        return loss


# the JAX package's names
sgld = SGLD
psgld = PSGLD
