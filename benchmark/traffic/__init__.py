"""The benchmark's inputs: patches, masks, weights and solve seeds, all drawn
from a run's ``--seed``.

A traffic mix is a file ``traffic/<name>.json`` of parameters that
``make_pool`` reads:

* ``entry``: ``solve`` (one patch a solve, ``DIPSolver.solve``) or ``lanes``
  (``lanes`` patches a solve, one a lane, ``solve_patches_batched``);
* ``patch``: the spatial shape (t, x[, y]) of every patch;
* ``lanes``: patches a solve;
* ``events``, ``sigma_t``: hyperbolic events a synthetic patch holds and
  their width in time samples;
* ``decimation``: the share of traces a mask drops (the same traces at every
  time sample);
* ``pool``: distinct solves made up front; the window takes them in turn.

A synthetic patch is the arithmetic of the port's ``data/synthetic.py``
``hyperbolic_events``, copied here so that no change to the program moves
the inputs: per event a zero-offset time t0 ~ U(0.1 nt, 0.85 nt), a velocity
v ~ U(2, 6) and an amplitude ~ +-U(0.5, 1), a Gaussian of ``sigma_t`` samples
around t = sqrt(t0^2 + r^2 / v^2), the sum peak-normalised, then times the
configuration's gain. Patches are made on the device, weights too (one normal
draw of every lane's parameters, scaled by a vector: the configuration's
``xavier`` kernels of gain ``initgain``, zero biases, Norm scales
N(10, 10 * initgain), as the program's own initialiser draws them).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch


def events(n: int, shape: Sequence[int], n_events: int, sigma_t: float,
           rng: np.random.Generator, device) -> torch.Tensor:
    """(n, *shape) float32 patches of hyperbolic events, peak-normalised."""
    nt, *xs = shape
    t0 = rng.uniform(0.1 * nt, 0.85 * nt, (n, n_events))
    v = rng.uniform(2.0, 6.0, (n, n_events))
    amp = rng.uniform(0.5, 1.0, (n, n_events)) * rng.choice([-1.0, 1.0], (n, n_events))
    f32 = dict(dtype=torch.float32, device=device)
    t = torch.arange(nt, **f32).view((nt,) + (1,) * len(xs))
    r2 = torch.zeros(tuple(xs), **f32)
    for i, nx in enumerate(xs):
        x = torch.arange(nx, **f32) - nx / 2
        r2 = r2 + (x ** 2).view(tuple(nx if j == i else 1 for j in range(len(xs))))
    out = torch.zeros((n, nt) + tuple(xs), **f32)
    for b in range(n):
        for e in range(n_events):
            tt = torch.sqrt(float(t0[b, e]) ** 2 + r2 / float(v[b, e]) ** 2)
            out[b] += float(amp[b, e]) * torch.exp(-0.5 * ((t - tt) / sigma_t) ** 2)
    peak = out.abs().flatten(1).amax(1).clamp_min(1e-30)
    return out / peak.view((n,) + (1,) * len(shape))


def trace_masks(n: int, shape: Sequence[int], rate: float,
                rng: np.random.Generator) -> np.ndarray:
    """(n, *shape) float32 masks, each trace kept with probability 1 - rate
    at every time sample."""
    kept = (rng.random((n, 1) + tuple(shape[1:])) >= rate).astype(np.float32)
    return np.repeat(kept, shape[0], axis=1)


def init_vectors(spec, initgain: float):
    """Per-parameter (std, mean) of the initial weights, and each one's size."""
    std, mean, sizes = [], [], []
    for _, shape, kind in spec:
        size = math.prod(shape)
        if kind == "kernel":
            receptive = math.prod(shape[2:])
            fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
            std.append(initgain * math.sqrt(2.0 / (fan_in + fan_out)))
            mean.append(0.0)
        elif kind == "scale":
            std.append(10.0 * initgain)
            mean.append(10.0)
        else:
            std.append(0.0)
            mean.append(0.0)
        sizes.append(size)
    return std, mean, sizes


def weights(spec, lanes: int, seed: int, initgain: float, device) -> torch.Tensor:
    """(lanes, P) float32 initial weights on the CPU, drawn on ``device``,
    parameters in ``spec``'s order."""
    std, mean, sizes = init_vectors(spec, initgain)
    g = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(sizes)
    reps = torch.tensor(sizes, device=device)
    s = torch.repeat_interleave(torch.tensor(std, device=device), reps, output_size=total)
    m = torch.repeat_interleave(torch.tensor(mean, device=device), reps, output_size=total)
    flat = torch.randn((lanes, total), generator=g, device=device) * s + m
    return flat.cpu()


def state_dicts(spec, flat: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
    """One state dict a lane, of views into ``flat`` (lanes, P)."""
    out = []
    for row in flat:
        d, off = {}, 0
        for name, shape, _ in spec:
            n = math.prod(shape)
            d[name] = row[off:off + n].view(shape)
            off += n
        out.append(d)
    return out


@dataclass
class Problem:
    """One solve's inputs: ``imgs``/``masks`` (lanes, *patch, 1) float32,
    lane i seeded ``seed + i``, ``flat`` (lanes, P) its initial weights and
    ``params`` one state dict of views a lane."""
    imgs: np.ndarray
    masks: np.ndarray
    seed: int
    flat: torch.Tensor
    params: List[Dict[str, torch.Tensor]]


def make_pool(traffic: Dict, spec, gain: float, initgain: float, seed: int,
              device) -> List[Problem]:
    rng = np.random.default_rng(int(seed))
    shape, lanes = tuple(traffic["patch"]), int(traffic["lanes"])
    pool = []
    for _ in range(int(traffic["pool"])):
        solve_seed = int(rng.integers(0, 2 ** 40))
        weight_seed = int(rng.integers(0, 2 ** 62))
        vols = events(lanes, shape, int(traffic["events"]), float(traffic["sigma_t"]),
                      rng, device).cpu().numpy()
        masks = trace_masks(lanes, shape, float(traffic["decimation"]), rng)
        flat = weights(spec, lanes, weight_seed, initgain, device)
        pool.append(Problem(imgs=(vols * gain)[..., None].astype(np.float32),
                            masks=masks[..., None], seed=solve_seed, flat=flat,
                            params=state_dicts(spec, flat)))
    return pool

