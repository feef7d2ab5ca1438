"""Faults planted under the timed path, to show that the comparison catches
them (``calibrate.py`` on the card, ``tests/test_benchmark_faults.py`` on the
CPU). Each is a context manager that patches the port's solver in this
process and restores it:

* ``frozen``: every Adam update returns the state unchanged;
* ``half``: half of the batch left out, the mean taken over the rest: with
  lanes, the gradient of the second half of the lanes is dropped and the
  first half's taken over its own count; one patch, the misfit over the
  traces of the first half of the last axis, as their mean;
* ``answer``: each step's loss, as the step returns and records it, one
  percent high (its gradient unchanged);
* ``lr``: a wrong optimiser: every Adam update takes 1.25 times the
  configuration's step size.

A cell on one card has no exchange between chips to leave out.
"""
from __future__ import annotations

import contextlib

import torch

NAMES = ("frozen", "half", "answer", "lr")


@contextlib.contextmanager
def planted(name: str, lanes: bool):
    from deep_prior_interpolation_tpu_torch.engine import solver as solver_mod
    S, F = solver_mod.DIPSolver, solver_mod._FlatParams
    saved = [(F, "adam_step", F.__dict__["adam_step"]),
             (S, "_loss_terms", S.__dict__["_loss_terms"]),
             (S, "_lane_forward", S.__dict__["_lane_forward"])]
    orig_adam = F.__dict__["adam_step"]
    orig_terms = S.__dict__["_loss_terms"].__func__
    orig_lanes = S.__dict__["_lane_forward"]
    if name == "frozen":
        F.adam_step = lambda self, grads, lr, done, frozen=None: None
    elif name == "half" and lanes:
        def lane_forward(self, inp, st, data, hyper, s):
            out, loss, ys = orig_lanes(self, inp, st, data, hyper, s)
            keep = torch.arange(loss.shape[0], device=loss.device) < loss.shape[0] // 2
            grad_part = torch.where(keep, (loss - loss.detach()) / keep.sum(),
                                    torch.zeros_like(loss))
            return out, loss.detach() + grad_part, ys
        S._lane_forward = lane_forward
    elif name == "half":
        def loss_terms(out, img, mask, data, hyper, s, out_dtype):
            half = mask.clone()
            half[..., half.shape[-1] // 2:] = 0
            o, loss, ys = orig_terms(out, img, half, data, hyper, s, out_dtype)
            return o, 2 * loss, ys
        S._loss_terms = staticmethod(loss_terms)
    elif name == "answer":
        def loss_terms(out, img, mask, data, hyper, s, out_dtype):
            o, loss, ys = orig_terms(out, img, mask, data, hyper, s, out_dtype)
            return o, loss + 0.01 * loss.detach(), ys
        S._loss_terms = staticmethod(loss_terms)
    elif name == "lr":
        F.adam_step = lambda self, grads, lr, done, frozen=None: orig_adam(
            self, grads, 1.25 * lr, done, frozen)
    else:
        raise ValueError(f"unknown fault {name!r}")
    try:
        yield
    finally:
        for owner, attr, value in saved:
            setattr(owner, attr, value)
