"""Two probes the harness sets into the program for one solve of the window.

``AdamSpy`` wraps the Adam update of the solver's flat parameters
(``engine/solver.py`` ``_FlatParams.adam_step``): after the first update of
the armed solve it copies the first moment (0.1 times the first gradient, as
the optimiser got it) and after the third the parameters, of every lane,
into host buffers made before the window. The copies are
queued on the device's stream and read once the window has closed.

``ChunkTracer`` wraps the solver's step (``DIPSolver._step``, an attribute of
the one solver object): at the armed solve's first step it starts
``torch.profiler``, and at the first step after one chunk it stops it, so the
trace spans one chunk, its host read and the host's work up to the next
step. It records the device's activity and the host's CUDA calls, not the
host's operators: tracing those too made a traced chunk of the flagship 1.8x
as long as an untraced one, the device's alone 1.26x.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch


class AdamSpy:
    def __init__(self, flat_cls, lanes: int, n_params: int, device: torch.device):
        self.cls, self.orig = flat_cls, flat_cls.adam_step
        pin = device.type == "cuda"
        self.g1 = torch.empty((lanes, n_params), dtype=torch.float32, pin_memory=pin)
        self.p3 = torch.empty((lanes, n_params), dtype=torch.float32, pin_memory=pin)
        self.armed = False
        self.calls = 0
        self.names: Optional[List[str]] = None
        self.sizes: Optional[List[int]] = None
        spy = self

        def adam_step(flat, grads, lr, done, frozen=None):
            spy.orig(flat, grads, lr, done, frozen)
            if spy.armed:
                spy._record(flat)
        flat_cls.adam_step = adam_step

    def _record(self, flat) -> None:
        self.calls += 1
        if self.calls not in (1, 3):
            return
        if self.names is None:
            self.names, self.sizes = list(flat.names), list(flat._sizes)
        src, dst = (flat.mu, self.g1) if self.calls == 1 else (flat.flat, self.p3)
        dst.view_as(src).copy_(src, non_blocking=True)

    def arm(self, on: bool) -> None:
        self.armed, self.calls = on, (0 if on else self.calls)

    def leaves(self, row: torch.Tensor) -> Dict[str, torch.Tensor]:
        out, off = {}, 0
        for n, s in zip(self.names, self.sizes):
            out[n] = row[off:off + s]
            off += s
        return out

    def remove(self) -> None:
        self.cls.adam_step = self.orig


class ChunkTracer:
    def __init__(self, solver, chunk: int, device: torch.device):
        self.solver, self.chunk, self.device = solver, chunk, device
        self.orig = solver._step
        P = torch.profiler.ProfilerActivity
        self.acts = [P.CUDA] if device.type == "cuda" else [P.CPU]
        self.armed = False
        self.prof = None
        self.done = False
        tracer = self

        def step(it, *args, **kwargs):
            if tracer.armed:
                if it == 0 and tracer.prof is None:
                    tracer._start()
                elif it == tracer.chunk and tracer.prof is not None:
                    tracer.stop()
            return tracer.orig(it, *args, **kwargs)
        solver._step = step

    def warm(self) -> None:
        """Start and stop the profiler once, so that its first start is paid
        in set-up."""
        with torch.profiler.profile(activities=self.acts):
            torch.zeros(8, device=self.device).sum()

    def _start(self) -> None:
        self.prof = torch.profiler.profile(activities=self.acts)
        self.prof.start()

    def stop(self) -> None:
        if self.prof is None or self.done:
            return
        self.prof.stop()
        self.armed, self.done = False, True

    def export(self, path: str) -> None:
        self.prof.export_chrome_trace(path)

    def remove(self) -> None:
        del self.solver._step
