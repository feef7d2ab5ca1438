"""The program's spans against the ``torch.profiler`` Chrome trace of the same
run, and the per-layer readings they give.

The port records spans (``deep_prior_interpolation_tpu_torch/utils/spans.py``:
``solve``, ``solve.prepare``, ``chunk``, ``step``, ``step.forward``,
``step.backward``, ``step.adam``, ``step.track``, ``chunk.read``,
``solve.results`` with its counter ``host_bytes``) on the trace's own clock:
``time.time_ns()`` is ``baseTimeNanoseconds`` + ``ts`` µs. Every kernel, copy
and memset of the trace carries the ``correlation`` id of the runtime call
that launched it; ``read`` puts the activity down to the innermost span open
at that call's host start, on any thread (the autograd engine launches the
backward from a thread of its own, inside the calling thread's
``step.backward``), and a span's device time is the union of its activity's
intervals (cuDNN's grouped convs run kernels side by side). The window and
the busy time are ``tracefile.read``'s (its ``Trace``, passed in or read
here); the idle gaps are the same complement of the busy intervals that it
computes, which its ``Trace`` sums by host call without their bounds, each
named here by the innermost span open at its midpoint (``idle_spans``).
``read`` only reads the file: ``tracefile.read`` of it gives what it gave
before.

``readings`` gives the nine per-layer numbers of the spans: the host's
(``step_host_ms``, ``forward_host_ms``, ``backward_host_ms``: mean spans of
the steps outside the traced chunk, which CUPTI stretches;
``solve_prepare_ms``, ``solve_results_ms``, ``results_host_mib``: means over
the solves) and the device's a traced step (``forward_device_ms``,
``backward_device_ms``, ``update_device_ms``: ``step.adam`` and
``step.track``), the device's None where fewer than 99 % of the traced
kernels fall under a span.
"""
from __future__ import annotations

import json
import statistics
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark.tracefile import _DEVICE, Trace, _union
from benchmark.tracefile import read as read_trace

_LAUNCH = ("cuda_runtime", "cuda_driver")
NO_SPAN = "(no span)"
# the share of the traced kernels that must fall under a span before the
# device's readings are given
COVERED = 0.99


@dataclass
class SpanTrace:
    lo_ns: int                          # the traced window on the spans' clock
    hi_ns: int
    kernels: int                        # kernels in the window
    attributed: int                     # of them, launched inside a span
    steps: int                          # ``step`` spans that overlap the window
    busy_s: float                       # union of the device's intervals
    device_s: Dict[str, float]          # busy time (a union) by the innermost span at launch
    idle_spans: List[Tuple[str, float]]  # idle time by the innermost span, longest first


def _innermost(records: Sequence, instants: Sequence[int]) -> List[Optional[object]]:
    """For each instant (ns), the innermost span open then on any thread: of
    the spans open, the last to start (one thread's spans nest, so the open
    ones form a stack whose top is its innermost); None where none is, or
    where the instant is None."""
    by_start = sorted(records, key=lambda r: (r.start_ns, -r.end_ns))
    stacks: Dict[int, list] = defaultdict(list)
    out: List[Optional[object]] = [None] * len(instants)
    i = 0
    for q in sorted((q for q, t in enumerate(instants) if t is not None),
                    key=instants.__getitem__):
        t = instants[q]
        while i < len(by_start) and by_start[i].start_ns <= t:
            r = by_start[i]
            stack = stacks[r.thread]
            while stack and stack[-1].end_ns < r.start_ns:
                stack.pop()
            stack.append(r)
            i += 1
        best = None
        for stack in stacks.values():
            while stack and stack[-1].end_ns < t:
                stack.pop()
            if stack and (best is None or stack[-1].start_ns > best.start_ns):
                best = stack[-1]
        out[q] = best
    return out


def read(path: str, records: Sequence, trace: Optional[Trace] = None) -> SpanTrace:
    """The spans ``records`` against the trace at ``path`` (whose
    ``tracefile.read`` is ``trace``, read here if not given)."""
    trace = trace if trace is not None else read_trace(path)
    with open(path) as fh:
        doc = json.load(fh)
    base = int(doc.get("baseTimeNanoseconds", 0))
    events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    lo = min(float(e["ts"]) for e in events)   # ``trace``'s window on the trace's clock
    hi = lo + trace.window_s * 1e6

    def ns(us: float) -> int:
        return base + round(us * 1e3)

    launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
              if e.get("cat") in _LAUNCH and "correlation" in e.get("args", {})}
    dev = []                            # (start, end, is a kernel, launch instant)
    for e in events:
        if e.get("cat") not in _DEVICE:
            continue
        a, b = max(float(e["ts"]), lo), min(float(e["ts"]) + float(e.get("dur", 0.0)), hi)
        if b > a:
            at = launch.get(e.get("args", {}).get("correlation"))
            dev.append((a, b, e["cat"] == "kernel", None if at is None else ns(at)))
    by_owner: Dict[str, list] = defaultdict(list)
    attributed = 0
    for (a, b, kernel, _), owner in zip(dev, _innermost(records, [d[3] for d in dev])):
        by_owner[owner.name if owner is not None else NO_SPAN].append((a, b))
        attributed += kernel and owner is not None
    device_s = {n: sum(b - a for a, b in _union(iv)) * 1e-6 for n, iv in by_owner.items()}
    busy = _union([(a, b) for a, b, _, _ in dev])
    gaps: List[Tuple[float, float]] = []
    t = lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    idle: Dict[str, float] = defaultdict(float)
    for (a, b), owner in zip(gaps, _innermost(records, [ns(0.5 * (a + b)) for a, b in gaps])):
        idle[owner.name if owner is not None else NO_SPAN] += (b - a) * 1e-6
    lo_ns, hi_ns = ns(lo), ns(hi)
    return SpanTrace(lo_ns=lo_ns, hi_ns=hi_ns, kernels=sum(1 for d in dev if d[2]),
                     attributed=attributed,
                     steps=sum(1 for r in records if r.name == "step"
                               and r.end_ns >= lo_ns and r.start_ns <= hi_ns),
                     busy_s=trace.busy_s, device_s=device_s,
                     idle_spans=sorted(idle.items(), key=lambda kv: -kv[1]))


def _mean_ms(records: Sequence) -> Optional[float]:
    return (1e-6 * statistics.fmean(r.end_ns - r.start_ns for r in records)
            if records else None)


def readings(records: Sequence, trace: Optional[SpanTrace] = None) -> Dict[str, Optional[float]]:
    """The nine readings of the spans of a window (and of its traced chunk,
    ``trace``); a reading with nothing to read is None."""
    def named(name: str, untraced: bool = False) -> list:
        return [r for r in records if r.name == name and not (
            untraced and trace is not None and r.end_ns >= trace.lo_ns
            and r.start_ns <= trace.hi_ns)]

    results = named("solve.results")
    out = {"step_host_ms": _mean_ms(named("step", True)),
           "forward_host_ms": _mean_ms(named("step.forward", True)),
           "backward_host_ms": _mean_ms(named("step.backward", True)),
           "solve_prepare_ms": _mean_ms(named("solve.prepare")),
           "solve_results_ms": _mean_ms(results),
           "results_host_mib": (statistics.fmean(r.attrs["host_bytes"] for r in results) / 2 ** 20
                                if results else None)}
    covered = (trace is not None and trace.kernels > 0 and trace.steps > 0
               and trace.attributed >= COVERED * trace.kernels)
    for key, names in (("forward_device_ms", ("step.forward",)),
                       ("backward_device_ms", ("step.backward",)),
                       ("update_device_ms", ("step.adam", "step.track"))):
        out[key] = (1e3 * sum(trace.device_s.get(n, 0.0) for n in names) / trace.steps
                    if covered else None)
    return out
