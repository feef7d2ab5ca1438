"""What the benchmark reads from a ``torch.profiler`` Chrome trace.

The traced window is the span of everything the trace recorded: the
profiler starts at the first step of the profiled chunk and stops at the
first step after it (``probes.ChunkTracer``), so it spans the chunk's steps,
its host read and the host's work up to the next step. Device activity is
every kernel, copy and set of memory; the busy time is the union of their
intervals inside the window (overlapping kernels count once), and the idle
gaps are its complement there, each named by the host call open at its
middle.
"""
from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Tuple

_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST = ("cpu_op", "cuda_runtime", "cuda_driver", "python_function")


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float]]          # (name, seconds) of each kernel
    device_ops: List[Tuple[str, float]]       # summed by name, longest first
    idle_gaps: List[Tuple[str, float]]        # summed by host call, longest first


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def read(path: str, top: int = 10) -> Trace:
    with open(path) as fh:
        events = [e for e in json.load(fh).get("traceEvents", []) if e.get("ph") == "X"]
    lo = min(float(e["ts"]) for e in events)
    hi = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in events)
    dev, kernels = [], []
    by_name: Dict[str, float] = defaultdict(float)
    for e in events:
        if e.get("cat") not in _DEVICE:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        dev.append((a, b))
        by_name[e["name"]] += (b - a) * 1e-6
        if e["cat"] == "kernel":
            kernels.append((e["name"], (b - a) * 1e-6))
    busy = _union(dev)
    gaps: List[Tuple[float, float]] = []
    t = lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    # the host's activity at each gap's midpoint: the innermost call open on
    # any thread (the autograd engine runs the backward on a thread of its
    # own). One sweep a thread: the calls of one thread nest, so the open
    # ones form a stack whose top is the innermost.
    threads: Dict[object, List[Tuple[float, float, str]]] = defaultdict(list)
    for e in events:
        if e.get("cat") in _HOST:
            threads[e.get("tid")].append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                                          e["name"]))
    tops: List[List[Tuple[float, float, str]]] = []
    for ops in threads.values():
        ops.sort(key=lambda h: (h[0], -h[1]))
        stack: List[Tuple[float, float, str]] = []
        i, mine = 0, []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            while i < len(ops) and ops[i][0] <= mid:
                while stack and stack[-1][1] < ops[i][0]:
                    stack.pop()
                stack.append(ops[i])
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            mine.append(stack[-1] if stack else None)
        tops.append(mine)
    idle: Dict[str, float] = defaultdict(float)
    for j, (a, b) in enumerate(gaps):
        open_ops = [t[j] for t in tops if t[j] is not None]
        name = max(open_ops, key=lambda h: h[0])[2] if open_ops else "(no host op)"
        idle[name] += (b - a) * 1e-6
    return Trace(window_s=(hi - lo) * 1e-6, busy_s=sum(b - a for a, b in busy) * 1e-6,
                 kernels=kernels,
                 device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
                 idle_gaps=sorted(idle.items(), key=lambda kv: -kv[1])[:top])
