"""One run of a benchmark cell with the port's span recorder on, and what
the spans read.

    python3 scripts/torch_span_readings.py --workload <cell> --seed <n> \\
        --seconds 51 --trace <0|1> --spans <0|1> [--out FILE]

Runs ``benchmark/harness.py`` as ``benchmark/run.py`` does, in this process,
with the recorder (``deep_prior_interpolation_tpu_torch/utils/spans.py``)
turned on after the warm-up (``--spans 1``), and reads the window's spans
after it: with ``--trace 1`` against the traced chunk's Chrome trace, read
(``benchmark/spantrace.py``) before the harness deletes it. ``--spans 0``
is the harness's run unchanged, for the recorder's cost against it. The last
line of standard output is one JSON object (also appended to ``--out``):
the harness's result line, the nine readings (``spantrace.readings``), the
Norms a step on the kernel and the plain route and those with LeakyReLU
inside the kernel (``norms``), the weight gradients a step of the 3D
stride-1 convs on the wgrad kernel and in the library (``wgrads``), the
steps by how their forward and backward ran (``graph``: the ``step``
spans' ``step_graph``, eager, captured or replayed from the solve's CUDA
graph, the replayed share and the mean ``step.replay`` span outside the
traced chunk) and the checks of the spans against the clocks around them:

* ``attributed``: the share of the traced chunk's kernels launched inside a
  span; ``idle_named_s`` against ``idle_no_host_op_s``: the traced idle
  time ``idle_spans`` names against what ``idle_gaps`` calls "(no host
  op)"; ``device_phases_gap``: forward + backward + update device time a
  step against the traced busy time a step less what ``chunk.read``
  launched, relative;
* ``solve_sum_gap``: the worst untraced solve's ``solve.prepare`` + its
  chunks + ``solve.results`` against the harness's wall of it, relative;
  ``chunk_sum_gap``: the worst chunk's ``chunk.read`` + its steps against
  the chunk, over the untraced solves (the profiler starts and stops inside
  the traced solve's chunks, outside their steps);
* ``clock``: with ``--trace 1`` on a card, the offset of the trace's clock
  from the spans' (``time.time_ns()``) that 200 spans, each around one
  kernel launch, allow: the launch's runtime call lies inside its span
  for any offset in ``[lo_us, hi_us]``.

Run from the root of a checkout, on a card. It stands in for the harness,
which does not turn the recorder on: it replaces ``harness.warm_up`` and
``probes.ChunkTracer.export`` in this process, so it goes, with those
patches, once the harness records the spans and reads them itself.
"""
from __future__ import annotations

import argparse
import collections
import io
import json
import os
import statistics
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


class _Tee(io.StringIO):
    def __init__(self, real):
        super().__init__()
        self.real = real

    def write(self, s):
        self.real.write(s)
        return super().write(s)


def clock_offset(n: int = 200) -> dict:
    """The offsets (µs, trace clock minus span clock) for which every one of
    ``n`` runtime calls lies inside the span stamped around it."""
    import tempfile
    import torch
    from deep_prior_interpolation_tpu_torch.utils import spans

    x = torch.zeros(1 << 16, device="cuda")
    was_on = spans.on
    spans.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            with spans.span("clock", "i", i):
                x.add_(1.0)
        torch.cuda.synchronize()
    if not was_on:
        spans.disable()
    probes = sorted((r for r in spans.drain() if r.name == "clock"), key=lambda r: r.start_ns)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            doc = json.load(fh)
    base = int(doc.get("baseTimeNanoseconds", 0))
    calls = sorted((e for e in doc["traceEvents"] if e.get("ph") == "X"
                    and e.get("cat") == "cuda_runtime" and "Launch" in e.get("name", "")),
                   key=lambda e: e["ts"])[-n:]
    lo = max(r.start_ns - (base + e["ts"] * 1e3) for r, e in zip(probes, calls))
    hi = min(r.end_ns - (base + (e["ts"] + e["dur"]) * 1e3) for r, e in zip(probes, calls))
    return {"calls": len(calls), "lo_us": lo * 1e-3, "hi_us": hi * 1e-3,
            "base_ns": base, "torch": torch.__version__}


def checks(records, result: dict, walls, tr) -> dict:
    """The spans against the clocks around them (the module's docstring)."""
    from benchmark import spantrace
    # the traced solve is left out of the sums: the profiler's start and
    # stop lie in its chunks, outside its steps
    traced_solves = {r.solve for r in records if tr is not None
                     and r.end_ns >= tr.lo_ns and r.start_ns <= tr.hi_ns}
    out = {}
    if tr is not None:
        no_host = dict(map(tuple, result.get("breakdown", {}).get("idle_gaps", [])))
        steps = max(tr.steps, 1)
        phases = sum(tr.device_s.get(n, 0.0) for n in
                     ("step.forward", "step.backward", "step.adam", "step.track"))
        busy = tr.busy_s - tr.device_s.get("chunk.read", 0.0)
        out.update(attributed=tr.attributed / max(tr.kernels, 1), kernels=tr.kernels,
                   steps=tr.steps,
                   idle_named_s=sum(s for n, s in tr.idle_spans if n != spantrace.NO_SPAN),
                   idle_no_host_op_s=no_host.get("(no host op)", 0.0),
                   busy_per_step_ms=1e3 * busy / steps,
                   phases_per_step_ms=1e3 * phases / steps,
                   device_phases_gap=abs(phases - busy) / busy if busy > 0 else None)
    kids = {}
    for r in records:
        kids.setdefault(r.parent, []).append(r)

    def dur(rs):
        return sum(r.end_ns - r.start_ns for r in rs)

    solves = sorted((r for r in records if r.name == "solve"), key=lambda r: r.start_ns)
    gaps = []
    for k, sv in enumerate(solves):
        parts = [r for r in kids.get(sv.id, []) if r.name in
                 ("solve.prepare", "chunk", "solve.results")]
        if k < len(walls) and sv.solve not in traced_solves:
            gaps.append(abs(dur(parts) * 1e-9 - walls[k]) / walls[k])
    chunk_gaps = [abs(dur(kids.get(c.id, [])) - dur([c])) / dur([c])
                  for c in records if c.name == "chunk" and c.solve not in traced_solves]
    out.update(solves=len(solves), walls=len(walls),
               solve_sum_gap=max(gaps) if gaps else None,
               chunk_sum_gap=max(chunk_gaps) if chunk_gaps else None)
    return out


def _counted(records, name: str, key: str) -> list:
    """The attributes of the spans that count a step's ``key``: ``name``,
    or a replay of the step graph, which carries the captured step's."""
    return [r.attrs for r in records if r.name == name
            or (r.name == "step.replay" and key in r.attrs)]


def norm_routes(records) -> dict:
    """The Norms of the window's steps by route (``step.forward``'s
    ``norm_kernel`` and ``norm_plain``, or a replay's): a step's counts, the
    kernel's share of all, and a step's Norms whose LeakyReLU ran inside the
    kernel (``norm_act_fused``)."""
    fwd = _counted(records, "step.forward", "norm_kernel")
    k = sum(a.get("norm_kernel", 0) for a in fwd)
    p = sum(a.get("norm_plain", 0) for a in fwd)
    f = sum(a.get("norm_act_fused", 0) for a in fwd)
    return {"steps": len(fwd), "kernel_per_step": k / max(len(fwd), 1),
            "plain_per_step": p / max(len(fwd), 1),
            "fused_per_step": f / max(len(fwd), 1),
            "kernel_share": k / (k + p) if k + p else None}


def wgrad_routes(records) -> dict:
    """The weight gradients of the window's steps' 3D stride-1 convs of k > 1
    by route (``step.backward``'s ``wgrad_kernel`` and ``wgrad_library``, or
    a replay's), a step's counts."""
    bwd = _counted(records, "step.backward", "wgrad_kernel")
    n = max(len(bwd), 1)
    return {"steps": len(bwd),
            "kernel_per_step": sum(a.get("wgrad_kernel", 0) for a in bwd) / n,
            "library_per_step": sum(a.get("wgrad_library", 0) for a in bwd) / n}


def graph_routes(records, tr=None) -> dict:
    """The window's steps by how their forward and backward ran (the
    ``step`` spans' ``step_graph``), the share replayed from a solve's CUDA
    graph, and the mean ``step.replay`` span (ms) of the replayed steps
    outside the traced chunk (``tr``), which CUPTI stretches."""
    steps = [r for r in records if r.name == "step"]
    routes = collections.Counter(r.attrs.get("step_graph") for r in steps)
    replayed = {r.id for r in steps if r.attrs.get("step_graph") == "replayed"}
    replays = [r.end_ns - r.start_ns for r in records if r.name == "step.replay"
               and r.parent in replayed
               and not (tr is not None and r.end_ns >= tr.lo_ns and r.start_ns <= tr.hi_ns)]
    return {"routes": dict(routes),
            "replayed_share": routes["replayed"] / len(steps) if steps else None,
            "replay_ms": 1e-6 * statistics.fmean(replays) if replays else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from benchmark import harness, probes, spantrace
    from deep_prior_interpolation_tpu_torch.utils import spans

    kept = {}
    if args.spans:
        warm_up = harness.warm_up

        def warm_then_record(*a, **kw):
            out = warm_up(*a, **kw)
            spans.enable()
            return out
        harness.warm_up = warm_then_record
        export = probes.ChunkTracer.export

        def export_and_read(self, path):
            export(self, path)
            kept["trace"] = spantrace.read(path, list(spans.records))
        probes.ChunkTracer.export = export_and_read

    out = io.StringIO()
    err = _Tee(sys.stderr)
    real_err, sys.stderr = sys.stderr, err
    try:
        rc = harness.run(["--workload", args.workload, "--seed", str(args.seed), "--seconds",
                          str(args.seconds), "--trace", str(args.trace)],
                         t_start=T_START, out=out)
    finally:
        sys.stderr = real_err
        spans.disable()
    records = spans.drain()
    lines = out.getvalue().strip().splitlines()
    result = json.loads(lines[-1]) if lines else None
    walls = next((json.loads(ln)["solve_walls"] for ln in err.getvalue().splitlines()
                  if ln.startswith("{") and "solve_walls" in ln), [])
    line = {"workload": args.workload, "seed": args.seed, "trace": args.trace,
            "spans": args.spans, "rc": rc, "result": result}
    if args.spans and rc == 0:
        tr = kept.get("trace")
        line["readings"] = spantrace.readings(records, tr)
        line["norms"] = norm_routes(records)
        line["wgrads"] = wgrad_routes(records)
        line["graph"] = graph_routes(records, tr)
        line["checks"] = checks(records, result, walls, tr)
        if tr is not None:
            line["idle_spans"] = tr.idle_spans
            line["device_s"] = tr.device_s
        import torch
        if args.trace and torch.cuda.is_available():
            line["clock"] = clock_offset()
    text = json.dumps(line)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(text + "\n")
    print(text)
    return rc


if __name__ == "__main__":
    sys.exit(main())
