"""``spantrace``: the program's spans against a small synthetic Chrome trace
(``baseTimeNanoseconds``, runtime calls with ``correlation`` ids on the
main and the autograd thread, kernels and a copy): each phase's device time
a step, ``idle_spans``, the 99 % rule of the device's readings, the host's
readings outside the traced chunk, and ``tracefile.read`` and every
existing metric unchanged by it."""
from __future__ import annotations

import json

import pytest

from benchmark import harness, spantrace, tracefile
from deep_prior_interpolation_tpu_torch.utils.spans import Span

BASE = 1_790_000_000_000_000_000      # ns; the trace's ts are µs after it
MAIN, AUTOGRAD = 101, 102


def _span(name, a_us, b_us, sid, parent, thread=MAIN, **attrs):
    return Span(name, BASE + int(a_us * 1e3), BASE + int(b_us * 1e3), sid, parent, 1, thread,
                attrs)


# one traced step (100-450 µs) inside chunk 0, and one untraced step after it
SPANS = [
    _span("solve", 0, 3000, 1, 0, lanes=1, entry="solve"),
    _span("solve.prepare", 0, 90, 2, 1),
    _span("chunk", 95, 450, 3, 1, c=0),
    _span("step", 100, 400, 4, 3, it=0),
    _span("step.forward", 100, 200, 5, 4),
    _span("step.backward", 200, 300, 6, 4),
    _span("step.adam", 300, 350, 7, 4),
    _span("step.track", 350, 400, 8, 4),
    _span("chunk.read", 400, 450, 9, 3),
    _span("chunk", 1000, 2500, 10, 1, c=1),
    _span("step", 1000, 2000, 11, 10, it=1),
    _span("step.forward", 1000, 1300, 12, 11),
    _span("step.backward", 1300, 1900, 13, 11),
    _span("step.adam", 1900, 1950, 14, 11),
    _span("step.track", 1950, 2000, 15, 11),
    _span("chunk.read", 2000, 2500, 16, 10),
    _span("solve.results", 2500, 3000, 17, 1, host_bytes=3 * 2 ** 20),
]
# (launch µs, thread, call, correlation, device start, end, category)
LAUNCHES = [(110, MAIN, "cudaLaunchKernel", 1, 115, 160, "kernel"),
            (210, AUTOGRAD, "cudaLaunchKernel", 2, 215, 290, "kernel"),
            (310, MAIN, "cudaLaunchKernel", 3, 312, 330, "kernel"),
            (360, MAIN, "cudaLaunchKernel", 4, 365, 370, "kernel"),
            (410, MAIN, "cudaMemcpyAsync", 5, 420, 440, "gpu_memcpy")]


def _trace(path, launches=LAUNCHES):
    ev = [{"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "GPU 0"}}]
    for at, tid, call, corr, a, b, cat in launches:
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": call, "pid": 7, "tid": tid,
                   "ts": float(at), "dur": 3.0, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": cat, "name": f"k{corr}", "pid": 0, "tid": 7,
                   "ts": float(a), "dur": float(b - a), "args": {"correlation": corr}})
    path.write_text(json.dumps({"schemaVersion": 1, "baseTimeNanoseconds": BASE,
                                "traceEvents": ev}))
    return str(path)


def _named(pairs, want):
    """``pairs`` ((name, seconds), ...) are ``want`` to rounding."""
    return ([n for n, _ in pairs] == [n for n, _ in want]
            and [v for _, v in pairs] == pytest.approx([v for _, v in want]))


def test_each_phase_device_time_and_idle_spans(tmp_path):
    st = spantrace.read(_trace(tmp_path / "t.json"), SPANS)
    assert st.kernels == 4 and st.attributed == 4 and st.steps == 1
    assert (st.lo_ns, st.hi_ns) == (BASE + 110_000, BASE + 440_000)
    want = {"step.forward": 45e-6, "step.backward": 75e-6, "step.adam": 18e-6,
            "step.track": 5e-6, "chunk.read": 20e-6}
    assert st.device_s == pytest.approx(want)
    assert st.busy_s == pytest.approx(sum(want.values()))
    # the gaps 110-115 and 160-215 (forward), 290-312 and 330-365 (adam),
    # 370-420 (track)
    assert _named(st.idle_spans, [("step.forward", 60e-6), ("step.adam", 57e-6),
                                  ("step.track", 50e-6)])
    r = spantrace.readings(SPANS, st)
    assert r == pytest.approx({
        "forward_device_ms": 0.045, "backward_device_ms": 0.075, "update_device_ms": 0.023,
        "step_host_ms": 1.0, "forward_host_ms": 0.3, "backward_host_ms": 0.6,
        "solve_prepare_ms": 0.09, "solve_results_ms": 0.5, "results_host_mib": 3.0})


def test_overlapping_kernels_count_once(tmp_path):
    """Two backward kernels side by side (215-260 and 230-290 µs) are 75 µs
    of the backward's device time, as of the busy time."""
    launches = [(210, AUTOGRAD, "cudaLaunchKernel", 1, 215, 260, "kernel"),
                (220, AUTOGRAD, "cudaLaunchKernel", 2, 230, 290, "kernel")]
    st = spantrace.read(_trace(tmp_path / "t.json", launches), SPANS)
    assert st.device_s == pytest.approx({"step.backward": 75e-6})
    assert st.busy_s == pytest.approx(75e-6)


@pytest.mark.parametrize("outside, silent", [(0, False), (1, False), (2, True)])
def test_the_device_readings_need_99_percent_of_the_kernels(tmp_path, outside, silent):
    """100 kernels of the forward, ``outside`` of them launched after every
    span has closed: the device's readings are given at 99 % and above."""
    launches = [(110 + k / 2, MAIN, "cudaLaunchKernel", k + 1, 115 + k / 2, 115.25 + k / 2,
                 "kernel") for k in range(100 - outside)]
    launches += [(3100 + k, MAIN, "cudaLaunchKernel", 200 + k, 3105 + k, 3105.5 + k, "kernel")
                 for k in range(outside)]
    st = spantrace.read(_trace(tmp_path / "t.json", launches), SPANS)
    assert (st.kernels, st.attributed) == (100, 100 - outside)
    r = spantrace.readings(SPANS, st)
    assert (r["forward_device_ms"] is None) is silent
    # the window reaches the second step where a kernel lies outside
    assert st.steps == (1 if outside == 0 else 2)
    assert r["forward_device_ms"] is None or r["forward_device_ms"] == pytest.approx(
        (100 - outside) * 0.25e-3 / st.steps)
    assert r["solve_results_ms"] == pytest.approx(0.5)


def test_without_a_trace_only_the_host_reads(tmp_path):
    r = spantrace.readings(SPANS)
    assert r["step_host_ms"] == pytest.approx(0.65)      # both steps
    assert [k for k, v in r.items() if v is None] == [
        "forward_device_ms", "backward_device_ms", "update_device_ms"]
    assert all(v is None for v in spantrace.readings([]).values())


def test_the_existing_readers_are_unchanged(tmp_path):
    path = _trace(tmp_path / "t.json")
    before_bytes = (tmp_path / "t.json").read_bytes()

    def existing():
        rec = harness.Record(solves=[{"wall": 3e-3, "chunk_s": [3.55e-4, 1.5e-3]}],
                             window_s=1.0, lane_iters=2, lanes=1, peak="bf16",
                             counts={"step_flops": 1e9, "wgrad": (1e6, 1e6), "wgrad_convs": 0,
                                     "upsample_bwd": (1e6, 1e6), "fused_loss": (1e6, 1e6)},
                             trace=tracefile.read(path), steps_traced=1)
        return rec.trace, {n: m.read(rec) for n, m in harness.load_metrics().items()}

    trace0, metrics0 = existing()
    st = spantrace.read(path, SPANS)
    trace1, metrics1 = existing()
    # the window and busy time are tracefile's, and so is the idle time
    assert st.busy_s == trace0.busy_s
    assert (st.hi_ns - st.lo_ns) * 1e-9 == pytest.approx(trace0.window_s)
    assert sum(s for _, s in st.idle_spans) == pytest.approx(
        sum(s for _, s in trace0.idle_gaps))
    assert spantrace.read(path, SPANS, trace0) == st
    assert (tmp_path / "t.json").read_bytes() == before_bytes
    assert trace1 == trace0 and metrics1 == metrics0
    assert _named(trace0.idle_gaps, [("(no host op)", 162e-6), ("cudaLaunchKernel", 5e-6)])
