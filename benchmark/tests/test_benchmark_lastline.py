"""A run's last line of standard output and last lines of standard error,
as a caller of the benchmark reads them (a tiny cell on the CPU)."""
from __future__ import annotations

import pytest

from benchmark import harness
from conftest import make_tiny, run_cpu


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(tmp_path, trace):
    name = make_tiny(tmp_path, "mrunet3d.solo256")
    rc, res, err = run_cpu(tmp_path, name, trace=trace)
    assert rc == 0
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "check"
    assert isinstance(res["correct"], bool) and res["attempted"] == 1 and res["failed"] == 0
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev) and dev["count"] == 1
    if trace:
        assert {"busy_s", "window_s"} <= set(dev) and dev["window_s"] > 0
        assert set(res["metrics"]) <= set(harness.load_metrics())
        assert {"step_mfu_pct", "solve_setup_ms"} <= set(res["metrics"])
        for part in ("device_ops", "idle_gaps"):
            assert len(res["breakdown"][part]) <= 10
    else:
        assert set(res["metrics"]) == {"patch_iters_per_s", "peak_mem_gib", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    limits = harness.load_cell("mrunet3d.solo256")["workload"]["limits"]
    assert set(res["check"]) == set(limits)
    tail = err.strip().splitlines()[-len(limits):]
    for line, (k, v) in zip(tail, res["check"].items()):
        assert line == f"check {k} {v['value']!r} limit {v['limit']!r}"
