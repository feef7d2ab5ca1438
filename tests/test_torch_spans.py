"""The port's spans (utils/spans.py) on the CPU: off by default and then
silent; the tree a solve emits through each of its three entries
(``DIPSolver.solve``, the same over spatial shards, ``solve_patches_batched``)
at 2 chunks x 2 steps of a tiny 3D MulResUnet; the chunk spans as
``SolveResult.chunk_seconds``; the results' counter of host bytes; the
trace of ``--profile`` (``engine/solver._profiled``) with the spans in it;
and the same losses and parameters, bit for bit, with the recorder on and
off. Pure Python: no JAX."""
import json
import os
import re

import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.engine.solver import host_bytes
from deep_prior_interpolation_tpu_torch.parallel import solve_patches_batched
from deep_prior_interpolation_tpu_torch.utils import spans

torch.set_num_threads(1)
CPU = torch.device("cpu")
ENTRIES = ("solve", "spatial", "batched")
STEP_PHASES = ["step.forward", "step.backward", "step.adam", "step.track"]


def _problem(seed):
    rng = np.random.RandomState(seed)
    img = rng.randn(8, 16, 16, 1).astype(np.float32)
    mask = np.repeat((rng.rand(1, 16, 16, 1) > 0.4).astype(np.float32), 8, 0)
    return img, mask


def _cfg(**kw):
    return Config(**{**dict(datadim="3d", epochs=4, scan_chunk=2, inputdepth=4,
                            filters=[4, 8], skip=[4], gain=1.0), **kw})


def _solve(entry, **kw):
    solver = DIPSolver(_cfg(**kw), 1, device=CPU)
    if entry == "batched":
        patches = [dict(zip(("image", "mask"), _problem(i))) for i in (0, 1)]
        return solve_patches_batched(solver.cfg, solver, patches)
    return [solver.solve(*_problem(0), seed=3,
                         spatial_mesh=[CPU] * 2 if entry == "spatial" else None)]


@pytest.fixture(scope="module")
def runs():
    """Each entry solved with the recorder off, then on: (results off,
    results on, the spans the off solve left, the spans of the on one)."""
    out = {}
    for entry in ENTRIES:
        off = _solve(entry)
        left = spans.drain()
        spans.enable()
        try:
            on = _solve(entry)
        finally:
            spans.disable()
        out[entry] = (off, on, left, spans.drain())
    return out


def test_off_by_default_and_then_silent(runs):
    assert spans.on is False
    assert spans.span("step", "it", 0) is spans.span("chunk.read")
    with spans.span("solve"):
        spans.attr("host_bytes", 1)
    assert not spans.records
    assert all(left == [] for _, _, left, _ in runs.values())


@pytest.mark.parametrize("entry", ENTRIES)
def test_a_solve_emits_the_tree(runs, entry):
    recs = runs[entry][3]
    by_id = {r.id: r for r in recs}
    names = [r.name for r in recs]
    assert sorted(set(names)) == sorted(
        ["solve", "solve.prepare", "chunk", "chunk.read", "solve.results", "step"]
        + STEP_PHASES)
    (solve,) = [r for r in recs if r.name == "solve"]
    assert solve.parent == 0 and solve.attrs == {"lanes": 2 if entry == "batched" else 1,
                                                 "entry": entry}
    assert {r.solve for r in recs} == {solve.id}
    assert len({r.thread for r in recs}) == 1
    top = sorted((r for r in recs if r.parent == solve.id), key=lambda r: r.start_ns)
    assert [r.name for r in top] == ["solve.prepare", "chunk", "chunk", "solve.results"]
    assert [r.attrs for r in top[1:3]] == [{"c": 0}, {"c": 1}]
    steps = [r for r in recs if r.name == "step"]
    assert [r.attrs["it"] for r in sorted(steps, key=lambda r: r.start_ns)] == [0, 1, 2, 3]
    for chunk in top[1:3]:
        kids = sorted((r for r in recs if r.parent == chunk.id), key=lambda r: r.start_ns)
        assert [r.name for r in kids] == ["step", "step", "chunk.read"]
    for step in steps:
        kids = sorted((r for r in recs if r.parent == step.id), key=lambda r: r.start_ns)
        assert [r.name for r in kids] == STEP_PHASES
        assert all(by_id[r.parent].name == "step" for r in recs if r.name in STEP_PHASES)
    for r in recs:   # every span lies inside its parent, and ends after it starts
        assert r.start_ns <= r.end_ns
        if r.parent:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns


@pytest.mark.parametrize("entry", ENTRIES)
def test_the_chunk_spans_are_chunk_seconds(runs, entry):
    off, on, _, recs = runs[entry]
    chunks = sorted((r for r in recs if r.name == "chunk"), key=lambda r: r.attrs["c"])
    for res in on:
        assert res.chunk_seconds == [(r.end_ns - r.start_ns) * 1e-9 for r in chunks]
    assert all(len(res.chunk_seconds) == 2 for res in off)


@pytest.mark.parametrize("entry", ENTRIES)
def test_host_bytes_are_the_results_arrays(runs, entry):
    on, recs = runs[entry][1], runs[entry][3]
    (results,) = [r for r in recs if r.name == "solve.results"]
    arrays = [a for res in on for a in (res.out_best, res.noise, res.pocs) if a is not None]
    arrays += [t.numpy() for res in on for t in res.params.values()]
    assert results.attrs == {"host_bytes": sum(a.nbytes for a in arrays)}
    assert host_bytes(on) == results.attrs["host_bytes"] > on[0].noise.nbytes


@pytest.mark.parametrize("entry", ENTRIES)
def test_the_recorder_changes_no_bit(runs, entry):
    off, on = runs[entry][:2]
    for a, b in zip(off, on):
        assert np.array_equal(a.history.loss, b.history.loss)
        assert np.array_equal(a.out_best, b.out_best)
        assert a.params.keys() == b.params.keys()
        assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)


def test_profile_writes_the_spans_into_its_trace(tmp_path):
    """``profile_dir`` traces the second chunk: its trace holds that chunk's
    spans as ``X`` events on the trace's clock, inside the traced window;
    ``ops.txt`` keeps its header, the busy share a union (at most 1); the
    recorder is off again and holds nothing after."""
    solver = DIPSolver(_cfg(epochs=6), 1, device=CPU)
    res = solver.solve(*_problem(0), seed=3, profile_dir=str(tmp_path))
    assert spans.on is False and not spans.records
    with open(tmp_path / "trace.json") as fh:
        trace = json.load(fh)
    ev = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    mine = [e for e in ev if e.get("cat") == "program_span"]
    assert sorted(e["name"] for e in mine) == sorted(
        ["chunk", "chunk.read"] + ["step"] * 2 + STEP_PHASES * 2)
    (chunk,) = [e for e in mine if e["name"] == "chunk"]
    assert chunk["args"]["c"] == 1 and chunk["tid"] == next(
        e["tid"] for e in ev if e.get("cat") == "cpu_op")
    assert abs(chunk["dur"] * 1e-6 - res.chunk_seconds[1]) < 1e-6
    ops = [e for e in ev if e.get("cat") == "cpu_op"]
    assert chunk["ts"] <= min(e["ts"] for e in ops)
    assert max(e["ts"] + e["dur"] for e in ops) <= chunk["ts"] + chunk["dur"]
    head = (tmp_path / "ops.txt").read_text().splitlines()[0]
    m = re.fullmatch(r"window ([\d.]+) ms, cpu ops ([\d.]+) ms, busy share ([\d.]+)", head)
    assert m and 0 < float(m.group(3)) <= 1.0
    # the window is the traced chunk, not the profiler's session around it
    assert abs(float(m.group(1)) - 1e3 * res.chunk_seconds[1]) <= 5e-4 + 1e-9
    assert os.path.getsize(tmp_path / "trace.json") > 0
