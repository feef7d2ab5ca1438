"""One run of one cell of the port's benchmark.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is ``workloads/<cell>.json``: a configuration (``configs/<name>.json``:
the ``Config`` of the port, the environment switches, the peak, the source
and what was cut), a traffic mix (``traffic/<name>.json``) and the limits of
the comparison that decides ``correct``.

Set-up: import the port, start its kernel builds, make the pool of solves'
inputs from the seed (``traffic.make_pool``), build the solver and warm every
shape of the cell by one solve of two iterations through the cell's entry.
The window: solves of the cell, one after another, each with its own
patches, weights and seed from the pool, until ``--seconds`` have passed; it
runs from the first solve's start to the last solve's end. ``--trace 1``
profiles the first chunk of the window's first solve (``probes.ChunkTracer``)
and reports the per-layer metrics (``metrics/``) instead of the end-to-end
ones. After the window the plain reference (``reference/``) follows the first
three steps of the window's first solve, lane by lane, and ``check`` compares
them with what the program produced (``probes.AdamSpy``).

The last line of standard output is the result; the last lines of standard
error are the numbers compared, each beside its limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import math
import os
import shutil
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "deep_prior_interpolation_tpu")
# what the comparison reads (see check); a cell's ``limits`` name the ones
# it compares
READINGS = ("loss0_gap", "loss_gap", "grad_gap", "grad_gap_median", "step_gap",
            "step_gap_median")


def cache_env() -> Dict[str, str]:
    """Fixed directories inside the checkout for every build and kernel
    cache a run could fill (the port builds its kernels into
    ``build/torch_kernels`` by itself)."""
    base = CHECKOUT / "build" / "benchmark_cache"
    return {"TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "TRITON_CACHE_DIR": str(base / "triton"),
            "CUDA_CACHE_PATH": str(base / "cuda")}


def plan_cache() -> Path:
    """The file that keeps the wgrad kernel's tuned grids between runs of a
    checkout, named by a hash of the kernel's sources, so that a changed
    kernel is tuned again."""
    import hashlib
    import deep_prior_interpolation_tpu_torch as pkg
    root = Path(pkg.__file__).resolve().parent
    h = hashlib.sha256()
    for rel in ("ops/wgrad.py", "csrc/wgrad3d.cu"):
        h.update((root / rel).read_bytes())
    return HERE / ".cache" / f"wgrad_plans-{h.hexdigest()[:16]}.json"


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _json(kind: str, name: str, extra: Optional[Path]) -> Dict:
    """``<kind>/<name>.json``, or ``<extra>/<name>.json`` where that exists."""
    path = extra / f"{name}.json" if extra is not None else None
    if path is None or not path.exists():
        path = HERE / kind / f"{name}.json"
    with open(path) as fh:
        return json.load(fh)


def load_cell(name: str, extra_dir: Optional[Path] = None) -> Dict:
    """The cell's workload, configuration and traffic files, found by name;
    ``extra_dir`` (tests) is searched first."""
    w = _json("workloads", name, extra_dir)
    return {"name": name, "workload": w, "config": _json("configs", w["config"], extra_dir),
            "traffic": _json("traffic", w["traffic"], extra_dir)}


def reference_net(cell: Dict, quant: Optional[str] = None):
    c = cell["config"]["config"]
    mod = importlib.import_module(f"benchmark.reference.{cell['config']['reference']}")
    ndim = 3 if c["datadim"] == "3d" else 2
    return mod.MulResUnet(c["inputdepth"], 1, ndim, c["filters"], c["skip"],
                          upsample=c["upsample"], quant=quant)


def padded_shape(cell: Dict) -> List[int]:
    """The canvas's spatial shape: the patch padded to a multiple of 2^L for
    the net's L stride-2 levels."""
    mult = 2 ** (len(cell["config"]["config"]["filters"]) - 1)
    return [int(math.ceil(d / mult)) * mult for d in cell["traffic"]["patch"]]


@dataclass
class Record:
    """What the per-layer metrics read."""
    solves: List[Dict]
    window_s: float
    lane_iters: int
    lanes: int
    peak: str
    counts: Dict
    trace: Optional[object] = None
    steps_traced: int = 0


def load_metrics() -> Dict[str, object]:
    out = {}
    for f in sorted((HERE / "metrics").glob("*.py")):
        if not f.stem.startswith("_"):
            out[f.stem] = importlib.import_module(f"benchmark.metrics.{f.stem}")
    return out


def cell_counts(cell: Dict) -> Dict:
    from benchmark import counts
    net = reference_net(cell)
    padded = padded_shape(cell)
    lay = counts.layers(net, padded)
    elem = 2 if cell["config"]["config"]["dtype"] == "bfloat16" else 4
    n_out = math.prod(cell["traffic"]["patch"])
    return {"step_flops": counts.step_flops(net, padded, cell["traffic"]["patch"]),
            "wgrad": counts.wgrad(lay, elem), "wgrad_convs": len(counts.wgrad_convs(lay)),
            "upsample_bwd": counts.upsample_bwd(lay, elem),
            "fused_loss": counts.fused_loss(n_out, elem)}


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reference_lanes(cell: Dict, problem, device, quant: Optional[str] = None,
                    precision=None, keep_grad: bool = False) -> List[Dict]:
    """The reference's first three steps of every lane of ``problem``
    (``reference.steps.first_steps``), computed in float32, or with
    ``quant`` in that emulated precision (the control), or in ``precision``
    (``calibrate.py``), and ``counted``: the parameters whose first gradient
    is not nought to rounding, that is at least a thousandth of the median
    parameter's in the reference's first step in float64 (a conv bias under
    a Norm has none)."""
    import numpy as np
    import torch
    from benchmark.reference import steps as ref_steps
    c = cell["config"]["config"]
    net, net64 = reference_net(cell, quant), reference_net(cell)
    kw = dict(dtype=torch.bfloat16 if c["dtype"] == "bfloat16" else torch.float32,
              noise_std=c["noise_std"], reg_noise_std=c["reg_noise_std"], lr=c["lr"],
              loss=c["loss"])
    padded = padded_shape(cell)
    precision = precision or torch.float32

    def chan_first(a):
        return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 0)[None])).to(device)

    out = []
    for j in range(problem.imgs.shape[0]):
        params0 = {n: t.to(device) for n, t in problem.params[j].items()}
        img, mask = chan_first(problem.imgs[j]), chan_first(problem.masks[j])
        ref = ref_steps.first_steps(net, params0, img, mask, problem.seed + j, padded,
                                    precision=precision, keep_grad=keep_grad, **kw)
        exact = ref if precision == torch.float64 else ref_steps.first_steps(
            net64, params0, img, mask, problem.seed + j, padded, n_steps=1,
            precision=torch.float64, **kw)
        med = statistics.median(exact["grad_norms"].values())
        ref["counted"] = [n for n, v in exact["grad_norms"].items() if v >= 1e-3 * med]
        out.append(ref)
        del params0
    return out


def program_lanes(problem, histories: List[List[float]], spy) -> List[Dict]:
    """What the program produced in each lane of its checked solve: each
    step's loss from its history, each parameter's first-gradient norm (from
    Adam's first moment after one update: 0.1 times the gradient) and the
    norm of its change after three updates (from the parameters then)."""
    out = []
    for j, hist in enumerate(histories):
        p0 = problem.params[j]
        out.append({"losses": list(hist),
                    "grad_norms": {n: float((t.double() / 0.1).norm())
                                   for n, t in spy.leaves(spy.g1[j]).items()},
                    "step_norms": {n: float((t.double() - p0[n].double().reshape(-1)).norm())
                                   for n, t in spy.leaves(spy.p3[j]).items()}})
    return out


def compare(prog: List[Dict], ref: List[Dict]) -> Dict[str, float]:
    """What the comparison reads, lane by lane, the largest over the lanes:

    * ``loss0_gap``: the relative gap of the first step's loss (the forward
      alone); ``loss_gap`` the largest of the second and third steps' (one
      and two updates in);
    * ``grad_gap``: the worst parameter's gap between the norms of the first
      gradient, the program's and the reference's, over the larger of the
      reference's norm of that parameter and of the median parameter;
      ``grad_gap_median``: the median parameter's gap;
    * ``step_gap``, ``step_gap_median``: the same of the parameters' change
      after three updates.

    The norm gaps count only the reference's ``counted`` parameters."""
    gaps = {k: 0.0 for k in READINGS}

    def worse(key: str, gap: float) -> None:
        gaps[key] = max(gaps[key], gap if math.isfinite(gap) else math.inf)

    for p, r in zip(prog, ref):
        for k, lr_ in enumerate(r["losses"]):
            lp = p["losses"][k] if k < len(p["losses"]) else float("nan")
            worse("loss0_gap" if k == 0 else "loss_gap", abs(lp - lr_) / abs(lr_))
        for key in ("grad", "step"):
            leaf = list(leaf_gaps(p, r, key).values())
            worse(f"{key}_gap", max(leaf))
            worse(f"{key}_gap_median", statistics.median(leaf))
    return gaps


def leaf_gaps(p: Dict, r: Dict, key: str) -> Dict[str, float]:
    """Each counted parameter's gap of the ``key`` ("grad" or "step") norms,
    as ``compare`` reads it."""
    pv, rv = p[f"{key}_norms"], r[f"{key}_norms"]
    med = statistics.median(rv[n] for n in r["counted"])
    return {n: abs(pv[n] - rv[n]) / max(rv[n], med) for n in r["counted"]}


def entry(cell: Dict):
    """``solve(cfg, solver, problem)``: one solve of ``problem`` through the
    cell's entry; a list of ``SolveResult``, one a lane."""
    from deep_prior_interpolation_tpu_torch.parallel.mesh import solve_patches_batched
    tr = cell["traffic"]
    lanes = int(tr["lanes"])

    def solve(cfg, solver, prob):
        if tr["entry"] == "solve":
            return [solver.solve(prob.imgs[0], prob.masks[0], seed=prob.seed,
                                 init_params=prob.params[0])]
        patches = [{"image": prob.imgs[i], "mask": prob.masks[i]} for i in range(lanes)]
        return solve_patches_batched(dataclasses.replace(cfg, seed=prob.seed), solver,
                                     patches, init_params=prob.params)
    return solve


def warm_up(cell: Dict, cfg, solver, problem):
    """One solve of two iterations of ``problem`` through the cell's entry,
    in chunks of two: every shape the cell's solves use, every kernel the
    wrappers build or tune for them."""
    from deep_prior_interpolation_tpu_torch.engine.solver import DIPSolver
    warm_cfg = dataclasses.replace(cfg, epochs=2, scan_chunk=2)
    slv = solver
    if cell["traffic"]["entry"] == "solve":
        slv = DIPSolver(warm_cfg, 1, device=solver.device, model=solver.model)
    return entry(cell)(warm_cfg, slv, problem)


def run(argv: Optional[List[str]] = None, *, t_start: Optional[float] = None,
        device: Optional[str] = None, extra_dir: Optional[Path] = None,
        out=None) -> int:
    """One run; returns the exit code. ``device`` (tests only) runs on that
    device instead of looking for a CUDA card; ``extra_dir`` is searched
    first for the cell's files."""
    t_start = time.perf_counter() if t_start is None else t_start
    out = out or sys.stdout
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload, extra_dir)
    chips = int(cell["workload"].get("chips", 1))
    for k, v in {**cache_env(), **cell["config"].get("env", {})}.items():
        os.environ[k] = str(v)

    import numpy as np
    import torch
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"{args.workload} needs {chips} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        dev = torch.device("cuda:0")
        torch.cuda.init()
        torch.zeros(1, device=dev)
    else:
        dev = torch.device(device)
    split = {"imports_cuda_s": time.perf_counter() - t_start}

    from deep_prior_interpolation_tpu_torch.config import Config
    from deep_prior_interpolation_tpu_torch.engine import solver as solver_mod
    from deep_prior_interpolation_tpu_torch.ops import _build, wgrad as wgrad_ops
    from benchmark import probes, tracefile, traffic
    if dev.type == "cuda":
        _build.start_builds()
    split["program_import_s"] = time.perf_counter() - t_start - split["imports_cuda_s"]

    t0 = time.perf_counter()
    c = cell["config"]["config"]
    tr = cell["traffic"]
    cfg = Config(**c)
    net = reference_net(cell)
    pool = traffic.make_pool(tr, net.spec(), float(c["gain"]), float(c["initgain"]),
                             args.seed, dev)
    split["inputs_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if dev.type == "cuda":
        for name in _build.SOURCES:
            _build.load_library(name)
    split["build_wait_s"] = time.perf_counter() - t0

    solver = solver_mod.DIPSolver(cfg, 1, device=dev)
    lanes = int(tr["lanes"])
    solve = entry(cell)

    # the wgrad tuner's grids from an earlier run of this checkout, kept
    # after the warm-up with any it tuned now
    cache = plan_cache() if dev.type == "cuda" else None
    if cache is not None and cache.exists():
        with open(cache) as fh:
            split["plans_pinned"] = wgrad_ops.pin_plans(json.load(fh))
    t0 = time.perf_counter()
    warm = warm_up(cell, cfg, solver, pool[0])
    split["warmup_solve_s"] = time.perf_counter() - t0
    split["warmup_chunk_s"] = list(warm[0].chunk_seconds)
    del warm
    if cache is not None and len(wgrad_ops.tuned_plans()) > split.get("plans_pinned", 0):
        cache.parent.mkdir(parents=True, exist_ok=True)
        tmp = cache.with_suffix(f".{os.getpid()}.tmp")
        with open(tmp, "w") as fh:
            json.dump(wgrad_ops.tuned_plans(), fh)
        os.replace(tmp, cache)

    spy = probes.AdamSpy(solver_mod._FlatParams, int(tr["lanes"]),
                         sum(math.prod(s) for _, s, _ in net.spec()), dev)
    tracer = None
    if args.trace:
        tracer = probes.ChunkTracer(solver, max(1, min(cfg.scan_chunk, cfg.epochs)), dev)
        tracer.warm()
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    # ---- the window ---------------------------------------------------
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    solves, histories = [], None
    k = 0
    while True:
        prob = pool[k % len(pool)]
        spy.arm(k == 0)
        if tracer is not None:
            tracer.armed = k == 0
        t0 = time.perf_counter()
        results = solve(cfg, solver, prob)
        t1 = time.perf_counter()
        if tracer is not None:
            tracer.stop()
        solves.append({"wall": t1 - t0, "chunk_s": list(results[0].chunk_seconds),
                       "lane_iters": sum(r.iters_run for r in results),
                       "finite": [bool(np.all(np.isfinite(r.history.loss))) for r in results],
                       "iters": [r.iters_run for r in results]})
        if k == 0:
            histories = [list(r.history.loss[:3]) for r in results]
        del results
        k += 1
        if t1 - t_window >= args.seconds:
            break
    _sync(dev)
    window_s = time.perf_counter() - t_window
    spy.arm(False)
    mem_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    lane_iters = sum(s["lane_iters"] for s in solves)
    attempted = len(solves) * lanes
    failed = sum(1 for s in solves for f, n in zip(s["finite"], s["iters"])
                 if not f or n != cfg.epochs)
    rec = Record(solves=solves, window_s=window_s, lane_iters=lane_iters, lanes=lanes,
                 peak=cell["config"]["peak"], counts=cell_counts(cell) if args.trace else {})
    breakdown = busy = None
    if tracer is not None and tracer.done:
        tmp = tempfile.mkdtemp(prefix="benchmark-trace-")
        try:
            path = os.path.join(tmp, "trace.json")
            tracer.export(path)
            rec.trace = tracefile.read(path)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        rec.steps_traced = tracer.chunk
        busy = {"busy_s": rec.trace.busy_s, "window_s": rec.trace.window_s}
        breakdown = {"device_ops": [[n, s] for n, s in rec.trace.device_ops],
                     "idle_gaps": [[n, s] for n, s in rec.trace.idle_gaps]}
    if tracer is not None:
        tracer.remove()

    if args.trace:
        metrics = {}
        for name, mod in load_metrics().items():
            v = mod.read(rec)
            if v is not None:
                metrics[name] = {"value": v, "unit": mod.UNIT}
    else:
        metrics = {"patch_iters_per_s": {"value": lane_iters / window_s, "unit": "iters/s"},
                   "peak_mem_gib": {"value": mem_peak / 2 ** 30, "unit": "GiB"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    print(json.dumps({"setup_split": split, "solves": len(solves),
                      "solve_walls": [s["wall"] for s in solves]}), file=sys.stderr)

    # ---- the comparison, with the program's state freed ----------------
    del solver
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    gaps = compare(program_lanes(pool[0], histories, spy), reference_lanes(cell, pool[0], dev))
    spy.remove()
    limits = cell["workload"]["limits"]
    check_out = {k: {"value": gaps[k], "limit": limits[k]} for k in limits}
    correct = failed == 0 and all(v["value"] <= v["limit"] for v in check_out.values())
    print(json.dumps({"readings": gaps}), file=sys.stderr)

    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": chips, "memory_peak_bytes": int(mem_peak)}
    if busy is not None:
        device_info.update(busy)
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = check_out
    for k, v in check_out.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0
