"""The readings that a cell's limits are set from, at the cell's own size.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 \
        [--program] [--control] [--faults half,answer] [--cause]

For each seed: the first solve that a run with that seed would make (its
patches, weights and solve seed), through the cell's entry, the set-up and
warm-up of a run before the first. ``--program`` compares the program's solve
with the reference, as a run does; ``--control`` puts the reference computed
in the configuration's ``control`` precision (``reference.mulresunet``
``quant``: fp8 below bfloat16, TF32 below float32) in the program's place; ``--faults``
plants each named fault of ``faults.py`` under the program's solve.
``--cause`` (with ``--program``) reads why the parameters' change after three
updates spreads: the float32 reference against the same steps in float64
(``ref32_vs_ref64``), the program against the float64 steps
(``program_vs_ref64``), and, in the parameter whose change gap is the
largest and over all counted parameters, the share of elements whose first
gradient has the other sign than in float64, the program's and the float32
reference's. Every comparison prints one JSON line of readings; the last
line sums them up: the largest reading of the program's seeds (the lower
reading of each number), the smallest of the control's and of each fault's.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import harness  # noqa: E402


def main(argv: List[str], device: Optional[str] = None, extra_dir=None) -> int:
    """``device`` and ``extra_dir`` as in ``harness.run`` (tests)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", default="")
    ap.add_argument("--cause", action="store_true")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload, extra_dir)
    for k, v in {**harness.cache_env(), **cell["config"].get("env", {})}.items():
        os.environ[k] = str(v)
    import torch
    if device is None and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device(device or "cuda:0")
    from deep_prior_interpolation_tpu_torch.config import Config
    from deep_prior_interpolation_tpu_torch.engine import solver as solver_mod
    from benchmark import faults, probes, traffic

    c, tr = cell["config"]["config"], cell["traffic"]
    cfg = Config(**c)
    spec = harness.reference_net(cell).spec()
    n_params = sum(math.prod(s) for _, s, _ in spec)
    solver = solver_mod.DIPSolver(cfg, 1, device=dev)
    solve = harness.entry(cell)
    seeds = [int(s) for s in args.seeds.split(",")]
    kinds = (["program"] if args.program else []) + (["control"] if args.control else []) \
        + [f for f in args.faults.split(",") if f]
    found: Dict[str, List[Dict[str, float]]] = {k: [] for k in kinds}
    warmed = False
    for seed in seeds:
        t0 = time.perf_counter()
        (prob,) = traffic.make_pool({**tr, "pool": 1}, spec, float(c["gain"]),
                                    float(c["initgain"]), seed, dev)
        if not warmed:
            harness.warm_up(cell, cfg, solver, prob)
            warmed = True
        ref = harness.reference_lanes(cell, prob, dev, keep_grad=args.cause)
        ref64 = None
        if args.cause:
            ref64 = harness.reference_lanes(cell, prob, dev, precision=torch.float64,
                                            keep_grad=True)
            readings = harness.compare(ref, ref64)
            found.setdefault("ref32_vs_ref64", []).append(readings)
            print(json.dumps({"kind": "ref32_vs_ref64", "seed": seed, "readings": readings}),
                  flush=True)
        for kind in kinds:
            if kind == "control":
                prog = harness.reference_lanes(cell, prob, dev,
                                               quant=cell["config"]["control"])
            else:
                with (faults.planted(kind, tr["entry"] == "lanes") if kind != "program"
                      else contextlib.nullcontext()):
                    spy = probes.AdamSpy(solver_mod._FlatParams, int(tr["lanes"]), n_params, dev)
                    spy.arm(True)
                    results = solve(cfg, solver, prob)
                    spy.arm(False)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    spy.remove()
                hist = [list(r.history.loss[:3]) for r in results]
                del results
                prog = harness.program_lanes(prob, hist, spy)
            readings = harness.compare(prog, ref)
            found[kind].append(readings)
            print(json.dumps({"kind": kind, "seed": seed, "readings": readings}), flush=True)
            if kind == "program" and ref64 is not None:
                readings = harness.compare(prog, ref64)
                found.setdefault("program_vs_ref64", []).append(readings)
                print(json.dumps({"kind": "program_vs_ref64", "seed": seed,
                                  "readings": readings,
                                  "flips": sign_flips(prog, ref, ref64, spy, prob)}), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    summary = {}
    for kind, runs in found.items():
        pick = min if kind == "control" or kind in faults.NAMES else max
        summary[kind] = {k: pick(r[k] for r in runs) for k in harness.READINGS}
    print(json.dumps({"workload": args.workload, "seeds": seeds, "summary": summary}))
    return 0


def sign_flips(prog, ref, ref64, spy, prob) -> Dict[str, object]:
    """In the lane and parameter whose change gap (program against the
    float32 reference) is the largest: its name, size, gap, the float32
    reference's gap against float64 there, the share of its elements whose
    first gradient has the other sign than in float64 (the program's, read
    from Adam's first moment, and the float32 reference's), and its initial
    weights' root mean square (Adam's first update moves every element by
    about the step size, the configuration's ``lr``); and the same shares
    over every counted parameter of every lane."""
    import torch
    worst, tot = None, {"program": [0, 0], "ref32": [0, 0]}
    for j, (p, r, r64) in enumerate(zip(prog, ref, ref64)):
        gaps = harness.leaf_gaps(p, r, "step")
        g_prog = spy.leaves(spy.g1[j])
        for n in r["counted"]:
            s64 = torch.sign(r64["grad0"][n].reshape(-1))
            for side, g in (("program", g_prog[n]), ("ref32", r["grad0"][n].reshape(-1))):
                tot[side][0] += int((torch.sign(g) != s64).sum())
                tot[side][1] += s64.numel()
        n = max(gaps, key=gaps.get)
        if worst is None or gaps[n] > worst["step_gap"]:
            s64 = torch.sign(r64["grad0"][n].reshape(-1))
            worst = {"lane": j, "name": n, "size": int(s64.numel()), "step_gap": gaps[n],
                     "ref32_step_gap": harness.leaf_gaps(r, r64, "step")[n],
                     "flip_program": float((torch.sign(g_prog[n]) != s64).float().mean()),
                     "flip_ref32": float((torch.sign(r["grad0"][n].reshape(-1)) != s64)
                                         .float().mean()),
                     "weight_rms": float(prob.params[j][n].double().pow(2).mean().sqrt())}
    return {"worst": worst, "all": {k: v[0] / max(v[1], 1) for k, v in tot.items()}}


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
