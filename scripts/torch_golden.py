"""The JAX repository's convergence goldens through the PyTorch port.

Each workload is built exactly as the JAX repository's script builds it,
from the port's own data functions, and solved through the port's entry
points with both kernel switches on (``Config.fused_loss=True`` and
``DPI_PALLAS_WGRAD=1``; a 3D net with linear upsampling also launches the
port's ``upsample_bwd``), or with both off (``--kernels off``: the plain
loss and cuDNN's weight gradient):

* ``g3d`` (``scripts/golden_3d.py``): problem s is ``hyperbolic_events(32,
  32, 32, seed=s) * 40`` with the traces ``RandomState(100 + s).rand(1, 32,
  32) > 0.6`` kept; MulResUnet 3D, trilinear, float32, seed s, problems
  0-7, 150 and 600 iterations (``golden_3d.json``, ``golden_3d_600.json``);
* ``g25d`` (``scripts/golden_25d.py``): ``decimated_pair(32, 32, 8,
  rate=0.66, seed=3)`` through the 2.5D pipeline (slice ``tx``, 8
  channels), seeds 0-4, 300 iterations (``golden_25d.json``);
* ``gpocs`` (``scripts/golden_pocs.py``): the lines gather, L1 plus POCS
  (alpha 0.1, threshold 5 %, stop-grad eps), seeds 0-4 (the JAX file has
  3), 300 iterations (``golden_pocs.json``);
* ``g2d`` (``scripts/golden_2d.py``): the lines gather, seeds 0-4, 300 and
  3000 iterations (``golden_2d.json``, ``golden_2d_endpoint.json``);
* ``flagship`` (``scripts/quality_3d.py``): the poc_3D volume
  (``synth_hyperbolic``) x 40, ``RandomState(1)`` traces > 0.66 kept,
  bfloat16, phase space at 3 levels, seed 0, 2000 iterations
  (``quality_3d.json``).

A golden of several lengths runs once at the longest: the shorter one is
the first iterations of the same solves (nothing in a solve depends on its
length before its end), as the JAX files' shared values show. The runner is
``DIPSolver.solve`` one seed after another (``solve``) or
``solve_patches_batched`` (``lanes``: lane i is seeded i, so for g3d patch i
is problem i with seed i; for the others the lanes are copies of one patch).

For each golden it records, over the seeds, ``best_snr = max(history.snr)``
(the JAX scripts' metric), the SNR of ``out_best``, the least loss, the
median steady s/iteration (the solver's chunk windows, each closed by its
host read), the peak device memory and each kernel's launches; then
:func:`accept`, the JAX scripts' rule, against the JAX package's column and
the torch reference's. Where the JAX file's column was taken at another
precision than the port's float32 and the two differ in spread (gpocs:
three seeds at the TPU's default precision), the verdict holds the port to
the JAX package's float32 column in ``golden_torch_cpu.json``
(``scripts/torch_golden_cpu.py``), and the TPU column's verdict is printed
beside it. The card's ``nvidia-smi`` name and power limit stand beside the
numbers.

Usage::

    python scripts/torch_golden.py [--only g3d,g25d,gpocs,g2d,flagship]
        [--kernels on|off|both] [--out golden_torch_h100.json] [--device cuda]

``--iters`` and ``--seeds`` cut a run for a smoke test; a cut run gets no
verdict. The script imports the port, numpy and torch only.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from deep_prior_interpolation_tpu_torch import Config, DIPSolver  # noqa: E402
from deep_prior_interpolation_tpu_torch.data import (decimated_pair, extract_patches,  # noqa: E402
                                                     hyperbolic_events, lines_dataset,
                                                     synth_hyperbolic)
from deep_prior_interpolation_tpu_torch.ops import snr  # noqa: E402
from deep_prior_interpolation_tpu_torch.parallel import solve_patches_batched  # noqa: E402

RULE = ("accept: |mean_port - mean_jax| <= 0.5 dB, or (n_port >= 5 and the 1-sigma "
        "intervals overlap); mean and population std of best_snr over the seeds "
        "(scripts/golden_3d.py:284-285)")

# ----------------------------------------------------------------------
# the workloads, as the JAX scripts build them
# ----------------------------------------------------------------------

G3D_SHAPE = (32, 32, 32)
F32_FILE = "golden_torch_cpu.json"   # the JAX package's float32 columns
NT, NX, NY = 32, 32, 8          # the 2.5D volume
POCS_ALPHA, POCS_THRESH = 0.1, 5.0


def g3d_problem(s: int) -> Tuple[np.ndarray, np.ndarray]:
    """golden_3d.py ``make_problem(s)``: (32, 32, 32, 1) image and mask."""
    img = hyperbolic_events(*G3D_SHAPE, seed=s).astype(np.float32) * 40.0
    rng = np.random.RandomState(100 + s)
    keep = (rng.rand(1, G3D_SHAPE[1], G3D_SHAPE[2]) > 0.6).astype(np.float32)
    mask = np.broadcast_to(keep, G3D_SHAPE).copy()
    return img[..., None], mask[..., None]


def g25d_workload() -> Tuple[np.ndarray, np.ndarray]:
    """golden_25d.py ``make_workload()``: the (32, 32, 8) slab through the
    2.5D pipeline (slice ``tx``), channels last."""
    vol, mask = decimated_pair(NT, NX, NY, rate=0.66, seed=3)
    cfg = Config(datadim="2.5d", slice="tx", imgchannel=NY, gain=1.0,
                 patch_shape=[NT, NX, NY], patch_stride=[NT, NX, NY])
    patches = extract_patches(cfg, original=vol, corrupted=mask)
    assert len(patches) == 1 and patches[0]["image"].shape == (NT, NX, NY)
    return patches[0]["image"], patches[0]["mask"]


def lines() -> Tuple[np.ndarray, np.ndarray]:
    """golden_2d.py / golden_pocs.py: the lines gather (170, 100, 1), float32."""
    img, mask = lines_dataset()
    return img.astype(np.float32), mask.astype(np.float32)


def flagship_problem(nt: int = 256, nx: int = 128, ny: int = 128
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """quality_3d.py: the benchmark volume x 40 and its 66 % decimation."""
    vol = synth_hyperbolic(nt, nx, ny)
    rng = np.random.RandomState(1)
    mask = np.repeat((rng.rand(1, nx, ny) > 0.66).astype(np.float32), nt, 0)
    return (vol * 40.0)[..., None], mask[..., None]


def config(workload: str, iters: int, kernels: bool) -> Config:
    """The JAX script's ``Config`` of a workload, with the fused-loss switch."""
    common = dict(epochs=iters, loss="mae", lr=1e-3, inputdepth=64, gain=1.0,
                  reg_noise_std=0.03, noise_std=0.1, fused_loss=kernels)
    if workload == "g3d":
        return Config(datadim="3d", upsample="linear", scan_chunk=25, **common)
    if workload == "g25d":
        return Config(datadim="2.5d", slice="tx", imgchannel=NY, scan_chunk=50, **common)
    if workload == "g2d":
        return Config(datadim="2d", scan_chunk=50, **common)
    if workload == "gpocs":
        return Config(datadim="2d", scan_chunk=50, pocs=True, pocs_alpha=POCS_ALPHA,
                      pocs_thresh=POCS_THRESH, pocs_eps_mode="stop_grad", **common)
    if workload == "flagship":
        return Config(**dict(common, gain=40.0), datadim="3d", upsample="linear",
                      scan_chunk=25, dtype="bfloat16", remat=False, phase_space=True,
                      phase_levels=3, virtual_input=False)
    raise ValueError(f"unknown workload {workload!r}")


def problems(workload: str, seeds: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """One (image, mask) a seed: g3d's problem s is seeded s; the others
    solve one problem from every seed."""
    if workload == "g3d":
        return [g3d_problem(s) for s in range(seeds)]
    one = {"g25d": g25d_workload, "g2d": lines, "gpocs": lines,
           "flagship": flagship_problem}[workload]()
    return [one] * seeds


@dataclasses.dataclass(frozen=True)
class Golden:
    workload: str
    iters: int
    seeds: int
    jax_file: str            # the JAX repository's golden, at the repo root
    jax_key: Tuple[str, ...]   # its column of the JAX package's runs ("ours")
    ref_key: Tuple[str, ...]   # its column of the torch reference's runs
    runner: str              # "solve" (one seed after another) or "lanes"
    # the JAX package's float32 column in F32_FILE, which the verdict takes
    # where the JAX file's column is at another precision (ROADMAP D.13)
    f32_key: Optional[Tuple[str, ...]] = None


GOLDENS: Dict[str, Golden] = {
    "g3d_150": Golden("g3d", 150, 8, "golden_3d.json", ("ours", "best_snr"),
                      ("reference", "best_snr"), "lanes"),
    "g3d_600": Golden("g3d", 600, 8, "golden_3d_600.json", ("ours", "best_snr"),
                      ("reference", "best_snr"), "lanes"),
    "g25d": Golden("g25d", 300, 5, "golden_25d.json", ("ours", "best_snr"),
                   ("reference", "best_snr"), "lanes"),
    "gpocs": Golden("gpocs", 300, 5, "golden_pocs.json", ("ours_stop_grad", "best_snr"),
                    ("reference_stop_grad", "best_snr"), "lanes",
                    ("gpocs_jax_cpu_f32", "best_snr")),
    "g2d_300": Golden("g2d", 300, 5, "golden_2d.json", ("ours", "best_snr"),
                      ("reference", "best_snr"), "lanes"),
    "g2d_3000": Golden("g2d", 3000, 5, "golden_2d_endpoint.json", ("ours", "best_snr"),
                       ("reference", "best_snr"), "lanes"),
    "flagship": Golden("flagship", 2000, 1, "quality_3d.json", ("ours",),
                       ("reference_notebook",), "solve"),
}

# ----------------------------------------------------------------------
# the rule
# ----------------------------------------------------------------------


def stats(values: Sequence[float]) -> dict:
    """Mean and population std over the seeds, as the JAX scripts' ``_stats``."""
    v = np.asarray(values, np.float64)
    return {"mean": float(v.mean()), "std": float(v.std()), "values": [float(x) for x in v]}


def accept(port: dict, jax: dict) -> bool:
    """The JAX scripts' rule (golden_3d.py:284-285), ``port`` in the place of
    "ours" and ``jax`` in the reference's: means within 0.5 dB, or at least
    5 seeds on the port's side and overlapping 1-sigma intervals."""
    mo, so, n = port["mean"], port["std"], len(port["values"])
    mr, sr = jax["mean"], jax["std"]
    overlap = (mo - so <= mr + sr) and (mr - sr <= mo + so)
    return bool(abs(mo - mr) <= 0.5 or (n >= 5 and overlap))


def column(name: str, key: Tuple[str, ...]) -> Optional[dict]:
    """A column of a golden file at the repository's root, or None."""
    path = os.path.join(REPO, name)
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        d = json.load(fh)
    for k in key:
        d = d.get(k) if isinstance(d, dict) else None
    return d


def verdicts(golden: Golden, port: dict) -> dict:
    """The port's best-SNR statistics against the JAX package's and the
    torch reference's columns (and the JAX package's float32 one, where the
    golden names it); for g3d also the differences paired by problem.
    ``accept`` is the verdict against the float32 column where there is
    one, else against the JAX file's; ``judged_against`` names it."""
    out = {}
    sides = [("jax", golden.jax_file, golden.jax_key),
             ("reference", golden.jax_file, golden.ref_key)]
    if golden.f32_key:
        sides.append(("jax_f32", F32_FILE, golden.f32_key))
    for side, name, key in sides:
        col = column(name, key)
        if not (isinstance(col, dict) and "mean" in col):
            continue
        out[side] = {"mean": col["mean"], "std": col["std"], "n": len(col["values"]),
                     "accept": accept(port, col), "gap_db": port["mean"] - col["mean"]}
        if golden.workload == "g3d" and len(col["values"]) == len(port["values"]):
            out[side]["paired_diffs_db"] = [a - b for a, b in zip(port["values"],
                                                                  col["values"])]
    judge = "jax_f32" if golden.f32_key else "jax"
    if judge in out:
        out["accept"], out["judged_against"] = out[judge]["accept"], judge
    return out


# ----------------------------------------------------------------------
# runs
# ----------------------------------------------------------------------


def set_kernels(on: bool) -> None:
    """The wgrad kernel's switch (the JAX package's), read at every call."""
    os.environ["DPI_PALLAS_WGRAD"] = "1" if on else "0"


COUNTERS = (("fused_loss", "fused_loss", "fused_sums"),
            ("fused_loss_grad", "fused_loss", "loss_sums_grad"),
            ("wgrad3d", "wgrad", "wgrad3d"),
            ("upsample_bwd", "upsample", "upsample_bwd"),
            ("fused_loss_lanes", "fused_loss", "fused_sums_lanes"),
            ("fused_loss_grad_lanes", "fused_loss", "loss_sums_grad_lanes"),
            ("wgrad3d_lanes", "wgrad", "wgrad3d_lanes"))


def _wrappers():
    from deep_prior_interpolation_tpu_torch.ops import fused_loss, upsample, wgrad
    mods = {"fused_loss": fused_loss, "wgrad": wgrad, "upsample": upsample}
    return {name: getattr(mods[m], fn) for name, m, fn in COUNTERS}


def reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def read_counts() -> Dict[str, int]:
    """Each kernel wrapper's launches since :func:`reset_counts`."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def card(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    if device.type != "cuda":
        return "no card: a CPU run (no device figures)"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def steady(chunk_seconds: Sequence[float], chunk: int) -> Optional[float]:
    """Median of the chunk windows after the first (which builds and tunes)
    over the chunk's iterations."""
    if len(chunk_seconds) < 2:
        return None
    return statistics.median(chunk_seconds[1:]) / chunk


def solve(workload: str, iters: int, seeds: int, kernels: bool, runner: str,
          device: torch.device) -> dict:
    """Solve a workload's seeds once; per seed its SNR trace, the SNR of
    ``out_best``, the loss trace's least value, and the run's launches,
    s/iteration and peak memory."""
    cfg = config(workload, iters, kernels)
    probs = problems(workload, seeds)
    img0 = probs[0][0]
    outchannel = img0.shape[-1]
    set_kernels(kernels)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    t0 = time.time()
    if runner == "lanes":
        patches = [{"image": img, "mask": mask, "name": str(i)}
                   for i, (img, mask) in enumerate(probs)]
        # lane i is seeded cfg.seed + i = i
        results = solve_patches_batched(cfg, DIPSolver(cfg, outchannel, device=device),
                                        patches)
    else:
        solver = DIPSolver(cfg, outchannel, device=device)
        results = [solver.solve(img, mask, seed=s) for s, (img, mask) in enumerate(probs)]
    wall = time.time() - t0
    counts = read_counts()
    chunk = max(1, min(cfg.scan_chunk, cfg.epochs))
    per_seed = []
    for (img, _), res in zip(probs, results):
        out = torch.from_numpy(np.ascontiguousarray(res.out_best, np.float32))
        per_seed.append({"snr": [float(v) for v in res.history.snr],
                         "loss": [float(v) for v in res.history.loss],
                         "snr_out_best": float(snr(out, torch.from_numpy(img))),
                         "s_per_iter": steady(res.chunk_seconds, chunk),
                         "iters_run": res.iters_run})
    s_iter = [r["s_per_iter"] for r in per_seed if r["s_per_iter"] is not None]
    return {"workload": workload, "iters": iters, "seeds": seeds, "runner": runner,
            "kernels": "on" if kernels else "off", "per_seed": per_seed, "launches": counts,
            "wall_s": wall,
            # lanes share one run: one window a chunk for all of them
            "s_per_iter": statistics.median(s_iter) if s_iter else None,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(device) if on_card else None}


def summarise(name: str, golden: Golden, run: dict) -> dict:
    """One golden's record from a run of its seeds: the first ``golden.iters``
    iterations of each (a run shorter than the golden, or of other seeds,
    is cut and gets no verdict)."""
    n = min(golden.iters, run["iters"])
    cut = run["iters"] < golden.iters or run["seeds"] != golden.seeds
    best = [max(r["snr"][:n]) for r in run["per_seed"]]
    rec = {"golden": name, "iters": n, "seeds": len(best), "runner": run["runner"],
           "kernels": run["kernels"], "jax_file": golden.jax_file,
           "best_snr": stats(best),
           "min_loss": stats([min(r["loss"][:n]) for r in run["per_seed"]]),
           "s_per_iter": run["s_per_iter"], "peak_memory_bytes": run["peak_memory_bytes"],
           "launches": run["launches"], "wall_s": run["wall_s"]}
    if run["iters"] == n:
        rec["snr_out_best"] = stats([r["snr_out_best"] for r in run["per_seed"]])
    else:
        rec["from"] = f"the first {n} iterations of the {run['iters']}-iteration solves"
    if golden.workload == "flagship":
        rec["jax"] = column(golden.jax_file, golden.jax_key)
        rec["reference"] = column(golden.jax_file, golden.ref_key)
    elif cut:
        rec["verdict"] = "none: a cut run (iterations or seeds differ from the JAX file's)"
    else:
        rec.update(verdicts(golden, rec["best_snr"]))
    return rec


def dist_comparison(rec: dict) -> Optional[dict]:
    """g3d at 600 iterations: the port's best SNR on the hard problems (1, 6,
    7) beside ``golden_3d_dist.json``'s columns (the JAX package at TPU
    default and highest precision, on the CPU in float32, and the torch
    reference), which differ in matmul precision and solver seeds."""
    path = os.path.join(REPO, "golden_3d_dist.json")
    if rec["iters"] != 600 or not os.path.exists(path):
        return None
    with open(path) as fh:
        dist = json.load(fh)
    vals = rec["best_snr"]["values"]
    return {p: {"port": vals[int(p)], **dist["per_problem_mean_db"][p]}
            for p in dist["per_problem_mean_db"] if int(p) < len(vals)}


def log_record(rec: dict) -> None:
    b = rec["best_snr"]
    parts = [f"{rec['golden']} kernels {rec['kernels']} ({rec['runner']}, {rec['seeds']} "
             f"seeds x {rec['iters']}): best SNR {b['mean']:.2f} +- {b['std']:.2f} dB"]
    for side in ("jax", "reference", "jax_f32"):
        if side in rec and isinstance(rec[side], dict) and "accept" in rec[side]:
            c = rec[side]
            parts.append(f"{side} {c['mean']:.2f} +- {c['std']:.2f} (n {c['n']}): gap "
                         f"{c['gap_db']:+.2f} dB, accept {c['accept']}")
            if "paired_diffs_db" in c:
                parts.append(f"  paired by problem against {side}: "
                             + " ".join(f"{d:+.2f}" for d in c["paired_diffs_db"]))
    if "judged_against" in rec:
        parts.append(f"  verdict (against {rec['judged_against']}): accept {rec['accept']}")
    s = rec["s_per_iter"]
    parts.append(f"  s/iteration {'n/a' if s is None else f'{s:.4f}'}, launches "
                 f"{rec['launches']}")
    print("\n".join(parts), flush=True)


def run_goldens(names: Sequence[str], kernel_modes: Sequence[bool], device: torch.device,
                iters: Optional[int] = None,
                seeds: Optional[int] = None) -> Dict[str, Dict[str, dict]]:
    """Run the named goldens; a workload runs once at the longest of its
    goldens (or at ``iters``). Returns {name: {"kernels_on"/"kernels_off": record}}."""
    by_workload: Dict[str, List[str]] = {}
    for name in names:
        by_workload.setdefault(GOLDENS[name].workload, []).append(name)
    out: Dict[str, Dict[str, dict]] = {}
    for workload, group in by_workload.items():
        g = max((GOLDENS[n] for n in group), key=lambda x: x.iters)
        for on in kernel_modes:
            run = solve(workload, iters or g.iters, seeds or g.seeds, on, g.runner, device)
            for name in group:
                rec = summarise(name, GOLDENS[name], run)
                dist = dist_comparison(rec) if workload == "g3d" else None
                if dist:
                    rec["golden_3d_dist"] = dist
                log_record(rec)
                out.setdefault(name, {})[f"kernels_{'on' if on else 'off'}"] = rec
    return out


def merge(path: str, key: str, value) -> None:
    """Write ``value`` under ``key`` of the JSON file at ``path``."""
    data = {}
    if os.path.exists(path):
        with open(path) as fh:
            data = json.load(fh)
    data[key] = value
    with open(path, "w") as fh:
        json.dump(data, fh, indent=1)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=",".join(GOLDENS),
                    help="comma-separated goldens: " + ", ".join(GOLDENS)
                    + " (or a workload name: g3d, g2d)")
    ap.add_argument("--kernels", choices=["on", "off", "both"], default="on")
    ap.add_argument("--out", default=os.path.join(REPO, "golden_torch_h100.json"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=None, help="cut every run (smoke test)")
    ap.add_argument("--seeds", type=int, default=None, help="cut every run (smoke test)")
    args = ap.parse_args(argv)

    names = []
    for item in args.only.split(","):
        names += [n for n, g in GOLDENS.items() if item in (n, g.workload)]
    if not names:
        ap.error(f"no golden named in {args.only!r}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for a smoke test")
    modes = {"on": [True], "off": [False], "both": [True, False]}[args.kernels]
    smi = card(device)
    print(smi, flush=True)
    merge(args.out, "device", {"nvidia_smi": smi, "torch": torch.__version__,
                               "cuda": torch.version.cuda,
                               "kind": torch.cuda.get_device_name(device)
                               if device.type == "cuda" else "cpu"})
    merge(args.out, "rule", RULE)
    workloads: Dict[str, List[str]] = {}
    for name in dict.fromkeys(names):
        workloads.setdefault(GOLDENS[name].workload, []).append(name)
    for group in workloads.values():   # written after each workload
        res = run_goldens(group, modes, device, args.iters, args.seeds)
        with open(args.out) as fh:
            prev = json.load(fh).get("runs", {})
        for k, v in res.items():
            prev.setdefault(k, {}).update({m: dict(r, nvidia_smi=smi) for m, r in v.items()})
        merge(args.out, "runs", prev)
    print(f"saved {args.out}", flush=True)


if __name__ == "__main__":
    main()
