"""Seed spreads of the convergence goldens on the CPU, through the JAX
package or the PyTorch port, from the same workloads.

``scripts/torch_golden.py`` runs the port on the card against the JAX
repository's golden files, whose JAX columns were taken on a TPU. This
script runs a golden's seeds in float32 on the CPU through either package
(``--package jax|port``), so that a spread seen on the card can be set
beside the JAX package's own spread at the same precision, seed for seed
the same workload. Each seed's best SNR (the max of its SNR trace) is
printed as it finishes and merged into ``--out`` under
``<golden>_<package>_cpu_f32`` (``by_seed``, and ``best_snr``: mean,
population std and values over every seed recorded, the golden files'
form; ``scripts/torch_golden.py`` reads ``golden_torch_cpu.json``'s
``gpocs_jax_cpu_f32`` for the gpocs verdict).

``--golden field`` is ``examples/field_scale.py``'s tiling: its nine
patches are solved one at a time, patch i with seed ``--seed0 + i`` (the
seeds of the port's lanes), and assembled by overlap-add; each patch's best
SNR and the assembled gather's SNR are recorded. With ``--patch i`` only
that patch is solved, once a seed of ``--seeds``.

Usage::

    python scripts/torch_golden_cpu.py --package jax --golden gpocs --seeds 0:5
    python scripts/torch_golden_cpu.py --package port --golden field
    python scripts/torch_golden_cpu.py --package jax --golden field --patch 6 --seeds 30:50
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (REPO, os.path.join(REPO, "scripts")):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch_golden as G  # noqa: E402


def field_config(epochs: int):
    """``examples/field_scale.py``'s Config (the port's; its fields are the
    JAX package's)."""
    from deep_prior_interpolation_tpu_torch import Config
    return Config(datadim="2d", gain=1.0, epochs=epochs, loss="mae", inputdepth=32,
                  filters=[8, 16, 32], skip=[4, 8], scan_chunk=50,
                  patch_shape=[128, 64], patch_stride=[64, 32])


def solver_for(package: str, cfg, outchannel: int):
    """A solver of ``package`` for the port's ``cfg`` (the fused loss off:
    the JAX package's would run in interpret mode on the CPU)."""
    cfg = dataclasses.replace(cfg, fused_loss=False)
    if package == "port":
        from deep_prior_interpolation_tpu_torch import DIPSolver
        return DIPSolver(cfg, outchannel, device="cpu")
    from deep_prior_interpolation_tpu.config import Config as JaxConfig
    from deep_prior_interpolation_tpu.engine import DIPSolver as JaxDIPSolver
    fields = {f.name for f in dataclasses.fields(JaxConfig)}
    jcfg = JaxConfig(**{k: v for k, v in dataclasses.asdict(cfg).items() if k in fields})
    return JaxDIPSolver(jcfg, outchannel=outchannel)


def golden_seeds(package: str, name: str, seeds: range) -> dict:
    """Each seed's best SNR of one golden (its full length)."""
    golden = G.GOLDENS[name]
    cfg = G.config(golden.workload, golden.iters, False)
    probs = G.problems(golden.workload, seeds.stop)
    solver = solver_for(package, cfg, probs[0][0].shape[-1])
    best = {}
    for s in seeds:
        img, mask = probs[s]
        t0 = time.time()
        res = solver.solve(img, mask, seed=s)
        best[s] = float(np.max(np.asarray(res.history.snr)))
        print(f"{package} {name} seed {s}: best SNR {best[s]:.4f} dB "
              f"({time.time() - t0:.0f} s)", flush=True)
    return {"best_snr": best}


def _field_patches(package: str, cfg):
    """The field-scale gather and its nine patches, from ``package``."""
    if package == "port":
        from deep_prior_interpolation_tpu_torch.data import decimated_pair, extract_patches
    else:
        from deep_prior_interpolation_tpu.data import decimated_pair, extract_patches
    vol, mask = decimated_pair(nt=256, nx=128, ny=None, rate=0.5, seed=3)
    return vol, extract_patches(cfg, original=vol, corrupted=mask)


def field_patch(package: str, epochs: int, patch: int, seeds: range) -> dict:
    """One field-scale patch, once a seed: each seed's best SNR."""
    cfg = field_config(epochs)
    p = _field_patches(package, cfg)[1][patch]
    solver = solver_for(package, cfg, 1)
    best = {}
    for s in seeds:
        res = solver.solve(p["image"], p["mask"], seed=s)
        best[s] = float(np.max(np.asarray(res.history.snr)))
        print(f"{package} field patch {patch} seed {s}: best SNR {best[s]:.4f} dB",
              flush=True)
    return {"best_snr": best}


def field(package: str, epochs: int, seed0: int) -> dict:
    """examples/field_scale.py's nine patches one at a time, patch i seeded
    ``seed0 + i``, then the overlap-add and the assembled SNR."""
    cfg = field_config(epochs)
    if package == "port":
        from deep_prior_interpolation_tpu_torch.data import reconstruct_patches
    else:
        from deep_prior_interpolation_tpu.data import reconstruct_patches
    vol, patches = _field_patches(package, cfg)
    solver = solver_for(package, cfg, 1)
    outs, best = [], []
    for i, p in enumerate(patches):
        res = solver.solve(p["image"], p["mask"], seed=seed0 + i)
        outs.append(np.asarray(res.out_best, np.float32))
        best.append(float(np.max(np.asarray(res.history.snr))))
        print(f"{package} field patch {i} seed {seed0 + i}: best SNR {best[-1]:.4f} dB",
              flush=True)
    recon = np.asarray(reconstruct_patches(cfg, patches_out=np.stack(outs), original=vol),
                       np.float64)
    ref = np.asarray(vol, np.float64)
    assembled = float(20 * np.log10(np.linalg.norm(ref) / np.linalg.norm(ref - recon)))
    print(f"{package} field: assembled SNR {assembled:.4f} dB", flush=True)
    return {"patch_best_snr": best, "snr_db": assembled, "seed0": seed0}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=["jax", "port"], required=True)
    ap.add_argument("--golden", required=True, help=", ".join(G.GOLDENS) + " or field")
    ap.add_argument("--seeds", default="0:5", help="a:b, the seeds a..b-1 (goldens, --patch)")
    ap.add_argument("--patch", type=int, default=None, help="field: solve this patch only")
    ap.add_argument("--seed0", type=int, default=0, help="field: patch i is seeded seed0 + i")
    ap.add_argument("--epochs", type=int, default=300, help="field: iterations a patch")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--out", default=None, help="append the record to this JSON file")
    args = ap.parse_args()

    if args.package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
    import torch
    torch.set_num_threads(args.threads)
    a, b = (int(v) for v in args.seeds.split(":"))
    if args.golden == "field" and args.patch is not None:
        rec = field_patch(args.package, args.epochs, args.patch, range(a, b))
        key = f"field_patch{args.patch}_{args.package}_{args.epochs}iters"
    elif args.golden == "field":
        rec = field(args.package, args.epochs, args.seed0)
        key = f"field_{args.package}_seed0_{args.seed0}_{args.epochs}iters"
    else:
        rec = golden_seeds(args.package, args.golden, range(a, b))
        key = f"{args.golden}_{args.package}_cpu_f32"
    if args.out:
        data = {}
        if os.path.exists(args.out):
            with open(args.out) as fh:
                data = json.load(fh)
        if "best_snr" in rec:
            # seeds of earlier calls are kept; the statistics are over all
            by_seed = {**data.get(key, {}).get("by_seed", {}),
                       **{str(k): v for k, v in rec.pop("best_snr").items()}}
            seeds = sorted(by_seed, key=int)
            rec = {"by_seed": {k: by_seed[k] for k in seeds},
                   "best_snr": G.stats([by_seed[k] for k in seeds]), **rec}
        data[key] = rec
        with open(args.out, "w") as fh:
            json.dump(data, fh, indent=1)


if __name__ == "__main__":
    main()
