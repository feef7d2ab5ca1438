"""Field-scale workflow through the PyTorch port, as ``examples/field_scale.py``:
a 2D 256x128 gather with 50 % of its traces dropped is tiled into 9
overlapping 128x64 patches (stride 64x32), the 9 patches are solved at once
as 9 lanes of one step (``parallel.solve_patches_batched``, each lane its own
net), and the best outputs are assembled by the port's overlap-add
(``reconstruct_patches``); the assembled gather's SNR and the wall time are
appended to ``golden_torch_h100.json`` (``--out``) under ``field_scale``,
with the card's ``nvidia-smi`` name and power limit.

Usage: python examples/torch_field_scale.py [--epochs 300] [--conv_mode grouped|tapmm]
           [--device cuda] [--out golden_torch_h100.json]
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--conv_mode", default="grouped", choices=["grouped", "tapmm"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(REPO, "golden_torch_h100.json"))
    args = ap.parse_args()

    import torch

    import deep_prior_interpolation_tpu_torch as dpi
    from deep_prior_interpolation_tpu_torch.data import (decimated_pair, extract_patches,
                                                         reconstruct_patches)
    from deep_prior_interpolation_tpu_torch.ops import snr
    from deep_prior_interpolation_tpu_torch.parallel import solve_patches_batched

    os.environ.setdefault("DPI_PALLAS_WGRAD", "1")
    vol, mask = decimated_pair(nt=256, nx=128, ny=None, rate=0.5, seed=3)
    cfg = dpi.Config(datadim="2d", gain=1.0, epochs=args.epochs, loss="mae",
                     inputdepth=32, filters=[8, 16, 32], skip=[4, 8], scan_chunk=50,
                     patch_shape=[128, 64], patch_stride=[64, 32], batch_patches=9,
                     vmap_conv_mode=args.conv_mode, fused_loss=True)
    patches = extract_patches(cfg, original=vol, corrupted=mask)
    print(f"{len(patches)} overlapping patches of {patches[0]['image'].shape}, "
          f"{cfg.batch_patches} lanes a step")

    solver = dpi.DIPSolver(cfg, outchannel=1, device=args.device)
    t0 = time.time()
    outs = []
    for start in range(0, len(patches), cfg.batch_patches):
        group = patches[start:start + cfg.batch_patches]
        outs += [r.out_best for r in solve_patches_batched(cfg, solver, group)]
    elapsed = time.time() - t0
    recon = reconstruct_patches(cfg, patches_out=np.stack(outs), original=vol)
    out_snr = float(snr(torch.from_numpy(np.asarray(recon, np.float32)),
                        torch.from_numpy(vol)))
    print(f"reconstruction SNR {out_snr:.2f} dB ({len(patches)} patches, {args.epochs} "
          f"iterations each, {elapsed:.1f} s)")

    on_card = solver.device.type == "cuda"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0] if on_card else "cpu"
    art = {}
    if os.path.exists(args.out):
        with open(args.out) as fh:
            art = json.load(fh)
    with open(os.path.join(REPO, "field_scale.json")) as fh:
        jax_runs = json.load(fh)
    art.setdefault("field_scale", {})[f"{args.epochs}iters_b{cfg.batch_patches}_"
                                      f"{args.conv_mode}"] = {
        "snr_db": out_snr, "wall_s": elapsed, "n_patches": len(patches),
        "lanes": cfg.batch_patches, "conv_mode": args.conv_mode, "device": smi,
        "jax": {k: v for k, v in jax_runs.items() if k != "workload"}}
    with open(args.out, "w") as fh:
        json.dump(art, fh, indent=1)
    print(f"recorded -> {args.out}")


if __name__ == "__main__":
    main()
