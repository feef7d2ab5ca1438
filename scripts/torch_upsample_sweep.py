"""Time the port's upsample backward kernels (csrc/upsample.cu) on one CUDA
card at the main path's and the lane path's shapes: every TMA tile
configuration at ring depths 2, 3, 4 and 6 (span from the planner), the
planner's own choice, and the direct kernel, each checked bit-equal to the
plain version first.

    python3 scripts/torch_upsample_sweep.py [OUT.json]

Prints one line a shape and configuration (ms, and the share of the bound:
9 x the input's bytes at 3.35 TB/s) and writes the rows to OUT.json."""
import json
import math
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import PEAK_BYTES, time_ms  # noqa: E402
from deep_prior_interpolation_tpu_torch.ops import upsample as U  # noqa: E402

# (planes, input spatial): the flagship's four upsamples, then 8 lanes of
# (128, 64, 64) patches folded into the planes
SHAPES = [(426, (16, 8, 8)), (212, (32, 16, 16)), (105, (64, 32, 32)), (51, (128, 64, 64)),
          (3408, (8, 4, 4)), (1696, (16, 8, 8)), (840, (32, 16, 16)), (408, (64, 32, 32))]


def sweep(dev, dtype, planes, sp) -> dict:
    go = torch.randn((1, planes) + tuple(2 * s for s in sp), device=dev).to(dtype)
    ref = U.upsample_bwd_plain(go, 3)
    gin = torch.empty((1, planes) + sp, dtype=dtype, device=dev)
    esz = go.element_size()
    bound = 9 * planes * math.prod(sp) * esz / PEAK_BYTES * 1e3
    plans = {"direct": U.direct_plan(planes, *sp, True),
             "planner": U.plan(planes, *sp, True, esz)}
    for cfg in range(len(U.TMA_CONFIGS)):
        for stages in (2, 3, 4, 6):
            p = U.tma_plan(planes, *sp, True, esz, cfg, stages)
            if p.smem <= U._SMEM_BLOCK:
                plans[f"tma cfg {cfg} {U.TMA_CONFIGS[cfg]} stages {stages}"] = p
    rows = {}
    for name, p in plans.items():
        U._launch(go, gin, p)
        if not torch.equal(gin, ref):
            raise SystemExit(f"{name} at {planes} x {sp} {dtype} is not bit-equal to the plain")
        ms = time_ms(lambda: U._launch(go, gin, p))
        rows[name] = {"ms": ms, "of_bound": bound / ms, "span": p.span, "blocks": p.blocks}
        print(f"{str(dtype):15s} {planes:5d} x {str(sp):14s} {name:44s} ms {ms:.5f} "
              f"{bound / ms:5.0%} of the bound ({bound:.4f} ms)", flush=True)
    return {"dtype": str(dtype), "planes": planes, "spatial": list(sp), "bound_ms": bound,
            "plans": rows}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    rows = [sweep(dev, dt, planes, sp) for dt in (torch.bfloat16, torch.float32)
            for planes, sp in SHAPES]
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as fh:
            json.dump({"device": smi, "rows": rows}, fh, indent=1)


if __name__ == "__main__":
    main()
