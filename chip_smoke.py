"""Chip smoke test of the PyTorch port on one CUDA card (an H100 for sm_90a).

    python3 chip_smoke.py                # kernels + flagship solve
    python3 chip_smoke.py --profile DIR  # also trace one 3-iteration chunk
                                         # of the flagship solve into DIR

Phases, each of which ends the run with a non-zero exit code on failure:

1. build: one ``nvcc`` per CUDA source of the port, all started together,
   while Triton compiles the fused loss kernel.
2. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the flagship shapes, with the tolerance printed beside the
   error; median times over repeated launches (CUDA events) of the kernel,
   the plain version and, where one exists, the one PyTorch call that
   computes the same function (``library_ms``, timed here only).
3. small: a tiny 3D solve with both kernels on the card against the same
   solve on the CPU (plain versions), same canvas and weights.
4. main path: ``DIPSolver(cfg).solve(img, mask, seed=0)`` on the flagship
   (256, 128, 128) volume, MulResUnet 3D at filters [16..256], inputdepth 64,
   bf16, ``fused_loss`` and ``DPI_PALLAS_WGRAD=1``, 9 iterations in chunks
   of 3. The launch counters are set to 0 just before and read just after;
   every kernel must have launched (fused loss 9 times, wgrad 9 x 32).
   A 3-step solve with the kernels off must give the same iteration-0 loss.

The next-to-last line is the ``{"kernels": [...]}`` JSON, the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and flop/s by input type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
REPEATS = 7


def log(*a) -> None:
    print(*a, flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, repeats: int = REPEATS) -> float:
    """Median milliseconds of ``fn()`` over ``repeats`` runs (CUDA events),
    after one warm-up run."""
    fn()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_flops: float, dtype) -> tuple:
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------

def check_fused_loss(dev):
    from deep_prior_interpolation_tpu_torch.data import flagship_problem
    from deep_prior_interpolation_tpu_torch.ops import fused_loss as FL
    from deep_prior_interpolation_tpu_torch.ops import losses as L

    img_np, mask_np = flagship_problem(256, 128, 128)
    img = torch.from_numpy(img_np[..., 0])[None, None].to(dev)
    mask = torch.from_numpy(mask_np[..., 0])[None, None].to(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    out = (img + torch.randn(img.shape, generator=g, device=dev)).to(torch.bfloat16)

    sums_k = FL.fused_sums(out, img, mask)
    sums_p = FL.fused_sums_plain(out, img, mask)
    loss_k, mets_k = FL.fused_loss_metrics(out, img, mask, "mae")
    # the plain path of the loss and its metrics, as the solver computes them
    loss_p = L.masked_mae(out, img, mask)
    out32 = out.float()
    ref = {"loss": loss_p, "snr": L.snr(out32, img), "pcorr": L.pcorr(out32, img),
           "mse": L.masked_mse(out, img, mask)}
    got = {"loss": loss_k, "snr": mets_k["snr"], "pcorr": mets_k["pcorr"],
           "mse": mets_k["mse"]}
    # float32 sums over 4.19 M terms in another order: relative 1e-4; the
    # one-pass covariance of pcorr against the two-pass form: absolute 1e-3
    tol = {"loss": ("rel", 1e-4), "snr": ("rel", 1e-4), "pcorr": ("abs", 1e-3),
           "mse": ("rel", 1e-4)}
    max_abs = 0.0
    sums_rel = float(((sums_k - sums_p).abs() / sums_p.abs().clamp_min(1e-30)).max())
    log(f"fused_loss sums: max rel err {sums_rel:.3e} (tol 1e-4)")
    if not sums_rel <= 1e-4:
        fail("fused_loss sums disagree with the plain version")
    for k in ref:
        err = abs(float(got[k]) - float(ref[k]))
        max_abs = max(max_abs, err)
        kind, t = tol[k]
        lim = t * abs(float(ref[k])) if kind == "rel" else t
        log(f"fused_loss {k}: kernel {float(got[k]):.7g} plain {float(ref[k]):.7g} "
            f"abs err {err:.3e} (tol {kind} {t:g})")
        if not err <= lim:
            fail(f"fused_loss {k} disagrees with the plain version")

    # gradient: the kernel path's analytic backward against autograd of the
    # plain masked_mae
    o1 = out.clone().requires_grad_(True)
    FL.fused_loss_metrics(o1, img, mask, "mae")[0].backward()
    o2 = out.clone().requires_grad_(True)
    L.masked_mae(o2, img, mask).backward()
    gerr = float((o1.grad.float() - o2.grad.float()).abs().max())
    glim = 1e-3 * float(o2.grad.float().abs().max())
    log(f"fused_loss grad: max abs err {gerr:.3e} (tol {glim:.3e}, 1e-3 of max |grad|)")
    if not gerr <= glim:
        fail("fused_loss gradient disagrees with the plain version")

    entry = {"name": "fused_loss", "route": "triton",
             "source": "deep_prior_interpolation_tpu_torch/ops/fused_loss.py",
             "replaces": "deep_prior_interpolation_tpu/ops/pallas_kernels.py:85",
             "shape": list(out.shape), "max_abs_err": max_abs,
             "tolerance": "sums rel 1e-4; loss/snr/mse rel 1e-4; pcorr abs 1e-3; grad 1e-3 of max",
             "library_ms": None}
    n = out.numel()
    entry["ms"] = time_ms(lambda: FL.fused_sums(out, img, mask))
    entry["plain_ms"] = time_ms(lambda: FL.fused_sums_plain(out, img, mask))
    # ~17 float32 flops an element; each input read once, 8 sums written
    n_bytes = n * (out.element_size() + img.element_size() + mask.element_size()) + 8 * 4
    entry["bound_ms"], entry["bound_by"] = bound_ms(n_bytes, 17.0 * n, torch.float32)
    return entry


# the 3x3x3 stride-1 convs of the flagship MulResUnet 3D whose dW is largest:
# (Ci, Co, spatial)
WGRAD_SHAPES = [
    (64, 4, (256, 128, 128)), (4, 8, (256, 128, 128)), (8, 13, (256, 128, 128)),
    (25, 16, (256, 128, 128)), (67, 4, (256, 128, 128)), (4, 8, (256, 128, 128)),
    (8, 13, (256, 128, 128)), (25, 1, (256, 128, 128)),
    (137, 8, (128, 64, 64)), (554, 35, (32, 16, 16)),
]


def _valid_products(sp, k: int) -> int:
    """Positions x taps that read inside the volume (the padding taps do no work)."""
    p = (k - 1) // 2
    total = 0
    for a in range(-p, p + 1):
        for b in range(-p, p + 1):
            for c in range(-p, p + 1):
                total += (sp[0] - abs(a)) * (sp[1] - abs(b)) * (sp[2] - abs(c))
    return total


def check_wgrad(dev):
    from deep_prior_interpolation_tpu_torch.ops import wgrad as WG

    k = 3
    cases = [(ci, co, sp, torch.bfloat16) for ci, co, sp in WGRAD_SHAPES]
    cases.append((25, 16, (256, 128, 128), torch.float32))
    g = torch.Generator(device=dev).manual_seed(5)
    rows, max_abs = [], 0.0
    for ci, co, sp, dt in cases:
        x = torch.randn((1, ci) + sp, generator=g, device=dev).to(dt)
        dy = torch.randn((1, co) + sp, generator=g, device=dev).to(dt)
        got = WG.wgrad3d(x, dy, k)
        torch.cuda.synchronize()
        ref = WG.wgrad3d_plain(x, dy, k)
        err = float((got - ref).abs().max())
        # both sum float32 products of the same inputs, in other orders
        lim = 1e-4 * float(ref.abs().max()) + 1e-4
        row = {"ci": ci, "co": co, "spatial": list(sp), "dtype": str(dt).split(".")[-1],
               "max_abs_err": err, "tol": lim}
        log(f"wgrad {ci}->{co} {sp} {row['dtype']}: max abs err {err:.3e} "
            f"(tol {lim:.3e}, 1e-4 of max |dW| + 1e-4)")
        if not err <= lim:
            fail(f"wgrad {ci}->{co} {sp} disagrees with the plain version")
        max_abs = max(max_abs, err)
        w = torch.empty((co, ci, k, k, k), device=dev, dtype=dt)
        row["ms"] = time_ms(lambda: WG.wgrad3d(x, dy, k))
        row["plain_ms"] = time_ms(lambda: WG.wgrad3d_plain(x, dy, k), 5)
        row["library_ms"] = time_ms(lambda: torch.nn.grad.conv3d_weight(
            x, w.shape, dy, stride=1, padding=1))
        n_bytes = (ci + co) * math.prod(sp) * x.element_size() + co * ci * k ** 3 * 4
        n_flops = 2.0 * ci * co * _valid_products(sp, k)
        row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_flops, dt)
        log(f"  ms {row['ms']:.3f} plain {row['plain_ms']:.3f} "
            f"library {row['library_ms']:.3f} bound {row['bound_ms']:.4f} "
            f"({row['bound_by']})")
        rows.append(row)
        del x, dy
    entry = {"name": "wgrad3d", "route": "cuda",
             "source": "deep_prior_interpolation_tpu_torch/csrc/wgrad3d.cu",
             "replaces": "deep_prior_interpolation_tpu/ops/pallas_wgrad.py:182",
             "max_abs_err": max_abs,
             "tolerance": "1e-4 of max |dW| + 1e-4 per shape", "shapes": rows}
    # the headline numbers: the heaviest flagship shape, 67 -> 4 at full res
    head = rows[4]
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"):
        entry[key] = head[key]
    entry["shape"] = [head["ci"], head["co"]] + head["spatial"]
    return entry


# ----------------------------------------------------------------------
# phases 3 and 4: the solver
# ----------------------------------------------------------------------

def flagship_config(**kw):
    from deep_prior_interpolation_tpu_torch import Config
    base = dict(datadim="3d", inputdepth=64, filters=[16, 32, 64, 128, 256],
                skip=[16, 32, 64, 128], upsample="linear", loss="mae", lr=1e-3,
                gain=40.0, reg_noise_std=0.03, dtype="bfloat16",
                phase_space=False, remat=False, fused_loss=True, epochs=9,
                scan_chunk=3)
    base.update(kw)
    return Config(**base)


def set_kernels(on: bool) -> None:
    os.environ["DPI_PALLAS_WGRAD"] = "1" if on else "0"


def reset_counts() -> None:
    from deep_prior_interpolation_tpu_torch.ops import fused_loss as FL
    from deep_prior_interpolation_tpu_torch.ops import wgrad as WG
    FL.fused_sums.launches = 0
    WG.wgrad3d.launches = 0


def read_counts() -> dict:
    from deep_prior_interpolation_tpu_torch.ops import fused_loss as FL
    from deep_prior_interpolation_tpu_torch.ops import wgrad as WG
    return {"fused_loss": FL.fused_sums.launches, "wgrad3d": WG.wgrad3d.launches}


def check_small_solve(dev) -> None:
    """Tiny 3D solve, kernels on the card vs plain versions on the CPU."""
    from deep_prior_interpolation_tpu_torch import Config, DIPSolver
    from deep_prior_interpolation_tpu_torch.data import flagship_problem
    from deep_prior_interpolation_tpu_torch.models import init_weights

    img, mask = flagship_problem(16, 16, 16)
    cfg = Config(datadim="3d", inputdepth=4, filters=[4, 8, 16], skip=[4, 4],
                 upsample="linear", epochs=6, scan_chunk=3, reg_noise_std=0.0,
                 fused_loss=True, dtype="float32")
    set_kernels(True)
    # the two devices draw different random streams: share canvas and weights
    noise = (0.1 * np.random.RandomState(0).randn(16, 16, 16, 4)).astype(np.float32)
    cpu = DIPSolver(cfg, device="cpu")
    init_weights(cpu.model, torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in cpu.model.state_dict().items()}
    r_cpu = cpu.solve(img, mask, seed=0, init_params=init, noise=noise)
    reset_counts()
    r_gpu = DIPSolver(cfg, device=dev).solve(img, mask, seed=0, init_params=init,
                                             noise=noise)
    counts = read_counts()
    a, b = np.asarray(r_gpu.history.loss), np.asarray(r_cpu.history.loss)
    # float32 both sides (TF32 off), but cuDNN and the CPU sum in other
    # orders, and Adam's sign-like first steps blow ulp-level differences up
    # within a few iterations (measured on the card: 2e-5 after 4 steps, 7e-3
    # after 6 in one run, 2e-5 in another): hold the first 3 iterations
    err = float(np.max(np.abs(a[:3] - b[:3]) / np.abs(b[:3])))
    log(f"small solve: card {a.tolist()}\n             cpu  {b.tolist()}\n"
        f"             max rel err of iterations 0-2 {err:.3e} (tol 1e-4), "
        f"launches {counts}")
    if not err <= 1e-4:
        fail("the small solve on the card disagrees with the CPU")
    if counts["fused_loss"] != 6 or counts["wgrad3d"] == 0:
        fail(f"small solve did not go through the kernels: {counts}")


def main_path(dev) -> dict:
    from deep_prior_interpolation_tpu_torch import DIPSolver
    from deep_prior_interpolation_tpu_torch.data import flagship_problem

    img, mask = flagship_problem(256, 128, 128)
    cfg = flagship_config()
    set_kernels(True)
    solver = DIPSolver(cfg, outchannel=1, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = solver.solve(img, mask, seed=0)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    loss = np.asarray(res.history.loss)
    log(f"main path: losses {loss.tolist()}")
    log(f"main path: snr {np.asarray(res.history.snr).tolist()}")
    log(f"main path: launches {counts} (expected fused_loss 9, wgrad3d {9 * 32})")
    if not (len(loss) == 9 and np.all(np.isfinite(loss))):
        fail("the flagship loss is not finite for 9 iterations")
    if res.out_best.shape != img.shape or not np.all(np.isfinite(res.out_best)):
        fail(f"out_best has shape {res.out_best.shape} or is not finite")
    if counts != {"fused_loss": 9, "wgrad3d": 9 * 32}:
        fail(f"the main path's launch counts are {counts}")
    steady = statistics.median(res.chunk_seconds[1:]) / cfg.scan_chunk
    log(f"main path: chunk seconds {res.chunk_seconds}")
    log(f"main path: steady s/iteration {steady:.4f} (median of chunks 2..), "
        f"peak memory {peak / 2**30:.2f} GiB")
    del solver

    # the same solve with both kernels off: the same forward pass
    set_kernels(False)
    off = DIPSolver(flagship_config(fused_loss=False, epochs=3), outchannel=1,
                    device=dev).solve(img, mask, seed=0)
    set_kernels(True)
    l_on, l_off = float(loss[0]), float(off.history.loss[0])
    rel = abs(l_on - l_off) / abs(l_off)
    log(f"kernels off: iteration-0 loss {l_off:.7g} vs on {l_on:.7g}, "
        f"rel err {rel:.3e} (tol 1e-5)")
    if not rel <= 1e-5:
        fail("iteration-0 loss differs with the kernels off")
    return {"counts": counts, "s_per_iter": steady, "peak_bytes": peak}


def profile_flagship(dev, out_dir: str) -> None:
    """Trace the second 3-iteration chunk of the flagship solve, kernels on."""
    from deep_prior_interpolation_tpu_torch import DIPSolver
    from deep_prior_interpolation_tpu_torch.data import flagship_problem

    img, mask = flagship_problem(256, 128, 128)
    set_kernels(True)
    res = DIPSolver(flagship_config(epochs=6), device=dev).solve(
        img, mask, seed=0, profile_dir=out_dir)
    log(f"profile: chunk seconds {res.chunk_seconds} (chunk 2 traced)")
    with open(os.path.join(out_dir, "ops.txt")) as fh:
        for line in fh.read().splitlines()[:30]:
            log(f"profile: {line}")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    dev = torch.device("cuda:0")
    # fails here, before any output, when the port is not beside this script
    from deep_prior_interpolation_tpu_torch.ops import _build
    from deep_prior_interpolation_tpu_torch.ops import fused_loss as FL
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.time()
    _build.start_builds()
    probe = torch.ones(8, device=dev)
    FL.fused_sums(probe, probe, probe)  # Triton compiles while nvcc runs
    for name in _build.SOURCES:
        _build.load_library(name)
    torch.cuda.synchronize()
    log(f"kernel build: {time.time() - t0:.1f} s")
    for name, text in _build.build_log.items():
        log(f"nvcc {name}:\n{text.strip()}")

    fused = check_fused_loss(dev)
    wgrad = check_wgrad(dev)
    torch.cuda.empty_cache()
    check_small_solve(dev)
    torch.cuda.empty_cache()
    main = main_path(dev)
    if "--profile" in sys.argv[1:]:
        profile_flagship(dev, sys.argv[sys.argv.index("--profile") + 1])
    fused["launches"] = main["counts"]["fused_loss"]
    wgrad["launches"] = main["counts"]["wgrad3d"]
    log(json.dumps({"main_path": {"s_per_iter": main["s_per_iter"],
                                  "peak_memory_bytes": main["peak_bytes"]}}))
    log(json.dumps({"kernels": [fused, wgrad]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
