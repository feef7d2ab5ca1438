"""Chip smoke test of the PyTorch port on one CUDA card (an H100 for sm_90a).

    python3 chip_smoke.py                # kernels + flagship solve
    python3 chip_smoke.py --profile DIR  # also trace one 3-iteration chunk
                                         # of the flagship solve into DIR

Phases, each of which ends the run with a non-zero exit code on failure:

1. build: one ``nvcc`` per CUDA source of the port, all started together.
2. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at every shape the flagship gives it (fused loss forward and
   backward: the flagship volume with bf16 and float32 ``out``, the
   backward with the main path's incoming gradient and a random one; wgrad:
   the 24 distinct 3x3x3 convs of the net in bf16, and float32 at two of
   them), with the tolerance printed beside the error; times from CUDA
   events around many back-to-back launches divided by their count, after a
   warm-up, of the kernel, the plain version and, where one exists, the one
   PyTorch call that computes the same function (``library_ms``, timed here
   only; the float32 ``conv3d_weight`` with TF32 off). The fused loss's
   kernels are shorter than the host's dispatch of a call, so their times
   come from a CUDA graph of many calls, over copies of the inputs that
   together exceed L2; the eager times are printed beside them. The sum of launches x ms over
   the 32 wgrad launches of an iteration is printed as wgrad ms/iteration.
3. small: a tiny 3D solve with both kernels on the card against the same
   solve on the CPU (plain versions), same canvas and weights.
4. main path: ``DIPSolver(cfg).solve(img, mask, seed=0)`` on the flagship
   (256, 128, 128) volume, MulResUnet 3D at filters [16..256], inputdepth 64,
   bf16, ``fused_loss`` and ``DPI_PALLAS_WGRAD=1``, 9 iterations in chunks
   of 3. The launch counters are set to 0 just before and read just after;
   every kernel must have launched (fused loss forward and backward 9 times
   each, wgrad 9 x 32), and
   a hook on the conv's weight gradient checks that the wgrad shapes are the
   24 of phase 2, each as often as listed there.
   A 3-step solve with the kernels off must give the same iteration-0 loss.
5. the CLI (``cli.run``, on the card by default), three paths, the
   launch counters set to 0 just before each and read just after:
   a. a 3D survey at the flagship's width: a (256, 256, 128) hyperbolic
      volume with 66 % of its traces NaN, written as ``.npy`` files, run
      with the flagship's flags and ``--patch_shape 256 128 128 --gain 40
      --epochs 6 --scan_chunk 3 --save_every 3 --pocs --savemodel``: 2
      patches x 6 iterations, launches 12 / 12 / 384. It checks the bundle
      keys (the JAX package's), one snapshot and one ``_model.pt`` a patch,
      the reconstruction of the run directory against each bundle's
      ``output / 40`` (rtol 1e-6), and that a second run on the same
      directory skips both patches and launches nothing. It prints each
      patch's steady s/iteration, the peak memory and the device ms of one
      ``fk_projection`` at (1, 1, 256, 128, 128) float32;
   b. the README's command on the bundled lines data (170, 100, 1) with
      the default 2D net, ``--pocs --fused_loss --epochs 9``: launches 9 / 9,
      a finite POCS history;
   c. a checkpoint on the card: the small solve's net (nearest upsampling,
      deterministic cuDNN), 6 iterations straight, then cut after chunk 1
      and resumed; the restored state equals the saved one bit for bit and
      iterations 3-5 agree with the straight run (rtol 1e-4).

6. the solver options and the model zoo at full width, the launch counters
   set to 0 just before each run and read just after:
   a. the flagship with ``remat`` and ``virtual_input``, 6 iterations:
      launches 6 / 6 / 192, the iteration-0 loss of phase 4 (rel 1e-5), a
      peak memory below phase 4's (printed beside the prediction);
   b. the flagship with ``remat``, ``dropout=0.1`` and ``param_noise``:
      finite losses, launches 6 / 6 / 192;
   c. the flagship in float32 (the JAX package refuses these options in
      bf16, with ``TypeError``, and so does the port: checked) with
      ``opt_over="net,input"``, ``data_forgetting_factor=5`` and the
      low-pass canvas (250 / 40): the canvas moved, launches, peak memory;
   d. the flagship in float32 with and without ``remat``: peak memory and
      s/iteration;
   e. ``--net skip`` and ``--net unet`` (bf16) and ``--net part`` (float32,
      the only dtype the JAX package runs it in) at the flagship volume and
      flags: a spy on ``conv_same`` counts the convs the wgrad gate admits
      (launches = admitted x 6, fused 6 / 6) and prints those it turns away
      to ``conv3d_weight``; every wgrad shape that phase 2 did not check is
      held against its plain version (1e-4 of max |dW| + 1e-4) and timed
      beside its bound and ``conv3d_weight`` (TF32 off for float32);
   f. the README's 2D command with ``--net attmultiunet``, then ``--net
      part`` (the mask through the CLI): 9 / 9 / 0 each;
   g. the ConvGRU ``Ensemble``: one forward and backward on the card in
      float32 against the CPU in float64.

Each phase's seconds are printed. The ``{"kernels": [...]}`` JSON is the
next-to-last line, the ``{"phase6": ...}``, ``{"cli": ...}`` and
``{"main_path": ...}`` lines before it, the last line ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import collections
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and flop/s by input type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
REPEATS = 3


def log(*a) -> None:
    print(*a, flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _events_ms(fn, n: int) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def time_ms(fn, window_ms: float = 20.0, repeats: int = REPEATS) -> float:
    """Milliseconds of one ``fn()``: CUDA events around n back-to-back calls
    divided by n, n chosen so a window lasts about ``window_ms`` (3 to 500
    calls), after a warm-up; the median of ``repeats`` windows."""
    fn()
    n = max(3, min(500, math.ceil(window_ms / max(_events_ms(fn, 1), 1e-3))))
    return statistics.median(_events_ms(fn, n) for _ in range(repeats))


def graph_ms(fn, calls: int = 60) -> float:
    """Milliseconds of one ``fn()`` on the card alone: ``calls`` calls
    captured in one CUDA graph (after a warm-up on the capture stream) and
    the graph replayed back to back by ``time_ms``, so no host dispatch sits
    between the launches."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay) / calls


def cycling(fn, inputs: list):
    """A call of ``fn`` on the next of ``inputs`` each time: with copies
    that together exceed the 50 MB L2, each call finds its inputs in device
    memory, as the solver's loss does once an iteration."""
    state = {"i": 0}

    def call():
        fn(*inputs[state["i"] % len(inputs)])
        state["i"] += 1
    return call


def bound_ms(n_bytes: float, n_flops: float, dtype) -> tuple:
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------

def _loss_bounds(n: int, out_dtype) -> tuple:
    """(forward, backward) bounds of the fused loss: each input read once,
    each output written once; ~17 and ~16 float32 flops a voxel."""
    esz = torch.empty((), dtype=out_dtype).element_size()
    fwd = bound_ms(n * (esz + 4 + 4) + 8 * 4, 17.0 * n, torch.float32)
    bwd = bound_ms(n * (esz + 4 + 4 + esz) + 8 * 4, 16.0 * n, torch.float32)
    return fwd, bwd


def check_fused_loss(dev):
    """Both fused-loss kernels against their plain versions at the flagship
    size, bf16 and float32 ``out``; returns the forward's and the backward's
    entries of the kernels line (bf16, the main path's, with float32 as a
    variant)."""
    from deep_prior_interpolation_tpu_torch.data import flagship_problem
    from deep_prior_interpolation_tpu_torch.ops import fused_loss as FL
    from deep_prior_interpolation_tpu_torch.ops import losses as L

    img_np, mask_np = flagship_problem(256, 128, 128)
    img = torch.from_numpy(img_np[..., 0])[None, None].to(dev)
    mask = torch.from_numpy(mask_np[..., 0])[None, None].to(dev)
    n = img.numel()
    gen = torch.Generator(device=dev).manual_seed(3)
    noisy = img + torch.randn(img.shape, generator=gen, device=dev)
    outs = {"bfloat16": noisy.to(torch.bfloat16), "float32": noisy}
    # the main path's incoming gradient (mae alone) and one with all 8 non-zero
    g_main = torch.zeros(8, device=dev)
    g_main[0] = 1.0 / n
    g_rand = torch.randn(8, generator=gen, device=dev)
    if not bool((g_rand != 0).all()):
        fail("the random incoming gradient has a zero")

    # forward: float32 sums of 4.19 M terms in another order, relative 1e-4;
    # one launch and no float atomics, so repeated calls are bit-identical
    sums_abs = 0.0
    for name, out in outs.items():
        sums_k = FL.fused_sums(out, img, mask)
        sums_p = FL.fused_sums_plain(out, img, mask)
        rel = float(((sums_k - sums_p).abs() / sums_p.abs().clamp_min(1e-30)).max())
        sums_abs = max(sums_abs, float((sums_k - sums_p).abs().max()))
        same = all(torch.equal(FL.fused_sums(out, img, mask), sums_k) for _ in range(5))
        log(f"fused_loss sums, {name} out: max rel err {rel:.3e} (tol 1e-4), "
            f"5 repeated calls bit-identical: {same}")
        if not rel <= 1e-4:
            fail(f"fused_loss sums ({name} out) disagree with the plain version")
        if not same:
            fail(f"fused_loss sums ({name} out) differ from call to call")

    # the metrics, against the plain path of the loss as the solver computes it
    out = outs["bfloat16"]
    loss_k, mets_k = FL.fused_loss_metrics(out, img, mask, "mae")
    out32 = out.float()
    ref = {"loss": L.masked_mae(out, img, mask), "snr": L.snr(out32, img),
           "pcorr": L.pcorr(out32, img), "mse": L.masked_mse(out, img, mask)}
    got = {"loss": loss_k, "snr": mets_k["snr"], "pcorr": mets_k["pcorr"],
           "mse": mets_k["mse"]}
    # float32 sums in another order: relative 1e-4; the one-pass covariance
    # of pcorr against the two-pass form: absolute 1e-3
    tol = {"loss": ("rel", 1e-4), "snr": ("rel", 1e-4), "pcorr": ("abs", 1e-3),
           "mse": ("rel", 1e-4)}
    for k in ref:
        err = abs(float(got[k]) - float(ref[k]))
        kind, t = tol[k]
        lim = t * abs(float(ref[k])) if kind == "rel" else t
        log(f"fused_loss {k}: kernel {float(got[k]):.7g} plain {float(ref[k]):.7g} "
            f"abs err {err:.3e} (tol {kind} {t:g})")
        if not err <= lim:
            fail(f"fused_loss {k} disagrees with the plain version")

    # backward: the same float32 formula, term by term; within one bf16 ulp
    # of the plain value for bf16 out, 1e-5 of max |plain| for float32
    grad_abs = 0.0
    for name, out in outs.items():
        for gname, g in (("main-path g", g_main), ("random g", g_rand)):
            got = FL.loss_sums_grad(out, img, mask, g).float()
            ref = FL.loss_sums_grad_plain(out, img, mask, g).float()
            err = (got - ref).abs()
            grad_abs = max(grad_abs, float(err.max()))
            if name == "bfloat16":
                ok = bool((err <= 2.0 ** -7 * ref.abs()).all())
                tol_s = "|k-p| <= 2^-7 |p| per element"
            else:
                ok = float(err.max()) <= 1e-5 * float(ref.abs().max())
                tol_s = f"{1e-5 * float(ref.abs().max()):.3e}, 1e-5 of max |p|"
            log(f"fused_loss_grad, {name} out, {gname}: max abs err {float(err.max()):.3e} "
                f"(tol {tol_s})")
            if not ok:
                fail(f"fused_loss_grad ({name} out, {gname}) disagrees with the plain version")
            del got, ref, err

    # end to end: the kernels' gradient of the loss against autograd of the
    # plain masked_mae
    o1 = outs["bfloat16"].clone().requires_grad_(True)
    FL.fused_loss_metrics(o1, img, mask, "mae")[0].backward()
    o2 = outs["bfloat16"].clone().requires_grad_(True)
    L.masked_mae(o2, img, mask).backward()
    gerr = float((o1.grad.float() - o2.grad.float()).abs().max())
    glim = 1e-3 * float(o2.grad.float().abs().max())
    log(f"fused_loss autograd: max abs err {gerr:.3e} (tol {glim:.3e}, 1e-3 of max |grad|)")
    if not gerr <= glim:
        fail("fused_loss gradient disagrees with autograd of masked_mae")
    del o1, o2

    fwd = {"name": "fused_loss", "route": "cuda",
           "source": "deep_prior_interpolation_tpu_torch/csrc/fused_loss.cu",
           "replaces": "deep_prior_interpolation_tpu/ops/pallas_kernels.py:85",
           "shape": list(img.shape), "max_abs_err": sums_abs,
           "tolerance": "sums rel 1e-4; loss/snr/mse rel 1e-4; pcorr abs 1e-3",
           "library_ms": None, "variants": []}
    bwd = {"name": "fused_loss_grad", "route": "cuda",
           "source": "deep_prior_interpolation_tpu_torch/csrc/fused_loss.cu",
           "replaces": "deep_prior_interpolation_tpu/ops/pallas_kernels.py:128",
           "shape": list(img.shape), "max_abs_err": grad_abs,
           "tolerance": "bf16 |k-p| <= 2^-7 |p|; float32 1e-5 of max |p|",
           "library_ms": None, "variants": []}
    # times: "ms" and "plain_ms" on the card alone (CUDA-graph replay), the
    # "eager_" ones back-to-back eager calls, which add the host's dispatch
    # where it is the longer; both over three copies of the inputs (126-151
    # MB), so no call finds its inputs in L2
    fns = {"ms": (FL.fused_sums, FL.loss_sums_grad),
           "plain_ms": (FL.fused_sums_plain, FL.loss_sums_grad_plain)}
    for name, out in outs.items():
        copies = [(out.clone(), img.clone(), mask.clone()) for _ in range(3)]
        grads = [c + (g_main,) for c in copies]
        (fb, fby), (bb, bby) = _loss_bounds(n, out.dtype)
        rows = {"fwd": {"bound_ms": fb, "bound_by": fby},
                "bwd": {"bound_ms": bb, "bound_by": bby}}
        for key, (f_fwd, f_bwd) in fns.items():
            for row, fn, ins in (("fwd", f_fwd, copies), ("bwd", f_bwd, grads)):
                rows[row][key] = graph_ms(cycling(fn, ins))
                rows[row]["eager_" + key] = time_ms(cycling(fn, ins))
        for row, label in (("fwd", "forward"), ("bwd", "backward")):
            r = rows[row]
            log(f"fused_loss {label}, {name} out: ms {r['ms']:.4f} (eager {r['eager_ms']:.4f}) "
                f"plain {r['plain_ms']:.4f} (eager {r['eager_plain_ms']:.4f}) bound "
                f"{r['bound_ms']:.4f} ({r['bound_by']}), {r['bound_ms'] / r['ms']:.0%} of "
                f"the bound's speed")
        for entry, row in ((fwd, rows["fwd"]), (bwd, rows["bwd"])):
            if name == "bfloat16":
                entry.update(row)
            else:
                entry["variants"].append({"out_dtype": name, **row})
        del copies, grads
    return fwd, bwd


# the 24 distinct 3x3x3 stride-1 convs of the flagship MulResUnet 3D
# (filters [16, 32, 64, 128, 256], skip [16, 32, 64, 128], input depth 64)
# and their wgrad launches an iteration: (Ci, Co, spatial, launches)
_L = [(256, 128, 128), (128, 64, 64), (64, 32, 32), (32, 16, 16), (16, 8, 8)]
WGRAD_SHAPES = [
    (64, 4, _L[0], 1), (4, 8, _L[0], 2), (8, 13, _L[0], 2), (25, 16, _L[0], 1),
    (67, 4, _L[0], 1), (25, 1, _L[0], 1),
    (25, 8, _L[1], 1), (8, 17, _L[1], 2), (17, 26, _L[1], 2), (51, 32, _L[1], 1),
    (137, 8, _L[1], 1),
    (51, 17, _L[2], 1), (17, 35, _L[2], 2), (35, 53, _L[2], 2), (105, 64, _L[2], 1),
    (276, 17, _L[2], 1),
    (105, 35, _L[3], 1), (35, 71, _L[3], 2), (71, 106, _L[3], 2), (212, 128, _L[3], 1),
    (554, 35, _L[3], 1),
    (212, 71, _L[4], 1), (71, 142, _L[4], 1), (142, 213, _L[4], 1),
]
# shapes whose plain version is timed too (the others only checked)
PLAIN_TIMED = {(64, 4), (4, 8), (8, 13), (25, 16), (67, 4), (25, 1), (137, 8), (554, 35)}
# float32 (Config's default dtype): the full-resolution 25 -> 16 and a deep shape
FLOAT32_SHAPES = [(25, 16, _L[0]), (554, 35, _L[3])]


def _valid_products(sp, k: int) -> int:
    """Positions x taps that read inside the volume (the padding taps do no work)."""
    p = (k - 1) // 2
    total = 0
    for a in range(-p, p + 1):
        for b in range(-p, p + 1):
            for c in range(-p, p + 1):
                total += (sp[0] - abs(a)) * (sp[1] - abs(b)) * (sp[2] - abs(c))
    return total


def wgrad_row(dev, ci: int, co: int, sp, dt, n: int, g, time_plain: bool,
              k: int = 3) -> dict:
    """One wgrad shape: the kernel against its plain version (1e-4 of max
    |dW| + 1e-4), then its time beside the plain version's (when asked),
    ``conv3d_weight``'s (TF32 off) and its bound."""
    from deep_prior_interpolation_tpu_torch.ops import wgrad as WG

    x = torch.randn((1, ci) + tuple(sp), generator=g, device=dev).to(dt)
    dy = torch.randn((1, co) + tuple(sp), generator=g, device=dev).to(dt)
    got = WG.wgrad3d(x, dy, k)
    torch.cuda.synchronize()
    ref = WG.wgrad3d_plain(x, dy, k)
    err = float((got - ref).abs().max())
    # both sum float32 products of the same inputs, in other orders
    lim = 1e-4 * float(ref.abs().max()) + 1e-4
    name = str(dt).split(".")[-1]
    row = {"ci": ci, "co": co, "spatial": list(sp), "dtype": name,
           "launches_per_iteration": n, "max_abs_err": err, "tol": lim}
    log(f"wgrad {ci}->{co} {tuple(sp)} {name}: max abs err {err:.3e} "
        f"(tol {lim:.3e}, 1e-4 of max |dW| + 1e-4)")
    if not err <= lim:
        fail(f"wgrad {ci}->{co} {tuple(sp)} {name} disagrees with the plain version")
    del got, ref
    w = torch.empty((co, ci, k, k, k), device=dev, dtype=dt)
    row["ms"] = time_ms(lambda: WG.wgrad3d(x, dy, k))
    row["plain_ms"] = time_ms(lambda: WG.wgrad3d_plain(x, dy, k)) if time_plain else None
    # cuDNN with TF32 off: a float32 yardstick for the float32 kernel
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        row["library_ms"] = time_ms(lambda: torch.nn.grad.conv3d_weight(
            x, w.shape, dy, stride=1, padding=(k - 1) // 2))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    n_bytes = (ci + co) * math.prod(sp) * x.element_size() + co * ci * k ** 3 * 4
    n_flops = 2.0 * ci * co * _valid_products(sp, k)
    row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_flops, dt)
    plain = "not timed" if row["plain_ms"] is None else f"{row['plain_ms']:.4f}"
    log(f"  ms {row['ms']:.4f} plain {plain} conv3d_weight {row['library_ms']:.4f}"
        f"{' (TF32 off)' if dt == torch.float32 else ''} bound "
        f"{row['bound_ms']:.4f} ({row['bound_by']}), {n} launches/iteration, "
        f"{'not slower' if row['ms'] <= row['library_ms'] else 'SLOWER'} than conv3d_weight")
    return row


def check_wgrad(dev):
    cases = [(ci, co, sp, n, torch.bfloat16) for ci, co, sp, n in WGRAD_SHAPES]
    cases += [(ci, co, sp, 0, torch.float32) for ci, co, sp in FLOAT32_SHAPES]
    g = torch.Generator(device=dev).manual_seed(5)
    rows, max_abs, per_iter = [], 0.0, 0.0
    for ci, co, sp, n, dt in cases:
        row = wgrad_row(dev, ci, co, sp, dt, n, g, (ci, co) in PLAIN_TIMED)
        max_abs = max(max_abs, row["max_abs_err"])
        per_iter += n * row["ms"]
        rows.append(row)
    log(f"wgrad ms/iteration: sum of launches x ms over the {len(WGRAD_SHAPES)} bf16 "
        f"shapes ({sum(n for *_, n in WGRAD_SHAPES)} launches) = {per_iter:.4f}")
    entry = {"name": "wgrad3d", "route": "cuda",
             "source": "deep_prior_interpolation_tpu_torch/csrc/wgrad3d.cu",
             "replaces": "deep_prior_interpolation_tpu/ops/pallas_wgrad.py:182",
             "max_abs_err": max_abs, "ms_per_iteration": per_iter,
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

FLAGSHIP = dict(datadim="3d", inputdepth=64, filters=[16, 32, 64, 128, 256],
                skip=[16, 32, 64, 128], upsample="linear", loss="mae", lr=1e-3,
                gain=40.0, reg_noise_std=0.03, dtype="bfloat16",
                phase_space=False, remat=False, fused_loss=True, epochs=9,
                scan_chunk=3)


def flagship_config(**kw):
    from deep_prior_interpolation_tpu_torch import Config
    return Config(**{**FLAGSHIP, **kw})


def flagship_flags() -> list:
    """The flagship's configuration as command-line flags."""
    flags = []
    for k, v in FLAGSHIP.items():
        if v is True:
            flags.append(f"--{k}")
        elif isinstance(v, list):
            flags += [f"--{k}"] + [str(x) for x in v]
        elif v is not False:
            flags += [f"--{k}", str(v)]
    return flags


def set_kernels(on: bool) -> None:
    os.environ["DPI_PALLAS_WGRAD"] = "1" if on else "0"


def reset_counts() -> None:
    from deep_prior_interpolation_tpu_torch.ops import fused_loss as FL
    from deep_prior_interpolation_tpu_torch.ops import wgrad as WG
    FL.fused_sums.launches = 0
    FL.loss_sums_grad.launches = 0
    WG.wgrad3d.launches = 0


def read_counts() -> dict:
    from deep_prior_interpolation_tpu_torch.ops import fused_loss as FL
    from deep_prior_interpolation_tpu_torch.ops import wgrad as WG
    return {"fused_loss": FL.fused_sums.launches,
            "fused_loss_grad": FL.loss_sums_grad.launches, "wgrad3d": WG.wgrad3d.launches}


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
    if counts["fused_loss"] != 6 or counts["fused_loss_grad"] != 6 or counts["wgrad3d"] == 0:
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
    # a hook on the conv's weight gradient records the shapes it is asked for
    from deep_prior_interpolation_tpu_torch.ops import conv_vjp
    seen, real = collections.Counter(), conv_vjp.wgrad3d

    def hook(x, dy, k):
        seen[(x.shape[1], dy.shape[1], tuple(x.shape[2:]))] += 1
        return real(x, dy, k)

    conv_vjp.wgrad3d = hook
    reset_counts()
    try:
        res = solver.solve(img, mask, seed=0)
    finally:
        conv_vjp.wgrad3d = real
    counts = read_counts()
    want = {(ci, co, sp): 9 * n for ci, co, sp, n in WGRAD_SHAPES}
    if dict(seen) != want:
        fail(f"the main path's wgrad shapes are {dict(seen)}, not {want}")
    log(f"main path: wgrad shapes as listed in the kernel phase ({len(seen)} distinct)")
    peak = torch.cuda.max_memory_allocated()
    loss = np.asarray(res.history.loss)
    log(f"main path: losses {loss.tolist()}")
    log(f"main path: snr {np.asarray(res.history.snr).tolist()}")
    log(f"main path: launches {counts} (expected fused_loss 9, fused_loss_grad 9, "
        f"wgrad3d {9 * 32})")
    if not (len(loss) == 9 and np.all(np.isfinite(loss))):
        fail("the flagship loss is not finite for 9 iterations")
    if res.out_best.shape != img.shape or not np.all(np.isfinite(res.out_best)):
        fail(f"out_best has shape {res.out_best.shape} or is not finite")
    if counts != {"fused_loss": 9, "fused_loss_grad": 9, "wgrad3d": 9 * 32}:
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
    return {"counts": counts, "s_per_iter": steady, "peak_bytes": peak, "loss0": l_on}


# ----------------------------------------------------------------------
# phase 5: the CLI
# ----------------------------------------------------------------------

# the keys of the JAX package's run bundle, in its order (io/results.py)
BUNDLE_KEYS = ["device", "elapsed", "elapsed_seconds", "outpath", "history", "mask",
               "image", "output", "noise", "pocs"]


class solves:
    """Records every ``DIPSolver.solve`` result while the block runs."""

    def __enter__(self):
        from deep_prior_interpolation_tpu_torch.engine import DIPSolver
        self.results, self.real, cls = [], DIPSolver.solve, DIPSolver

        def spy(solver, *a, **k):
            res = self.real(solver, *a, **k)
            self.results.append(res)
            return res
        cls.solve = spy
        return self

    def __exit__(self, *exc):
        from deep_prior_interpolation_tpu_torch.engine import DIPSolver
        DIPSolver.solve = self.real


def cli_survey(dev, tmp: str) -> dict:
    """A 3D survey of two flagship-size patches through ``cli.run``."""
    from deep_prior_interpolation_tpu_torch import cli
    from deep_prior_interpolation_tpu_torch.config import parse_arguments
    from deep_prior_interpolation_tpu_torch.data import (hyperbolic_events,
                                                         random_trace_mask,
                                                         reconstruct_patches)
    from deep_prior_interpolation_tpu_torch.io import load_run
    from deep_prior_interpolation_tpu_torch.ops.pocs import fk_projection

    vol = hyperbolic_events(256, 256, 128)
    kept = random_trace_mask(vol.shape, 0.66, 1) > 0
    np.save(os.path.join(tmp, "original.npy"), vol)
    np.save(os.path.join(tmp, "corrupted.npy"), np.where(kept, vol, np.nan).astype(np.float32))
    cfg = parse_arguments(flagship_flags() + [
        "--imgdir", tmp, "--imgname", "original.npy", "--maskname", "corrupted.npy",
        "--outdir", "survey", "--datadim", "3d", "--patch_shape", "256", "128", "128",
        "--gain", "40", "--epochs", "6", "--scan_chunk", "3", "--save_every", "3",
        "--pocs", "--savemodel"])
    set_kernels(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with solves() as rec:
        out = cli.run(cfg, results_root=tmp)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"cli survey: launches {counts} (expected fused_loss 12, fused_loss_grad 12, "
        f"wgrad3d {2 * 6 * 32})")
    if counts != {"fused_loss": 12, "fused_loss_grad": 12, "wgrad3d": 2 * 6 * 32}:
        fail(f"the survey's launch counts are {counts}")
    if len(rec.results) != 2:
        fail(f"the survey solved {len(rec.results)} patches, not 2")

    files = set(os.listdir(out))
    for i, name in enumerate(("0", "1")):
        for f in (f"{name}_run.npz", f"{name}_output3.npy", f"{name}_model.pt"):
            if f not in files:
                fail(f"the survey did not write {f}: {sorted(files)}")
        with np.load(os.path.join(out, f"{name}_run.npz"), allow_pickle=True) as z:
            if list(z.files) != BUNDLE_KEYS:
                fail(f"bundle {name} has keys {z.files}, not {BUNDLE_KEYS}")
        b = load_run(os.path.join(out, f"{name}_run.npz"))
        hist = b["history"]
        if not all(len(v) == 6 and np.all(np.isfinite(v)) for v in hist.values()):
            fail(f"patch {name}'s history is not 6 finite iterations: {hist}")
        log(f"cli survey: patch {name} loss {hist['loss']}\n"
            f"            df {hist['df']}\n            reg {hist['reg']}\n"
            f"            eps {hist['eps']}\n            th {hist['th']}")
        if b["output"].shape != (256, 128, 128, 1) or not np.all(np.isfinite(b["pocs"])):
            fail(f"patch {name}: output {b['output'].shape}, pocs finite "
                 f"{np.all(np.isfinite(b['pocs']))}")
        if b["device"] != f"{torch.cuda.get_device_name(0)} (0)":
            fail(f"patch {name} was solved on {b['device']}")

    rec_vol = reconstruct_patches(cfg, results_dir=out)
    if rec_vol.shape != (256, 256, 128) or not np.all(np.isfinite(rec_vol)):
        fail(f"the reconstruction has shape {rec_vol.shape} or is not finite")
    rel = 0.0
    for i, name in enumerate(("0", "1")):
        want = load_run(os.path.join(out, f"{name}_run.npz"))["output"][..., 0] / 40.0
        w = want.shape[1]  # the patches tile the x axis
        got = rec_vol[:, w * i:w * (i + 1)]
        rel = max(rel, float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30))))
    log(f"cli survey: reconstruction {rec_vol.shape}, max rel err against each bundle's "
        f"output / 40 {rel:.3e} (tol 1e-6)")
    if not rel <= 1e-6:
        fail("the reconstruction disagrees with the bundles")

    reset_counts()
    with solves() as again:
        cli.run(cfg, results_root=tmp)
    if again.results or any(read_counts().values()):
        fail(f"the resumed survey solved {len(again.results)} patches, "
             f"launches {read_counts()}")
    log("cli survey: a second run on the same directory skipped both patches, "
        "launched nothing")

    steady = [r.chunk_seconds[1] / cfg.scan_chunk for r in rec.results]
    log(f"cli survey: chunk seconds {[r.chunk_seconds for r in rec.results]}, steady "
        f"s/iteration {steady}, peak memory {peak / 2**30:.2f} GiB")

    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn((1, 1, 256, 128, 128), generator=g, device=dev)
    m = (torch.rand(x.shape, generator=g, device=dev) > 0.66).float()
    wd, wm = 0.1 * x * m, 1.0 - 0.1 * m
    fk_ms = time_ms(lambda: fk_projection(x, wd, wm, 5.0))
    log(f"cli survey: fk_projection (1, 1, 256, 128, 128) float32 {fk_ms:.4f} ms")
    return {"launches": counts, "s_per_iter": steady, "peak_memory_bytes": peak,
            "fk_projection_ms": fk_ms}


def cli_lines(tmp: str, extra=(), outdir: str = "lines") -> dict:
    """The README's command on the bundled lines data, with POCS (and the
    ``extra`` flags, such as another ``--net``)."""
    from deep_prior_interpolation_tpu_torch import cli
    from deep_prior_interpolation_tpu_torch.config import parse_arguments
    from deep_prior_interpolation_tpu_torch.data import dataset_path
    from deep_prior_interpolation_tpu_torch.engine import HistoryPOCS
    from deep_prior_interpolation_tpu_torch.io import load_run

    cfg = parse_arguments([
        "--imgdir", os.path.dirname(dataset_path("lines/original.npy")),
        "--imgname", "original.npy", "--maskname", "random66.npy", "--datadim", "2d",
        "--outdir", outdir, "--pocs", "--pocs_alpha", "0.1", "--pocs_thresh", "5",
        "--fused_loss", "--epochs", "9", "--gain", "1", *extra])
    reset_counts()
    out = cli.run(cfg, results_root=tmp)
    counts = read_counts()
    hist = load_run(os.path.join(out, "0_run.npz"))["history"]
    log(f"cli lines {' '.join(extra)}: launches {counts} (expected 9, 9, 0), "
        f"loss {hist['loss']}")
    if counts != {"fused_loss": 9, "fused_loss_grad": 9, "wgrad3d": 0}:
        fail(f"the lines run {extra}'s launch counts are {counts}")
    if set(hist) != set(HistoryPOCS.FIELDS) or not all(
            len(v) == 9 and np.all(np.isfinite(v)) for v in hist.values()):
        fail(f"the lines run {extra}'s history is not 9 finite POCS iterations: {hist}")
    return {"launches": counts, "loss": hist["loss"]}


def check_checkpoint(dev, tmp: str) -> dict:
    """The small solve's net: 6 iterations straight, then cut after chunk 1
    and resumed, on the card. Its upsampling is nearest, whose backward is a
    gather, and cuDNN picks deterministic algorithms: the trilinear
    backward's atomics made two runs of the same state drift apart by 1e-4
    in 3 iterations, which would hide what the resume does."""
    from deep_prior_interpolation_tpu_torch import Config, DIPSolver
    from deep_prior_interpolation_tpu_torch.data import flagship_problem
    from deep_prior_interpolation_tpu_torch.io import checkpoint as ckpt_io

    img, mask = flagship_problem(16, 16, 16)
    cfg = Config(datadim="3d", inputdepth=4, filters=[4, 8, 16], skip=[4, 4],
                 upsample="nearest", epochs=6, scan_chunk=3, fused_loss=True,
                 dtype="float32")
    set_kernels(True)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _checkpoint_round_trip(cfg, img, mask, dev, tmp)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _checkpoint_round_trip(cfg, img, mask, dev, tmp: str) -> dict:
    from deep_prior_interpolation_tpu_torch import Config, DIPSolver
    from deep_prior_interpolation_tpu_torch.io import checkpoint as ckpt_io

    straight = DIPSolver(cfg, device=dev).solve(img, mask, seed=0)
    path = os.path.join(tmp, "state.npz")
    seen = {}
    save, load = ckpt_io.save_solver_state, ckpt_io.load_solver_state

    def spy_save(p, state, extra=None):
        seen["saved"] = {k: v.clone() for k, v in state.items()}
        return save(p, state, extra)

    def spy_load(p, template):
        seen["loaded"] = load(p, template)
        return seen["loaded"]
    ckpt_io.save_solver_state, ckpt_io.load_solver_state = spy_save, spy_load
    try:
        DIPSolver(Config(**{**cfg.to_dict(), "epochs": 3}), device=dev).solve(
            img, mask, seed=0, checkpoint_path=path, checkpoint_every=1)
        resumed = DIPSolver(cfg, device=dev).solve(img, mask, seed=0, checkpoint_path=path)
    finally:
        ckpt_io.save_solver_state, ckpt_io.load_solver_state = save, load
    saved, loaded = seen["saved"], seen["loaded"]
    same = {k: bool(loaded[k].dtype == v.dtype and loaded[k].device == v.device
                    and torch.equal(loaded[k], v)) for k, v in saved.items()}
    log(f"checkpoint: restored state equal to the saved one bit for bit: {same}")
    if set(loaded) != set(saved) or not all(same.values()):
        fail("the restored state differs from the saved one")
    if "cuda" not in str(saved["params"].device):
        fail(f"the solver state was on {saved['params'].device}, not the card")
    a, b = np.asarray(resumed.history.loss), np.asarray(straight.history.loss)
    rel = float(np.max(np.abs(a[3:] - b[3:]) / np.abs(b[3:])))
    bitwise = bool(np.array_equal(a, b) and np.array_equal(resumed.out_best, straight.out_best))
    log(f"checkpoint: straight {b.tolist()}\n            resumed  {a.tolist()}\n"
        f"            max rel err of iterations 3-5 {rel:.3e} (tol 1e-4), "
        f"history and out_best bit-equal: {bitwise}")
    if len(a) != 6 or resumed.iters_run != 6 or not rel <= 1e-4:
        fail("the resumed solve disagrees with the straight one")
    return {"state_equal": True, "resumed_rel_err": rel, "resumed_bitwise": bitwise}


# ----------------------------------------------------------------------
# phase 6: the solver options and the model zoo at full width
# ----------------------------------------------------------------------

# what was predicted for 6a's peak before the first card run of it (PERF.md)
PREDICTED_6A = ("remat frees the insides of every MultiResBlock and ResPath and the "
                "virtual canvas its 0.5 GiB: 6-9 GiB")
SIX = {"fused_loss": 6, "fused_loss_grad": 6, "wgrad3d": 6 * 32}


def option_solve(dev, label: str, cfg, img, mask, expect=None, seed: int = 0):
    """One solve, the launch counters set to 0 just before and read just
    after, with its peak memory and steady s/iteration (chunk 2); fails on a
    non-finite loss, or launch counts other than ``expect``."""
    from deep_prior_interpolation_tpu_torch import DIPSolver

    set_kernels(True)
    solver = DIPSolver(cfg, outchannel=1, device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = solver.solve(img, mask, seed=seed)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    loss = np.asarray(res.history.loss)
    steady = res.chunk_seconds[min(1, len(res.chunk_seconds) - 1)] / cfg.scan_chunk
    log(f"{label}: losses {loss.tolist()}\n  launches {counts}, peak memory "
        f"{peak / 2**30:.2f} GiB, chunk seconds {res.chunk_seconds}, steady s/iteration "
        f"{steady:.4f}")
    if not (len(loss) == cfg.epochs and np.all(np.isfinite(loss))):
        fail(f"{label}: the loss is not finite for {cfg.epochs} iterations")
    if expect is not None and counts != expect:
        fail(f"{label}: launch counts {counts}, expected {expect}")
    del solver
    return {"losses": loss.tolist(), "launches": counts, "peak_bytes": peak,
            "s_per_iter": steady}, res


def check_options(dev, main: dict) -> dict:
    """6a-6d: remat, the virtual canvas, dropout, parameter noise, input
    optimisation, data forgetting and the low-pass canvas on the flagship."""
    from deep_prior_interpolation_tpu_torch import DIPSolver
    from deep_prior_interpolation_tpu_torch.data import flagship_problem
    from deep_prior_interpolation_tpu_torch.engine import build_base_input
    from deep_prior_interpolation_tpu_torch.engine.solver import _generators

    img, mask = flagship_problem(256, 128, 128)
    out = {}
    six = dict(epochs=6, scan_chunk=3)
    r, _ = option_solve(dev, "6a remat + virtual_input",
                        flagship_config(remat=True, virtual_input=True, **six), img, mask, SIX)
    rel = abs(r["losses"][0] - main["loss0"]) / abs(main["loss0"])
    cut = main["peak_bytes"] - r["peak_bytes"]
    log(f"6a: iteration-0 loss {r['losses'][0]:.7g} vs phase 4's {main['loss0']:.7g}, rel "
        f"err {rel:.3e} (tol 1e-5); peak {r['peak_bytes'] / 2**30:.2f} GiB vs phase 4's "
        f"{main['peak_bytes'] / 2**30:.2f} GiB: {cut / 2**30:.2f} GiB less "
        f"(predicted: {PREDICTED_6A})")
    if not rel <= 1e-5:
        fail("6a: the iteration-0 loss differs from phase 4's")
    if not cut > 0:
        fail("6a: remat and the virtual canvas did not lower the peak memory")
    out["6a_remat_virtual"] = dict(r, loss0_rel_err=rel)

    r, _ = option_solve(dev, "6b remat + dropout 0.1 + param_noise",
                        flagship_config(remat=True, dropout=0.1, param_noise=True, **six),
                        img, mask, SIX)
    out["6b_remat_dropout_param_noise"] = r

    for remat in (False, True):
        r, _ = option_solve(dev, f"6d float32{' + remat' if remat else ''}",
                            flagship_config(dtype="float32", remat=remat, **six), img, mask,
                            SIX)
        out[f"6d_float32{'_remat' if remat else ''}"] = r

    # the JAX package refuses a bfloat16 canvas under optimisation
    try:
        DIPSolver(flagship_config(opt_over="net,input", **six), device=dev).solve(img, mask)
        fail("6c: opt_over='net,input' under bfloat16 did not raise TypeError")
    except TypeError as e:
        log(f"6c: under bfloat16 the options raise TypeError, as in the JAX package: {e}")
    cfg = flagship_config(dtype="float32", opt_over="net,input", data_forgetting_factor=5,
                          lowpass_fs=250.0, lowpass_fc=40.0, **six)
    r, res = option_solve(dev, "6c float32 opt_over=net,input + forgetting 5 + low-pass",
                          cfg, img, mask, SIX)
    first = build_base_input(cfg, _generators(0, dev)["canvas"], (256, 128, 128), dev)
    moved = float((torch.from_numpy(res.noise).to(dev)
                   - first[0].permute(1, 2, 3, 0)).abs().max())
    log(f"6c: the canvas moved by max |d| {moved:.4e} in 6 iterations")
    if not moved > 0:
        fail("6c: the optimised canvas did not move")
    out["6c_opt_input_forgetting_lowpass"] = dict(r, canvas_max_abs_change=moved)
    del res, first
    return out


def check_zoo(dev) -> dict:
    """6e: skip, unet (bf16) and part (float32, which the JAX package runs
    only so) at the flagship volume and flags, 6 iterations each; every conv
    that reaches the wgrad kernel recorded, each new shape held against the
    plain version and timed."""
    from deep_prior_interpolation_tpu_torch.data import flagship_problem
    from deep_prior_interpolation_tpu_torch.ops import conv_vjp
    from deep_prior_interpolation_tpu_torch.ops import wgrad as WG

    img, mask = flagship_problem(256, 128, 128)
    flagship = {(ci, co, sp, "bfloat16") for ci, co, sp, _ in WGRAD_SHAPES}
    flagship |= {(ci, co, sp, "float32") for ci, co, sp in FLOAT32_SHAPES}
    g = torch.Generator(device=dev).manual_seed(6)
    out = {}
    for net, dtype in (("skip", "bfloat16"), ("unet", "bfloat16"), ("part", "float32")):
        convs, seen = collections.Counter(), collections.Counter()
        real_conv, real_wgrad = conv_vjp._ConvSame.apply, conv_vjp.wgrad3d

        def spy_conv(x, w, stride, padding):
            if x.is_cuda:  # not the net's build pass on the CPU
                convs[(tuple(x.shape), tuple(w.shape), stride, padding, str(x.dtype))] += 1
            return real_conv(x, w, stride, padding)

        def hook(x, dy, k):
            seen[(x.shape[1], dy.shape[1], tuple(x.shape[2:]),
                  str(x.dtype).split(".")[-1])] += 1
            return real_wgrad(x, dy, k)
        conv_vjp._ConvSame.apply = spy_conv
        conv_vjp.wgrad3d = hook
        try:
            r, _ = option_solve(dev, f"6e --net {net} ({dtype})",
                                flagship_config(net=net, dtype=dtype, epochs=6, scan_chunk=3),
                                img, mask)
        finally:
            del conv_vjp._ConvSame.apply
            conv_vjp.wgrad3d = real_wgrad
        admitted = sum(n for (xs, ws, st, p, _), n in convs.items()
                       if WG.wgrad_supported(xs, ws, st, p))
        away = sorted({(xs[1], ws[0], ws[2], st, xs[2:]) for (xs, ws, st, p, _), n
                       in convs.items() if not WG.wgrad_supported(xs, ws, st, p)})
        log(f"6e --net {net}: {admitted // 6} of {sum(convs.values()) // 6} conv_same calls "
            f"an iteration reach the wgrad kernel; turned away to conv3d_weight "
            f"(Ci, Co, k, stride, spatial): {away}")
        c = r["launches"]
        if c["wgrad3d"] != admitted or admitted % 6 or c["fused_loss"] != 6 \
                or c["fused_loss_grad"] != 6:
            fail(f"6e --net {net}: launches {c}, expected fused 6 / 6 and wgrad "
                 f"{admitted} ({admitted // 6} admitted convs x 6)")
        rows = []
        for (ci, co, sp, dt), n in sorted(seen.items(), key=lambda kv: -math.prod(kv[0][2])):
            if (ci, co, sp, dt) in flagship:
                continue
            rows.append(wgrad_row(dev, ci, co, sp, getattr(torch, dt), n // 6, g, False))
        per_iter = sum(row["ms"] * row["launches_per_iteration"] for row in rows)
        log(f"6e --net {net}: {len(rows)} new wgrad shapes, their ms/iteration {per_iter:.4f}")
        out[net] = dict(r, dtype=dtype, wgrad_launches_per_iteration=admitted // 6,
                        turned_away=[list(map(str, a)) for a in away], wgrad_shapes=rows)
        torch.cuda.empty_cache()
    return out


def check_ensemble(dev) -> dict:
    """6g: the ConvGRU ensemble (a library net, outside the solver): one
    forward and backward on the card, float32 with TF32 off, against the
    same on the CPU in float64. Its gradients pass through ~40 Norms: in
    float32 they hold to ~1 % of the largest gradient only (measured on the
    CPU, float32 against float64: 0.96 % at the stem conv, the output
    2.4e-5 of its largest value)."""
    import copy

    from deep_prior_interpolation_tpu_torch.models import Ensemble, init_weights

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    m = Ensemble(1, 1, num_frames=2, hidden=16)
    init_weights(m, torch.Generator().manual_seed(0), "xavier", 0.02)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((1, 1, 128, 128), generator=gen)
    cot = torch.randn((2, 1, 128, 128), generator=gen)

    def run(d, dt):
        mm = copy.deepcopy(m).to(d, dt)
        o = mm(x.to(d, dt))
        (o * cot.to(d, dt)).sum().backward()
        return (o.detach().cpu().double(),
                {n: p.grad.detach().cpu().double() for n, p in mm.named_parameters()})
    o_gpu, g_gpu = run(dev, torch.float32)
    o_cpu, g_cpu = run("cpu", torch.float64)
    out_err = float((o_gpu - o_cpu).abs().max()) / float(o_cpu.abs().max())
    g_max = max(float(v.abs().max()) for v in g_cpu.values())
    g_err = max(float((g_gpu[k] - v).abs().max()) for k, v in g_cpu.items()) / g_max
    log(f"6g Ensemble (128 x 128, 2 frames, hidden 16): output max err {out_err:.3e} of its "
        f"max (tol 2e-4), gradients max err {g_err:.3e} of the largest (tol 3e-2)")
    if not (out_err <= 2e-4 and g_err <= 3e-2):
        fail("6g: the ensemble on the card disagrees with the CPU")
    return {"output_rel_err": out_err, "grad_rel_err": g_err}


# kernel families of the profile, by the first pattern a kernel name holds
FAMILIES = [
    ("wgrad3d (kernel 2)", ("wgrad3d",)),
    ("fused loss forward (kernel 1)", ("loss_sums_kernel",)),
    ("fused loss backward (kernel 1)", ("loss_grad_kernel",)),
    ("cuDNN conv forward", ("fprop",)),
    ("cuDNN conv dgrad", ("dgrad",)),
    ("cuDNN NCDHW<->NDHWC transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("trilinear upsample fwd + bwd", ("upsample",)),
    ("reductions (Norm statistics)", ("reduce_kernel",)),
    ("GEMMs (1x1 convs)", ("gemm",)),
    ("elementwise, casts, copies", ("elementwise", "copy", "Memset", "Memcpy")),
]


def profile_flagship(dev, out_dir: str) -> None:
    """Trace the second 3-iteration chunk of the flagship solve, kernels on,
    and print its device time an iteration by kernel family."""
    from deep_prior_interpolation_tpu_torch import DIPSolver
    from deep_prior_interpolation_tpu_torch.data import flagship_problem

    img, mask = flagship_problem(256, 128, 128)
    set_kernels(True)
    cfg = flagship_config(epochs=6)
    res = DIPSolver(cfg, device=dev).solve(img, mask, seed=0, profile_dir=out_dir)
    log(f"profile: chunk seconds {res.chunk_seconds} (chunk 2 traced)")
    with open(os.path.join(out_dir, "ops.txt")) as fh:
        head, *rows = fh.read().splitlines()
    log(f"profile: {head}")
    total = float(head.split("device kernels ")[1].split(" ms")[0])
    fams = collections.Counter()
    for line in rows:  # "<ms> ms <count>x  <kernel>", the kernels by time
        ms, _, _, name = line.split(maxsplit=3)
        fam = next((f for f, pats in FAMILIES if any(p in name for p in pats)), "other")
        fams[fam] += float(ms)
    fams["below the listed kernels"] = total - sum(fams.values())
    per = cfg.scan_chunk
    log(f"profile: device ms an iteration by family ({per} iterations traced):")
    for fam, ms in fams.most_common():
        log(f"profile:   {fam:34s} {ms / per:9.3f} ms  {ms / total:6.1%}")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    dev = torch.device("cuda:0")
    # fails here, before any output, when the port is not beside this script
    from deep_prior_interpolation_tpu_torch.ops import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.time()
    _build.start_builds()
    for name in _build.SOURCES:
        _build.load_library(name)
    torch.cuda.synchronize()
    log(f"kernel build: {time.time() - t0:.1f} s")
    for name, text in _build.build_log.items():
        log(f"nvcc {name}:\n{text.strip()}")

    seconds = {"1_build": time.time() - t0}

    def phase(name, fn, *args):
        t = time.time()
        result = fn(*args)
        torch.cuda.empty_cache()
        seconds[name] = time.time() - t
        log(f"phase {name}: {seconds[name]:.1f} s")
        return result

    fused, fused_grad = phase("2_fused_loss", check_fused_loss, dev)
    wgrad = phase("2_wgrad", check_wgrad, dev)
    phase("3_small_solve", check_small_solve, dev)
    main = phase("4_main_path", main_path, dev)
    if "--profile" in sys.argv[1:]:
        profile_flagship(dev, sys.argv[sys.argv.index("--profile") + 1])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        survey = phase("5_cli_survey", cli_survey, dev, tmp)
        lines = phase("5_cli_lines", cli_lines, tmp)
        checkpoint = phase("5_checkpoint", check_checkpoint, dev, tmp)
        options = phase("6a-d_options", check_options, dev, main)
        zoo = phase("6e_zoo", check_zoo, dev)
        zoo_2d = {net: phase(f"6f_lines_{net}", cli_lines, tmp, ("--net", net), f"lines_{net}")
                  for net in ("attmultiunet", "part")}
        ensemble = phase("6g_ensemble", check_ensemble, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase seconds: {json.dumps(seconds)}")
    fused["launches"] = main["counts"]["fused_loss"]
    fused_grad["launches"] = main["counts"]["fused_loss_grad"]
    wgrad["launches"] = main["counts"]["wgrad3d"]
    log(json.dumps({"main_path": {"s_per_iter": main["s_per_iter"],
                                  "peak_memory_bytes": main["peak_bytes"]}}))
    log(json.dumps({"cli": {"survey_3d": survey, "lines_2d": lines,
                            "checkpoint": checkpoint}}))
    log(json.dumps({"phase6": {"options": options, "zoo_3d": zoo, "zoo_2d": zoo_2d,
                               "ensemble": ensemble, "seconds": seconds}}))
    log(json.dumps({"kernels": [fused, fused_grad, wgrad]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
