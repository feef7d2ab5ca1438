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

The next-to-last line is the ``{"kernels": [...]}`` JSON, the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
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


def check_wgrad(dev):
    from deep_prior_interpolation_tpu_torch.ops import wgrad as WG

    k = 3
    cases = [(ci, co, sp, n, torch.bfloat16) for ci, co, sp, n in WGRAD_SHAPES]
    cases += [(ci, co, sp, 0, torch.float32) for ci, co, sp in FLOAT32_SHAPES]
    g = torch.Generator(device=dev).manual_seed(5)
    rows, max_abs, per_iter = [], 0.0, 0.0
    for ci, co, sp, n, dt in cases:
        x = torch.randn((1, ci) + sp, generator=g, device=dev).to(dt)
        dy = torch.randn((1, co) + sp, generator=g, device=dev).to(dt)
        got = WG.wgrad3d(x, dy, k)
        torch.cuda.synchronize()
        ref = WG.wgrad3d_plain(x, dy, k)
        err = float((got - ref).abs().max())
        # both sum float32 products of the same inputs, in other orders
        lim = 1e-4 * float(ref.abs().max()) + 1e-4
        name = str(dt).split(".")[-1]
        row = {"ci": ci, "co": co, "spatial": list(sp), "dtype": name,
               "launches_per_iteration": n, "max_abs_err": err, "tol": lim}
        log(f"wgrad {ci}->{co} {sp} {name}: max abs err {err:.3e} "
            f"(tol {lim:.3e}, 1e-4 of max |dW| + 1e-4)")
        if not err <= lim:
            fail(f"wgrad {ci}->{co} {sp} {name} disagrees with the plain version")
        max_abs = max(max_abs, err)
        del got, ref
        w = torch.empty((co, ci, k, k, k), device=dev, dtype=dt)
        row["ms"] = time_ms(lambda: WG.wgrad3d(x, dy, k))
        row["plain_ms"] = (time_ms(lambda: WG.wgrad3d_plain(x, dy, k))
                           if (ci, co) in PLAIN_TIMED else None)
        # cuDNN with TF32 off: a float32 yardstick for the float32 kernel
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            row["library_ms"] = time_ms(lambda: torch.nn.grad.conv3d_weight(
                x, w.shape, dy, stride=1, padding=1))
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        n_bytes = (ci + co) * math.prod(sp) * x.element_size() + co * ci * k ** 3 * 4
        n_flops = 2.0 * ci * co * _valid_products(sp, k)
        row["bound_ms"], row["bound_by"] = bound_ms(n_bytes, n_flops, dt)
        per_iter += n * row["ms"]
        plain = "not timed" if row["plain_ms"] is None else f"{row['plain_ms']:.4f}"
        log(f"  ms {row['ms']:.4f} plain {plain} conv3d_weight {row['library_ms']:.4f}"
            f"{' (TF32 off)' if dt == torch.float32 else ''} bound "
            f"{row['bound_ms']:.4f} ({row['bound_by']}), {n} launches/iteration, "
            f"{'not slower' if row['ms'] <= row['library_ms'] else 'SLOWER'} than conv3d_weight")
        rows.append(row)
        del x, dy, w
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
    return {"counts": counts, "s_per_iter": steady, "peak_bytes": peak}


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

    fused, fused_grad = check_fused_loss(dev)
    wgrad = check_wgrad(dev)
    torch.cuda.empty_cache()
    check_small_solve(dev)
    torch.cuda.empty_cache()
    main = main_path(dev)
    if "--profile" in sys.argv[1:]:
        profile_flagship(dev, sys.argv[sys.argv.index("--profile") + 1])
    fused["launches"] = main["counts"]["fused_loss"]
    fused_grad["launches"] = main["counts"]["fused_loss_grad"]
    wgrad["launches"] = main["counts"]["wgrad3d"]
    log(json.dumps({"main_path": {"s_per_iter": main["s_per_iter"],
                                  "peak_memory_bytes": main["peak_bytes"]}}))
    log(json.dumps({"kernels": [fused, fused_grad, wgrad]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
