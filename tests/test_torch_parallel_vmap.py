"""The vmap rules that batch a net over patches (parallel/mesh.py) on the CPU:
the conv (values and both gradients, "conv" and "tapmm"), the fused loss and
the linear upsample under ``torch.func.vmap`` against a loop over lanes; the
kernels' lane-batched plain versions against per-lane calls; dropout's
per-lane draws, remat under vmap and the wgrad planner's lane grids."""
import json

import numpy as np
import pytest
import torch
from torch.func import functional_call, vmap

from deep_prior_interpolation_tpu_torch import Config
from deep_prior_interpolation_tpu_torch.models import (Dropout, get_net, init_weights,
                                                       set_dropout_generator)
from deep_prior_interpolation_tpu_torch.ops import conv_vjp as cv
from deep_prior_interpolation_tpu_torch.ops import fused_loss as FL
from deep_prior_interpolation_tpu_torch.ops import upsample as U
from deep_prior_interpolation_tpu_torch.ops import wgrad as WG

torch.set_num_threads(1)
B = 3


def _per_lane_grads(fn, args, g):
    """Outputs and gradients of ``fn`` lane by lane."""
    outs, grads = [], []
    for b in range(B):
        lane = [a[b].detach().requires_grad_(a.requires_grad) for a in args]
        y = fn(*lane)
        outs.append(y.detach())
        grads.append(torch.autograd.grad(y, [a for a in lane if a.requires_grad], g[b]))
    return torch.stack(outs), [torch.stack(gs) for gs in zip(*grads)]


@pytest.mark.parametrize("nd,mode,stride,pads", [
    (2, "conv", 1, ((1, 1), (1, 1))),
    (3, "conv", 1, ((1, 1),) * 3),
    (3, "conv", 2, ((1, 1),) * 3),
    (2, "conv", 1, ((0, 1), (1, 2))),     # asymmetric pads (phase convs)
    (2, "tapmm", 1, ((1, 1), (1, 1))),
    (3, "tapmm", 2, ((1, 0),) * 3),
])
def test_conv_vmap_rule_matches_a_loop_over_lanes(nd, mode, stride, pads):
    """float64, so the grouped conv and the per-lane conv agree to rounding."""
    rng = np.random.RandomState(nd + stride)
    sp = (8, 6, 10)[:nd]
    x = torch.from_numpy(rng.randn(B, 1, 3, *sp)).requires_grad_()
    w = torch.from_numpy(rng.randn(B, 4, 3, *(3,) * nd)).requires_grad_()

    def conv(xx, ww):
        with cv.conv_impl(mode):
            return cv.conv_same(xx, ww, stride, pads)
    y = vmap(conv)(x, w)
    g = torch.from_numpy(rng.randn(*y.shape))
    dx, dw = torch.autograd.grad(y, (x, w), g)
    y1, (dx1, dw1) = _per_lane_grads(conv, (x, w), g)
    for a, b in ((y, y1), (dx, dx1), (dw, dw1)):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)


def test_conv_vmap_records_its_formulation_for_another_thread():
    """The lane conv's backward, run on another thread (as autograd runs a
    CUDA backward), takes the formulation it was called under."""
    import threading
    x = torch.randn(B, 1, 2, 6, 6, requires_grad=True)
    w = torch.randn(B, 3, 2, 3, 3, requires_grad=True)
    with cv.conv_impl("tapmm"):
        y = vmap(lambda a, b: cv.conv_same(a, b, 1, 1))(x, w)
    called = []
    real = cv._tap_conv_weight_lanes
    cv._tap_conv_weight_lanes = lambda *a: called.append(1) or real(*a)
    try:
        t = threading.Thread(target=lambda: y.sum().backward())
        t.start()
        t.join()
    finally:
        cv._tap_conv_weight_lanes = real
    assert called and w.grad is not None


def test_loss_vmap_rule_matches_a_loop_over_lanes():
    rng = np.random.RandomState(1)
    out = torch.from_numpy(rng.randn(B, 1, 1, 12, 9).astype(np.float32)).requires_grad_()
    img = torch.from_numpy(rng.randn(B, 1, 1, 12, 9).astype(np.float32))
    mask = torch.from_numpy((rng.rand(B, 1, 1, 12, 9) > 0.5).astype(np.float32))

    def metrics(o, t, m):
        loss, mets = FL.fused_loss_metrics(o, t, m, loss="mse")
        return torch.stack([loss, mets["snr"], mets["pcorr"], mets["mae"]])
    got = vmap(metrics)(out, img, mask)
    g = torch.from_numpy(rng.randn(B, 4).astype(np.float32))
    grad = torch.autograd.grad(got, out, g)[0]
    for b in range(B):
        ob = out[b].detach().requires_grad_()
        want = metrics(ob, img[b], mask[b])
        torch.testing.assert_close(got[b], want.detach(), rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(grad[b], torch.autograd.grad(want, ob, g[b])[0],
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape", [(2, 4, 6), (2, 4, 6, 8)])
def test_upsample_vmap_rule_matches_a_loop_over_lanes(shape):
    x = torch.randn((B, 1) + shape, requires_grad=True)
    y = vmap(U.linear_upsample2x)(x)
    g = torch.randn_like(y)
    dx = torch.autograd.grad(y, x, g)[0]
    y1, (dx1,) = _per_lane_grads(U.linear_upsample2x, (x,), g)
    assert torch.equal(y, y1) and torch.equal(dx, dx1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lane_loss_sums_plain_match_per_lane_calls(dtype):
    rng = np.random.RandomState(2)
    out = torch.from_numpy(rng.randn(4, 1, 1, 10, 7).astype(np.float32)).to(dtype)
    img = torch.from_numpy(rng.randn(4, 1, 1, 10, 7).astype(np.float32))
    mask = torch.from_numpy((rng.rand(4, 1, 1, 10, 7) > 0.5).astype(np.float32))
    g = torch.from_numpy(rng.randn(4, 8).astype(np.float32))
    sums = FL.fused_sums_lanes(out, img, mask)
    grad = FL.loss_sums_grad_lanes(out, img, mask, g)
    for b in range(4):
        torch.testing.assert_close(sums[b], FL.fused_sums_plain(out[b], img[b], mask[b]),
                                   rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(grad[b], FL.loss_sums_grad_plain(out[b], img[b], mask[b],
                                                                    g[b]), rtol=0, atol=0)
    with pytest.raises(ValueError, match="\\(B, 8\\)"):
        FL.loss_sums_grad_lanes(out, img, mask, g[:2])


def test_lane_wgrad_plain_matches_per_lane_calls():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(3, 5, 4, 6, 8).astype(np.float32))
    dy = torch.from_numpy(rng.randn(3, 7, 4, 6, 8).astype(np.float32))
    got = WG.wgrad3d_lanes(x, dy, 3)
    assert got.shape == (3, 7, 5, 3, 3, 3)
    for b in range(3):
        torch.testing.assert_close(got[b], WG.wgrad3d_plain(x[b:b + 1], dy[b:b + 1], 3),
                                   rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="wgrad3d takes \\(1, C"):
        WG.wgrad3d(x, dy, 3)
    with pytest.raises(ValueError, match="wgrad3d_lanes takes"):
        WG.wgrad3d_lanes(x, dy[:2], 3)


def test_lane_wgrad_grids_cap_a_blocks_run_and_pin_by_lane_shape():
    """A lane launch's grids sum at most 2^15 positions a block; the
    one-lane planner is unchanged by the lane argument's default; a pinned
    lane grid is keyed by its lane shape and checked against the lane
    planner."""
    lanes = WG._plans(64, 4, 128, 64, 64, 3, True, 8)
    assert lanes and all(pl.hb * pl.w * pl.planes <= WG._LANE_RUN for pl in lanes)
    assert WG._plans(64, 4, 128, 64, 64, 3, True) == WG._plans(64, 4, 128, 64, 64, 3, True, 1)
    pl = lanes[0]
    entry = {"key": [[8, 64, 128, 64, 64], [8, 4, 128, 64, 64], 3, "bfloat16", "bfloat16",
                     True], "plan": pl.to_json()}
    saved = dict(WG._tuned)
    WG._tuned.clear()
    try:
        assert WG.pin_plans(json.loads(json.dumps([entry]))) == 1
        (key, (got, args)), = WG._tuned.items()
        assert key[0] == (8, 64, 128, 64, 64) and got == pl and list(args)[-1] == 8
        assert WG.tuned_plans() == [entry]
    finally:
        WG._tuned.clear()
        WG._tuned.update(saved)


def test_dropout_draws_each_lane_from_its_generator():
    """Under vmap lane i's mask is the draw an unbatched Dropout makes from
    generator i; outside vmap a list of generators raises."""
    drop = Dropout(0.3)
    x = torch.ones(B, 2, 5, 7)
    set_dropout_generator(drop, [torch.Generator().manual_seed(10 + i) for i in range(B)])
    got = vmap(drop)(x)
    for i in range(B):
        set_dropout_generator(drop, torch.Generator().manual_seed(10 + i))
        assert torch.equal(got[i], drop(x[i]))
    set_dropout_generator(drop, [torch.Generator()] * B)
    with pytest.raises(RuntimeError, match="only under torch.func.vmap"):
        drop(x)


def _lane_net(**kw):
    cfg = Config(datadim="3d", inputdepth=4, filters=[8, 16], skip=[4], gain=1.0,
                 upsample="linear", **kw)
    net = get_net(cfg, 1)
    init_weights(net, torch.Generator().manual_seed(0), cfg.inittype, cfg.initgain)
    names = [n for n, _ in net.named_parameters()]
    params = [torch.stack([p.detach() * (1 + 0.1 * i) for i in range(B)]).requires_grad_()
              for _, p in net.named_parameters()]
    return net, names, params


def _run_lanes(net, names, params, x, seed):
    set_dropout_generator(net, [torch.Generator().manual_seed(seed + i) for i in range(B)])
    out = vmap(lambda ps, xx: functional_call(net, dict(zip(names, ps)), (xx,)))(params, x)
    return out, torch.autograd.grad((out ** 2).sum(), params)


def _close_grads(names, got, want):
    """Gradients to rounding; biases that feed a Norm (gradients of rounding
    size) left out, as in the port's other gradient tests."""
    for n, a, b in zip(names, got, want):
        if not n.endswith("bias") and float(b.abs().max()) > 1e-5:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))


def test_remat_under_vmap_matches_the_plain_lanes():
    """A remat net (phase space, dropout) under vmap: the lanes' blocks are
    checkpointed as a whole; the output equals the net's without remat bit
    for bit (the recompute redraws the same dropout masks) and the
    gradients to rounding (the recompute's vmap batches the block's
    backward in another order; measured 2e-7 of each kernel's scale)."""
    x = torch.randn(B, 1, 4, 16, 8, 8, generator=torch.Generator().manual_seed(1))
    kw = dict(dropout=0.1, phase_space=True, phase_levels=1)
    net, names, params = _lane_net(**kw)
    plain = _run_lanes(net, names, params, x, 5)
    remat = _run_lanes(*_lane_net(remat=True, **kw), x, 5)
    assert torch.equal(plain[0], remat[0])
    _close_grads(names, remat[1], plain[1])


def test_vmapped_net_matches_each_lane_alone():
    """The vmapped net against each lane's own forward and gradients (float32;
    biases that feed a Norm have gradients of rounding size and are left
    out, as in the port's other gradient tests)."""
    net, names, params = _lane_net(dropout=0.1)
    x = torch.randn(B, 1, 4, 16, 8, 8, generator=torch.Generator().manual_seed(2))
    out, grads = _run_lanes(net, names, params, x, 7)
    for i in range(B):
        set_dropout_generator(net, torch.Generator().manual_seed(7 + i))
        pi = [p[i].detach().requires_grad_() for p in params]
        oi = functional_call(net, dict(zip(names, pi)), (x[i],))
        gi = torch.autograd.grad((oi ** 2).sum(), pi)
        torch.testing.assert_close(out[i], oi, rtol=1e-5, atol=1e-5)
        _close_grads(names, [g[i] for g in grads], gi)
