"""The operations and bytes the kernel metrics divide by, against
``torch.utils.flop_counter`` and against the sizes of the arrays."""
from __future__ import annotations

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts, peaks
from benchmark.reference.mulresunet import MulResUnet

NETS = [(3, "trilinear", (16, 16, 16)), (2, "nearest", (40, 24))]


def _net(ndim, up):
    return MulResUnet(4, 1, ndim, (4, 8, 16, 32, 64), (4, 8, 16, 32), upsample=up)


@pytest.mark.parametrize("ndim, up, shape", NETS)
def test_step_flops_are_the_convs(ndim, up, shape):
    """flop_counter's count of a step is, conv by conv, its forward, its
    weight gradient and its data gradient, 2 k^d Ci Co V_out each, but for
    the data gradients of the two convs that read the canvas (the first
    block's first conv and its shortcut)."""
    net = _net(ndim, up)
    lay = counts.layers(net, shape)
    per = [2 * c["k"] ** c["ndim"] * c["cin"] * c["cout"] * c["vout"] for c in lay["convs"]]
    assert counts.step_flops(net, shape, shape) == 3 * sum(per) - per[0] - per[3]


def test_wgrad_against_flop_counter_and_sizes():
    x = torch.randn(1, 6, 8, 10, 12)
    w = torch.randn(5, 6, 3, 3, 3, requires_grad=True)
    y = torch.nn.functional.conv3d(x, w, padding=1)
    with FlopCounterMode(display=False) as fc:
        torch.autograd.grad(y.sum(), w)
    lay = {"convs": [{"cin": 6, "cout": 5, "k": 3, "stride": 1, "vin": 960, "vout": 960,
                      "ndim": 3}]}
    flops, n_bytes = counts.wgrad(lay, 2)
    assert flops == fc.get_total_flops()
    assert n_bytes == 2 * (x.numel() + y.numel() + w.numel())


def test_upsample_and_loss_bytes_are_array_sizes():
    net = _net(3, "trilinear")
    seen = []
    up = net.upsample
    net.upsample = lambda x: seen.append(x) or up(x)
    params = {n: torch.randn(s) for n, s, _ in net.spec()}
    with torch.no_grad():
        out = net(params, torch.randn(1, 4, 16, 16, 16))
    del net.upsample
    lay = counts.layers(net, (16, 16, 16))
    assert counts.upsample_bwd(lay, 2)[1] == sum(2 * 9 * t.numel() for t in seen)
    n = out.numel()
    assert counts.fused_loss(n, 2) == (0.0, n * (2 + 4 + 4) + 64 + n * 2)


def test_bound_is_the_larger_time():
    assert peaks.bound_s(989e12, 0, "bf16") == pytest.approx(1.0)
    assert peaks.bound_s(1.0, 3.35e12, "bf16") == pytest.approx(1.0)
    assert math.isclose(peaks.bound_s(67e12, 0, "fp32"), 1.0)


def test_wgrad_counts_the_convs_of_the_port_kernel():
    """The strided and 1x1x1 convs' weight gradients run in the library: the
    work that ``wgrad_roofline_pct`` divides by leaves them out."""
    conv = dict(cin=4, cout=4, vin=512, vout=512, ndim=3)
    lay = {"convs": [dict(conv, k=3, stride=1), dict(conv, k=1, stride=1),
                     dict(conv, k=3, stride=2, vout=64), dict(conv, k=3, stride=1, ndim=2)]}
    assert counts.wgrad_convs(lay) == lay["convs"][:1]
    assert counts.wgrad(lay, 2) == counts.wgrad({"convs": lay["convs"][:1]}, 2)


@pytest.mark.parametrize("launches, silent", [(32, False), (31, True)])
def test_wgrad_share_is_silent_when_a_counted_conv_ran_elsewhere(launches, silent):
    from types import SimpleNamespace
    from benchmark.metrics import wgrad_roofline_pct as m
    steps = 2
    names = ["void (anonymous namespace)::wgrad3d_mma<3, 2, 8>(...)"] * (launches * steps)
    names += ["(anonymous namespace)::wgrad3d_sum(...)", "sm90_xmma_wgrad_indexed_x"]
    trace = SimpleNamespace(kernels=[(n, 1e-4) for n in names])
    rec = SimpleNamespace(trace=trace, steps_traced=steps, lanes=1, peak="bf16",
                          counts={"wgrad": (1e9, 1e6), "wgrad_convs": 32})
    v = m.read(rec)
    if silent:
        assert v is None
    else:
        t = (launches * steps + 1) * 1e-4
        assert v == pytest.approx(100 * peaks.bound_s(2e9, 2e6, "bf16") / t)
