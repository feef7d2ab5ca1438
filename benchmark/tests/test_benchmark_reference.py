"""The reference against the port on the CPU at a tiny size: the same
weights (drawn by the benchmark) and the same input give the same net
output and the same gradients, in float32."""
from __future__ import annotations

import math

import pytest
import torch

from benchmark import traffic
from benchmark.reference.mulresunet import MulResUnet
from benchmark.reference.steps import crop

FILTERS, SKIP = (4, 8, 16, 32, 64), (4, 8, 16, 32)


@pytest.mark.parametrize("datadim, up, shape", [("3d", "linear", (16, 16, 16)),
                                                ("2d", "nearest", (48, 32))])
def test_net_and_gradients_match_the_port(datadim, up, shape):
    from deep_prior_interpolation_tpu_torch.config import Config
    from deep_prior_interpolation_tpu_torch.models import get_net
    cfg = Config(datadim=datadim, upsample=up, filters=list(FILTERS), skip=list(SKIP),
                 inputdepth=4, dtype="float32")
    port = get_net(cfg)
    ref = MulResUnet(4, 1, len(shape), FILTERS, SKIP, upsample=cfg.upsample)
    flat = traffic.weights(ref.spec(), 1, 2 ** 33 + 1, 0.02, "cpu")
    (params,) = traffic.state_dicts(ref.spec(), flat)
    port.load_state_dict(params)
    x = torch.randn((1, 4) + shape, generator=torch.Generator().manual_seed(3))
    target = torch.randn((1, 1) + shape, generator=torch.Generator().manual_seed(4))
    out_p = port(x)
    with torch.no_grad():
        assert float((out_p - ref(params, x)).abs().max()) <= 1e-5 * float(out_p.abs().max())
    # the gradients against the reference in float64, where a conv bias under
    # a Norm has the gradient it has in exact arithmetic: none
    p = {n: t.double().requires_grad_(True) for n, t in params.items()}
    out_r = ref(p, x.double())
    g_p = torch.autograd.grad((crop(out_p, shape) - target).abs().mean(),
                              list(port.parameters()))
    g_r = torch.autograd.grad((crop(out_r, shape) - target.double()).abs().mean(),
                              list(p.values()))
    named = dict(zip([n for n, _ in port.named_parameters()], g_p))
    med = sorted(float(g.norm()) for g in g_r)[len(g_r) // 2]
    for (n, g), gp in zip(zip(p, g_r), (named[n] for n in p)):
        if float(g.norm()) < 1e-3 * med:
            continue
        assert float((gp.double() - g).norm()) <= 1e-3 * max(float(g.norm()), med), n


def test_weights_follow_the_init_the_config_states():
    ref = MulResUnet(4, 1, 3, FILTERS, SKIP, upsample="trilinear")
    flat = traffic.weights(ref.spec(), 2, 7, 0.02, "cpu")
    assert flat.shape == (2, sum(math.prod(s) for _, s, _ in ref.spec()))
    (a, b) = traffic.state_dicts(ref.spec(), flat)
    assert not torch.equal(a["Conv_0.kernel"], b["Conv_0.kernel"])
    scale = a["MultiResBlock_0.ConvNormAct_0.Norm_0.scale"]
    assert float((scale - 10).abs().max()) < 2 and float(a["Conv_0.bias"].abs().max()) == 0
    assert torch.equal(flat, traffic.weights(ref.spec(), 2, 7, 0.02, "cpu"))

