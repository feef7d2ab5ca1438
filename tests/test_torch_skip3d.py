"""The 3D Deep-Image-Prior skip net of the port (``models/skip.py``
``SkipNet``, through ``get_net`` with ``net="skip"``) against the
benchmark's plain reference (``benchmark/reference/skipnet.py``) on the CPU,
at a small size (inputdepth 4, filters [8, 8, 8], skip [2, 2, 2], a
(16, 16, 16) volume), on weights drawn by ``benchmark.traffic.weights``: the
parameter names, the output, every parameter's gradient and the first
step's loss through ``DIPSolver``. Then the Norms that apply their
activation (``Norm.forward(h, act)``) against ``act(norm(h))``, the step's
counters of Norm and weight-gradient routes on its spans, and the gate
that takes every weight gradient ``wgrad_roofline_pct`` counts, of the skip
net and of the 3D MulResUnet, to the wgrad kernel.

Tolerances, all float32 against float32: the two sides sum in other orders
(the port's Norm takes one-pass statistics, the reference two passes; the
convs and the upsample are other algorithms), so they part by rounding,
which the net's 18 Norms amplify. The output within 1e-5 of its largest
value (measured 1.2e-6). A gradient within 2e-3 of the larger of its own
norm and the median parameter's (measured 2.2e-4, in a conv bias under a
Norm, whose exact gradient is nought): float32 itself lies 2e-2 from
float64 on this net (the skip branch's kernel), so the gradients are held
within float32 and not against float64. The first loss within 1e-5
relative. Pure Python: no JAX."""
import numpy as np
import pytest
import torch

from benchmark import counts, traffic
from benchmark.reference import steps as ref_steps
from benchmark.reference.mulresunet import MulResUnet as PlainMulResUnet
from benchmark.reference.skipnet import SkipNet as PlainSkip
from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.models import get_net
from deep_prior_interpolation_tpu_torch.models.blocks import Norm, get_activation
from deep_prior_interpolation_tpu_torch.ops import conv_vjp
from deep_prior_interpolation_tpu_torch.ops import norm_act as NA
from deep_prior_interpolation_tpu_torch.utils import spans
from test_torch_norm_act import stand_in_for_the_card

torch.set_num_threads(1)
SHAPE = (16, 16, 16)
FILTERS, SKIP = [8, 8, 8], [2, 2, 2]


def _cfg(**kw):
    base = dict(datadim="3d", net="skip", inputdepth=4, filters=FILTERS, skip=SKIP,
                upsample="linear", dtype="float32", epochs=1, scan_chunk=1, gain=1.0)
    return Config(**{**base, **kw})


def _pair(seed=2 ** 33 + 1, **kw):
    """The port's net and the reference, one dict of weights loaded in both."""
    cfg = _cfg(**kw)
    port = get_net(cfg)
    ref = PlainSkip(cfg.inputdepth, 1, 3, cfg.filters, cfg.skip, upsample=cfg.upsample)
    flat = traffic.weights(ref.spec(), 1, seed, 0.02, "cpu")
    (params,) = traffic.state_dicts(ref.spec(), flat)
    port.load_state_dict(params)
    return port, ref, params


def _input(seed=3, c=4):
    return torch.randn((1, c) + SHAPE, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("skip", [[2, 2, 2], [2], [0, 2, 3]])
def test_parameter_names_are_the_reference_spec(skip):
    """Name for name, shape for shape and in the port's order, with a skip
    list shorter than the filters padded by its last width, and a level
    without a skip branch."""
    port, ref, _ = _pair(skip=skip)
    assert [(n, tuple(s)) for n, s, _ in ref.spec()] == \
        [(n, tuple(t.shape)) for n, t in port.state_dict().items()]


def test_the_output_is_the_reference_output():
    port, ref, params = _pair()
    x = _input()
    with torch.no_grad():
        out_p, out_r = port(x), ref(params, x)
    assert out_p.shape == out_r.shape == (1, 1) + SHAPE
    assert float((out_p - out_r).abs().max()) <= 1e-5 * float(out_r.abs().max())


def test_every_gradient_is_the_reference_gradient():
    port, ref, params = _pair()
    x, target = _input(), _input(4, 1)
    p = {n: t.clone().requires_grad_(True) for n, t in params.items()}
    g_r = torch.autograd.grad((ref(p, x) - target).abs().mean(), list(p.values()))
    g_p = dict(zip([n for n, _ in port.named_parameters()],
                   torch.autograd.grad((port(x) - target).abs().mean(),
                                       list(port.parameters()))))
    assert set(g_p) == set(p)
    med = float(np.median([float(g.norm()) for g in g_r]))
    for n, g in zip(p, g_r):
        assert float((g_p[n] - g).norm()) <= 2e-3 * max(float(g.norm()), med), n


def test_the_first_loss_through_the_solver():
    """``DIPSolver.solve`` from the same weights, data, mask and seed: its
    first loss is the reference's first step's (the canvas and the step's
    noise drawn from the solve's seed on both sides)."""
    cfg = _cfg()
    _, ref, params = _pair()
    rng = np.random.RandomState(0)
    img = rng.randn(*SHAPE, 1).astype(np.float32)
    mask = np.repeat((rng.rand(1, *SHAPE[1:], 1) > 0.4).astype(np.float32), SHAPE[0], 0)
    res = DIPSolver(cfg, 1, device=torch.device("cpu")).solve(img, mask, seed=5,
                                                              init_params=params)

    def chan_first(a):
        return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 0)[None]))
    want = ref_steps.first_steps(ref, params, chan_first(img), chan_first(mask), 5, SHAPE,
                                 dtype=torch.float32, noise_std=cfg.noise_std,
                                 reg_noise_std=cfg.reg_noise_std, lr=cfg.lr, loss=cfg.loss,
                                 n_steps=1)["losses"][0]
    assert abs(res.history.loss[0] - want) <= 1e-5 * abs(want)


def _unfused(monkeypatch):
    """``Norm.forward(h, act)`` as ``act(norm(h))``: the route before the
    activation moved into the Norm."""
    forward = Norm.forward
    monkeypatch.setattr(Norm, "forward",
                        lambda self, x, act=None: get_activation(act)(forward(self, x)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_norms_apply_their_activation_bit_for_bit(monkeypatch, dtype):
    """On the CPU a Norm that applies its LeakyReLU gives ``act(norm(h))``
    bit for bit, forward and backward, through the whole net."""
    port, _, _ = _pair()
    x = _input().to(dtype)
    outs = []
    for patch in (False, True):
        if patch:
            _unfused(monkeypatch)
        out = port(x)
        grads = torch.autograd.grad(out.float().square().sum(), list(port.parameters()))
        outs.append((out, grads))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


@pytest.mark.parametrize("card, kernel_wgrad", [(False, False), (True, True)])
def test_the_step_counts_its_routes(monkeypatch, card, kernel_wgrad):
    """One step: ``step.forward`` counts the 18 Norms (6 a level) by route
    and the 15 with LeakyReLU after them as fused on the kernel route;
    ``step.backward`` the 6 stride-1 3x3x3 convs' dW (2 a level) on the
    wgrad kernel with ``DPI_PALLAS_WGRAD=1`` (its plain version on the CPU)
    and in the library without."""
    if card:
        stand_in_for_the_card(monkeypatch)
    monkeypatch.setenv("DPI_PALLAS_WGRAD", "1" if kernel_wgrad else "0")
    solver = DIPSolver(_cfg(), 1, device=torch.device("cpu"))
    rng = np.random.RandomState(1)
    img = rng.randn(*SHAPE, 1).astype(np.float32)
    n0, w0 = dict(NA.routes), dict(conv_vjp.wgrad_routes)
    spans.enable()
    try:
        solver.solve(img, np.ones_like(img), seed=2)
    finally:
        spans.disable()
    recs = spans.drain()
    (fwd,) = [r.attrs for r in recs if r.name == "step.forward"]
    (bwd,) = [r.attrs for r in recs if r.name == "step.backward"]
    assert fwd == {"norm_kernel": 18 if card else 0, "norm_plain": 0 if card else 18,
                   "norm_act_fused": 15 if card else 0}
    assert bwd == {"wgrad_kernel": 6 if kernel_wgrad else 0,
                   "wgrad_library": 0 if kernel_wgrad else 6}
    # the solve's meta-device shape pass adds its Norms to the route counts
    # too, but no weight gradient
    assert NA.routes["fused"] - n0.get("fused", 0) == (15 if card else 0)
    assert sum(conv_vjp.wgrad_routes.values()) - sum(w0.values()) == 6


@pytest.mark.parametrize("net", ["skip", "mulresunet"])
def test_every_counted_wgrad_takes_the_kernel(monkeypatch, net):
    """Every conv that ``wgrad_roofline_pct`` counts at the (256, 128, 128)
    patch goes to the wgrad kernel with ``DPI_PALLAS_WGRAD=1``, so the
    roofline reads one launch a counted conv: the skip
    net's 10 (the up convs 132 -> 128 at levels 0-4, the convs 128 -> 128 at
    levels 1-5) and the 3D MulResUnet's 32."""
    monkeypatch.setenv("DPI_PALLAS_WGRAD", "1")
    if net == "skip":
        ref, n = PlainSkip(32, 1, 3, [128] * 5, [4] * 5, upsample="linear"), 10
    else:
        ref, n = PlainMulResUnet(64, 1, 3, (16, 32, 64, 128, 256), (16, 32, 64, 128),
                                 upsample="linear"), 32
    convs = counts.wgrad_convs(counts.layers(ref, (256, 128, 128)))
    assert len(convs) == n
    for c in convs:
        side = round((c["vin"] / 2) ** (1 / 3))
        sp = (2 * side, side, side)
        assert sp[0] * sp[1] * sp[2] == c["vin"]
        assert conv_vjp.use_wgrad_kernel((1, c["cin"]) + sp, (c["cout"], c["cin"], 3, 3, 3),
                                         1, 1), c
