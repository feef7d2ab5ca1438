"""The port's bfloat16 convs on the CPU (ROADMAP D.11): oneDNN's bfloat16
stride-2 conv3d returns wrong values at some shapes, up to ~1e37 at (1, 16,
4, 8, 2), so ``conv_same`` computes a CPU bfloat16 conv (forward, dx and dW)
in float32 and rounds it once. Each is held to the float32 conv of the same
bfloat16 values, within one bfloat16 rounding of its result (2^-8 of each
value, plus 2^-8 of the result's max for the sums that cancel), over 20
calls; a bfloat16 solve at the flagship's depth, which reaches such a
stride-2 conv at its deepest levels, is finite and repeats bit for bit."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.ops.conv_vjp import conv_same

torch.set_num_threads(1)
ULP = 2.0 ** -8   # one bfloat16 rounding, relative
CALLS = 20


def within_one_rounding(got: torch.Tensor, ref: torch.Tensor) -> None:
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    lim = ULP * ref.abs() + ULP * float(ref.abs().max())
    err = (got.float() - ref).abs()
    assert bool((err <= lim).all()), f"max err {float(err.max()):.3e}"


@pytest.mark.parametrize("shape", [(1, 16, 4, 8, 2), (1, 212, 8, 8, 2)])
def test_a_stride_2_conv_is_its_float32_conv_rounded(shape):
    g = torch.Generator().manual_seed(shape[1])
    c = shape[1]
    for _ in range(CALLS):
        x = torch.randn(shape, generator=g).bfloat16().requires_grad_()
        w = (torch.randn((c, c, 3, 3, 3), generator=g) / (27 * c) ** 0.5).bfloat16()
        w.requires_grad_()
        y = conv_same(x, w, 2, 1)
        dy = torch.randn(y.shape, generator=g).bfloat16()
        dx, dw = torch.autograd.grad(y, (x, w), dy)
        xf, wf = x.detach().float().requires_grad_(), w.detach().float().requires_grad_()
        yf = F.conv3d(xf, wf, stride=2, padding=1)
        dxf, dwf = torch.autograd.grad(yf, (xf, wf), dy.float())
        for got, ref in ((y, yf), (dx, dxf), (dw, dwf)):
            within_one_rounding(got.detach(), ref.detach())


def test_a_bfloat16_solve_at_the_flagship_s_depth_is_finite_and_repeats():
    rng = np.random.RandomState(0)
    img = rng.randn(32, 64, 16, 1).astype(np.float32)
    mask = (rng.rand(1, 64, 1, 1) > 0.5).astype(np.float32).repeat(32, 0).repeat(16, 2)
    cfg = Config(datadim="3d", inputdepth=8, filters=[16, 32, 64, 128, 256],
                 skip=[16, 32, 64, 128], dtype="bfloat16", upsample="linear", epochs=2,
                 scan_chunk=2, gain=1.0)
    runs = [DIPSolver(cfg, device="cpu").solve(img, mask, seed=0) for _ in range(2)]
    for r in runs:
        assert np.all(np.isfinite(r.history.loss)) and np.all(np.isfinite(r.out_best))
    np.testing.assert_array_equal(runs[0].history.loss, runs[1].history.loss)
    np.testing.assert_array_equal(runs[0].out_best, runs[1].out_best)
