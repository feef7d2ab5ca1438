"""The 3D Deep-Image-Prior skip net at its published widths on a CUDA card
(every test skips without one): inputdepth 32, filters [128] * 5, skip
[4] * 5, with ``DPI_PALLAS_WGRAD=1``, against the benchmark's plain float32
reference (``benchmark/reference/skipnet.py``, TF32 off) on weights drawn
by ``benchmark.traffic.weights``, with the route of each Norm; and the
wgrad kernel's dW of the net's widest stride-1 conv, 128 -> 128, against
``wgrad3d_plain``.

The patches and tolerances. float32 on a (64, 32, 32) patch: both sides
sum in float32 in other orders, output within 1e-4 of the reference's norm
(measured 4.0e-6 on an H100) and the parameters' first gradients by the
benchmark's ``grad_gap_median`` within 2e-3 (measured 3.9e-4). bf16 on a
(128, 64, 64) patch: at (64, 32, 32) the deepest Norm normalises 2 voxels
to +-1, and bf16's rounding flips which is which in some channels (the
output then parts by 52 %, measured), so the bf16 step takes the patch at
which that Norm spans 16 voxels: the output within 0.15 of the reference's
norm (measured 5.2 %), the step's loss within 3e-4, twice the
``skip3d.solo256`` cell's worst sound ``loss0_gap`` (measured 9e-7), and
``grad_gap_median`` within 0.03 (measured 8.6e-3; the cell at its full
patch holds 0.013). The
kernel's dW through ``conv_same`` (float32 sums rounded once to bf16)
against the plain version's float32 sums: one bf16 rounding (2^-8 of the
value) plus 1e-3 of the largest |dW| for the other order of 2^15- to
2^18-term sums.

Imports only torch, the port and the benchmark's reference, so it runs
where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda_skip3d.py -q
"""
import statistics

import pytest
import torch

from benchmark import traffic
from benchmark.reference.skipnet import SkipNet as PlainSkip
from benchmark.reference.steps import no_tf32
from deep_prior_interpolation_tpu_torch import Config
from deep_prior_interpolation_tpu_torch.models import get_net
from deep_prior_interpolation_tpu_torch.ops import conv_vjp
from deep_prior_interpolation_tpu_torch.ops import norm_act as NA
from deep_prior_interpolation_tpu_torch.ops import wgrad as WG

@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    monkeypatch.setenv("DPI_PALLAS_WGRAD", "1")
    return torch.device("cuda")


def _published(dev, dtype, patch):
    cfg = Config(datadim="3d", net="skip", inputdepth=32, filters=[128] * 5, skip=[4] * 5,
                 upsample="linear", dtype=dtype)
    port = get_net(cfg).to(dev)
    ref = PlainSkip(32, 1, 3, cfg.filters, cfg.skip, upsample="linear")
    flat = traffic.weights(ref.spec(), 1, 2 ** 31 + 23, 0.02, dev)
    (params,) = traffic.state_dicts(ref.spec(), flat)
    params = {n: t.to(dev) for n, t in params.items()}
    port.load_state_dict(params)
    g = torch.Generator(device=dev).manual_seed(7)
    x = 0.1 * torch.randn((1, 32) + patch, generator=g, device=dev)
    target = 40 * torch.randn((1, 1) + patch, generator=g, device=dev)
    return port, ref, params, x.to(getattr(torch, dtype)), target


# dtype, patch, output / loss / grad_gap_median tolerances (module docstring)
CASES = [("float32", (64, 32, 32), 1e-4, 1e-6, 2e-3),
         ("bfloat16", (128, 64, 64), 0.15, 3e-4, 0.03)]


@pytest.mark.parametrize("dtype, patch, out_tol, loss_tol, grad_tol", CASES)
def test_the_step_against_the_float32_reference(cuda, dtype, patch, out_tol, loss_tol,
                                                grad_tol):
    port, ref, params, x, target = _published(cuda, dtype, patch)
    before = dict(NA.routes)
    with no_tf32():
        out_p = port(x)
        assert out_p.dtype == x.dtype
        assert NA.routes["kernel"] - before.get("kernel", 0) == 30
        assert NA.routes["fused"] - before.get("fused", 0) == 25
        loss_p = (out_p.float() - target).abs().mean()
        g_p = dict(zip([n for n, _ in port.named_parameters()],
                       torch.autograd.grad(loss_p, list(port.parameters()))))
        p = {n: t.clone().requires_grad_(True) for n, t in params.items()}
        out_r = ref(p, x.float())
        loss_r = (out_r - target).abs().mean()
        g_r = torch.autograd.grad(loss_r, list(p.values()))
    err = float((out_p.detach().float() - out_r.detach()).norm() / out_r.detach().norm())
    assert err <= out_tol, err
    loss_p, loss_r = float(loss_p.detach()), float(loss_r.detach())
    assert abs(loss_p - loss_r) <= loss_tol * loss_r
    norms = {n: float(g.norm()) for n, g in zip(p, g_r)}
    med = statistics.median(norms.values())
    counted = [n for n in p if norms[n] >= 1e-3 * med]   # not a bias under a Norm
    gaps = [abs(float(g_p[n].norm()) - norms[n]) / max(norms[n], med) for n in counted]
    assert statistics.median(gaps) <= grad_tol, statistics.median(gaps)


@pytest.mark.parametrize("sp", [(128, 64, 64), (64, 32, 32)])
def test_a_128_channel_wgrad_on_the_kernel_against_the_plain_version(cuda, sp):
    """128 -> 128 at 2^18 and 2^15 voxels: the gate takes the dW to the
    kernel, counted on ``wgrad_routes`` as the kernel's."""
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn((1, 128) + sp, generator=g, device=cuda).bfloat16()
    w = (0.05 * torch.randn((128, 128, 3, 3, 3), generator=g, device=cuda)).bfloat16()
    dy = torch.randn((1, 128) + sp, generator=g, device=cuda).bfloat16()
    assert conv_vjp.use_wgrad_kernel(tuple(x.shape), tuple(w.shape), 1, 1)
    w.requires_grad_(True)
    before = dict(conv_vjp.wgrad_routes)
    y = conv_vjp.conv_same(x, w, 1, 1)
    (dw,) = torch.autograd.grad(y, [w], dy)
    assert conv_vjp.wgrad_routes["kernel"] - before.get("kernel", 0) == 1
    assert conv_vjp.wgrad_routes["library"] == before.get("library", 0)
    ref = WG.wgrad3d_plain(x, dy, 3)
    tol = 2.0 ** -8 * ref.abs() + 1e-3 * float(ref.abs().max())
    assert bool(((dw.float() - ref).abs() <= tol).all())
