"""Phase space and the conv formulations on a CUDA card: the phase conv's
weight gradient from the wgrad kernel against the plain version (through
the weight selection back to the net's weight), the kernel's first launch
on a fresh thread (the TMA descriptors need a context current on it), every
candidate grid of
the 9 phase-flagship wgrad shapes against the plain version, a small phase
net's backward bit-equal from call to call, and tapmm and the packed and
folded weight gradients against cuDNN (whose backward autograd runs on a
thread of its own).

Imports only torch and the port, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda_phase.py -q

Every test skips without a CUDA card (the wgrad kernel has no CPU mode);
the CPU tests hold the same paths against the JAX package
(tests/test_torch_phase_*.py, tests/test_torch_conv_formulations.py)."""
import pytest
import torch

from deep_prior_interpolation_tpu_torch.models import MulResUnet, init_weights
from deep_prior_interpolation_tpu_torch.ops import conv_vjp as cv
from deep_prior_interpolation_tpu_torch.ops import phase_space as ps
from deep_prior_interpolation_tpu_torch.ops import wgrad as WG

torch.set_num_threads(1)

_A, _B = (128, 64, 64), (64, 32, 32)
PHASE_SHAPES = [(536, 32, _A), (200, 128, _A), (200, 8, _A), (64, 104, _A), (32, 64, _A),
                (1096, 64, _B), (408, 256, _B), (136, 208, _B), (64, 136, _B)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the wgrad kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def float32_exact():
    """float32 means float32: no TF32 in cuDNN or matmul while a test runs."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _randn(dev, shape, seed, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def _tol(ref):
    """The same float32 products summed in other orders."""
    return dict(rtol=1e-4, atol=1e-4 * float(ref.abs().max()))


def test_phase_conv_weight_gradient_comes_from_the_kernel(cuda, monkeypatch):
    monkeypatch.setenv("DPI_PALLAS_WGRAD", "1")
    x = ps.space_to_depth(_randn(cuda, (1, 6, 32, 16, 16), 0, torch.bfloat16))
    w = (0.2 * _randn(cuda, (5, 6, 3, 3, 3), 1)).requires_grad_(True)
    before = WG.wgrad3d.launches
    y = ps.phase_conv(x, w.to(torch.bfloat16))
    dy = _randn(cuda, y.shape, 2, torch.bfloat16)
    (gw,) = torch.autograd.grad(y, w, dy)
    torch.cuda.synchronize()
    assert WG.wgrad3d.launches == before + 1
    # the plain version's dW' of the phase conv, carried back through the
    # selection as the kernel's is
    dwp = WG.wgrad3d_plain(x, dy, 3).to(torch.bfloat16)
    wb = w.detach().to(torch.bfloat16).requires_grad_(True)
    (ref,) = torch.autograd.grad(ps.phase_kernel(wb, 1), wb, dwp)
    torch.testing.assert_close(gw, ref.float(), rtol=2 ** -7, atol=2 ** -7 * float(ref.abs().max()))


def test_a_fresh_threads_first_cuda_call_launches(cuda):
    """The kernel's first CUDA call on a new thread (as on autograd's device
    thread when the backward's first node is a conv) makes its tensor maps
    and launches: the same sums as a launch on this thread."""
    import threading
    x = _randn(cuda, (1, 48, 16, 8, 8), 10, torch.bfloat16)
    dy = _randn(cuda, (1, 40, 16, 8, 8), 11, torch.bfloat16)
    pl = WG._plans(48, 40, 16, 8, 8, 3, True)[0]
    assert int(WG._args(pl, True)[1]) == 1   # the TMA path
    got, errors = [], []

    def first_call():
        try:
            got.append(WG._launch(pl, x, dy))
            torch.cuda.synchronize()
        except RuntimeError as e:
            errors.append(e)
    t = threading.Thread(target=first_call)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and not errors, errors
    assert torch.equal(got[0], WG._launch(pl, x, dy))


@pytest.mark.parametrize("ci,co,sp", PHASE_SHAPES)
def test_every_grid_of_the_phase_shapes_matches_plain(cuda, ci, co, sp):
    x = _randn(cuda, (1, ci) + sp, 3, torch.bfloat16)
    dy = _randn(cuda, (1, co) + sp, 4, torch.bfloat16)
    ref = WG.wgrad3d_plain(x, dy, 3)
    torch.testing.assert_close(WG.wgrad3d(x, dy, 3), ref, **_tol(ref))
    for pl in WG._plans(ci, co, *sp, 3, True):
        torch.testing.assert_close(WG._launch(pl, x, dy), ref, **_tol(ref))


def test_a_phase_nets_backward_is_bit_equal_from_call_to_call(cuda, monkeypatch):
    monkeypatch.setenv("DPI_PALLAS_WGRAD", "1")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    net = MulResUnet(4, 1, 3, (8, 16, 32), (4, 8), upsample_mode="trilinear",
                     dtype=torch.bfloat16, phase_space=True, phase_levels=2)
    init_weights(net, torch.Generator().manual_seed(0))
    net = net.to(cuda)
    x = _randn(cuda, (1, 4, 32, 32, 32), 5)
    grads = []
    for _ in range(2):
        net.zero_grad()
        (net(x).float() ** 2).mean().backward()
        grads.append([p.grad.clone() for p in net.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.parametrize("stride,pads", [(1, ((1, 1),) * 3), (2, ((1, 1),) * 3),
                                         (1, ((1, 0),) * 3)])
def test_tapmm_matches_cudnn(cuda, float32_exact, stride, pads):
    x = _randn(cuda, (1, 6, 16, 12, 12), 6).requires_grad_(True)
    w = (0.2 * _randn(cuda, (5, 6, 3, 3, 3), 7)).requires_grad_(True)
    out = {}
    for mode in ("conv", "tapmm"):
        with cv.conv_impl(mode):
            y = cv.conv_same(x, w, stride, pads)
        out[mode] = (y,) + torch.autograd.grad((y ** 2).sum(), (x, w))
    for got, ref in zip(out["tapmm"], out["conv"]):
        ref = ref.detach()
        torch.testing.assert_close(got.detach(), ref, rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("k,stride", [(3, 1), (4, 2)])
def test_packed_and_folded_weight_gradients_match_cudnn(cuda, float32_exact, k, stride):
    x = _randn(cuda, (1, 8, 32, 16, 16), 8)
    w_shape = (6, 8, k, k, k)
    pads = ((1, 1),) * 3
    out_sp = [(s + 2 - k) // stride + 1 for s in x.shape[2:]]
    dy = _randn(cuda, [1, 6] + out_sp, 9)
    ref = torch.nn.grad.conv3d_weight(x, w_shape, dy, stride=stride, padding=1)
    f = cv._packed_wgrad if stride == 1 else cv._folded_wgrad
    got = f(x, dy, w_shape, stride, pads)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))
