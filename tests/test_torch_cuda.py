"""The port's hand-written kernels against their plain versions on a CUDA card.

Imports only torch and the port, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Every test skips without a CUDA card (a CUDA kernel has no CPU mode); the
CPU tests of the port compare the plain versions with the JAX package
instead."""
import pytest
import torch

from deep_prior_interpolation_tpu_torch.ops import fused_loss as FL
from deep_prior_interpolation_tpu_torch.ops import wgrad as WG

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _loss_inputs(dev, n, out_dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    out = torch.randn(n, generator=g, device=dev).to(out_dtype)
    img = torch.randn(n, generator=g, device=dev)
    mask = (torch.rand(n, generator=g, device=dev) > 0.5).float()
    return out, img, mask


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_fused_sums_kernel_matches_plain(cuda, out_dtype):
    # a ragged n (no multiple of 8 voxels or of a block) on 16-byte aligned
    # bases, then on bases one element past them: the scalar path
    n = 64 * 64 * 33 + 5
    out, img, mask = _loss_inputs(cuda, n + 1, out_dtype, 5)
    for off in (0, 1):
        o, t, m = (v[off:off + n] for v in (out, img, mask))
        before = FL.fused_sums.launches
        got = FL.fused_sums(o, t, m)
        assert FL.fused_sums.launches == before + 1
        # float32 sums of 135 k terms in another order
        torch.testing.assert_close(got, FL.fused_sums_plain(o, t, m), rtol=1e-5, atol=1e-3)
        # one launch and no float atomics: repeated calls are bit-identical
        for _ in range(3):
            assert torch.equal(FL.fused_sums(o, t, m), got)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_loss_sums_grad_kernel_matches_plain(cuda, out_dtype):
    n = 64 * 64 * 33 + 5
    out, img, mask = _loss_inputs(cuda, n + 1, out_dtype, 7)
    g = torch.randn(8, generator=torch.Generator(device=cuda).manual_seed(8), device=cuda)
    for off in (0, 1):
        o, t, m = (v[off:off + n] for v in (out, img, mask))
        before = FL.loss_sums_grad.launches
        got = FL.loss_sums_grad(o, t, m, g)
        assert FL.loss_sums_grad.launches == before + 1
        assert got.dtype == out_dtype and got.shape == o.shape
        ref = FL.loss_sums_grad_plain(o, t, m, g).float()
        # the same float32 formula: within one bf16 ulp of the plain value
        # for bf16, 1e-5 of the largest value for float32
        err = (got.float() - ref).abs()
        if out_dtype == torch.bfloat16:
            assert bool((err <= 2.0 ** -7 * ref.abs()).all())
        else:
            assert float(err.max()) <= 1e-5 * float(ref.abs().max())


def test_fused_loss_gradient_on_cuda(cuda):
    g = torch.Generator(device=cuda).manual_seed(6)
    out = torch.randn((1, 1, 16, 16, 16), generator=g, device=cuda).requires_grad_(True)
    img = torch.randn(out.shape, generator=g, device=cuda)
    mask = (torch.rand(out.shape, generator=g, device=cuda) > 0.5).float()
    before = FL.loss_sums_grad.launches
    FL.fused_loss_metrics(out, img, mask, "mse")[0].backward()
    assert FL.loss_sums_grad.launches == before + 1
    ref = 2.0 * (out.detach() - img) * mask * mask / out.numel()
    torch.testing.assert_close(out.grad, ref, rtol=1e-5, atol=1e-9)


def test_wrappers_refuse_bad_inputs(cuda):
    out, img, mask = _loss_inputs(cuda, 64, torch.float32, 9)
    g = torch.ones(8, device=cuda)
    with pytest.raises(TypeError):
        FL.fused_sums(out.half(), img, mask)
    with pytest.raises(TypeError):
        FL.fused_sums(out, img.to(torch.bfloat16), mask)
    with pytest.raises(ValueError):
        FL.fused_sums(out, img.cpu(), mask)
    with pytest.raises(ValueError):
        FL.fused_sums(out, img[:32], mask)
    with pytest.raises(ValueError):
        FL.loss_sums_grad(out, img, mask, g.cpu())
    with pytest.raises(ValueError):
        FL.loss_sums_grad(out, img, mask, g.double())
    with pytest.raises(ValueError):
        FL.loss_sums_grad(out, img, mask, g[:7])
    x = torch.randn(1, 2, 4, 4, 4, device=cuda)
    with pytest.raises(TypeError):
        WG.wgrad3d(x, x.to(torch.bfloat16), 3)
    with pytest.raises(ValueError):
        WG.wgrad3d(x, x.cpu(), 3)
    with pytest.raises(ValueError):
        WG.wgrad3d(x.to(torch.bfloat16), x.to(torch.bfloat16), 9)


@pytest.mark.parametrize("ci,co,sp,k,dtype", [
    (5, 3, (6, 8, 16), 3, torch.float32),
    (3, 2, (5, 9, 300), 3, torch.float32),       # W > the thread block
    (67, 4, (16, 32, 32), 3, torch.bfloat16),    # co tile 8, 5 ci tiles
    (25, 16, (9, 7, 130), 3, torch.bfloat16),    # W over 3 segments, odd sizes
    (8, 13, (4, 5, 6), 3, torch.bfloat16),       # W below one segment
    (9, 5, (5, 6, 72), 3, torch.bfloat16),       # 16-byte staging, a tail segment
    (7, 3, (4, 5, 24), 5, torch.bfloat16),       # 16-byte staging, W < one segment
    (554, 35, (8, 4, 4), 3, torch.bfloat16),     # co tile 32, 2 co tiles
    (6, 3, (7, 6, 20), 5, torch.bfloat16),
    (4, 2, (9, 8, 11), 7, torch.bfloat16),
])
def test_wgrad_kernel_matches_plain(cuda, ci, co, sp, k, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((1, ci) + sp, generator=g, device=cuda).to(dtype)
    dy = torch.randn((1, co) + sp, generator=g, device=cuda).to(dtype)
    before = WG.wgrad3d.launches
    got = WG.wgrad3d(x, dy, k)
    torch.cuda.synchronize()
    assert WG.wgrad3d.launches == before + 1
    ref = WG.wgrad3d_plain(x, dy, k)
    # the same float32 products (bf16 products are exact in float32) summed
    # in other orders
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))


def test_pocs_solve_and_resume_on_cuda(cuda, tmp_path, monkeypatch):
    # a tiny 3D DIP+POCS solve with both kernels: against the CPU's plain
    # versions for 3 iterations (Adam blows ulp-level differences up after
    # that), then cut after chunk 1 and resumed, against the straight run
    import numpy as np
    from deep_prior_interpolation_tpu_torch import Config, DIPSolver
    from deep_prior_interpolation_tpu_torch.data import flagship_problem
    from deep_prior_interpolation_tpu_torch.models import init_weights

    from deep_prior_interpolation_tpu_torch.engine import solver as S

    monkeypatch.setenv("DPI_PALLAS_WGRAD", "1")
    # the launch counters count calls from Python, which a step replayed from
    # the solve's CUDA graph does not make: the solves step eagerly
    # (tests/test_torch_cuda_step_graph.py holds the graphed ones to them)
    monkeypatch.setattr(S, "_GRAPHS", False)
    # nearest upsampling (a gather backward, where trilinear's sums with
    # atomics) and deterministic cuDNN: two card runs of one state agree
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    img, mask = flagship_problem(16, 16, 16)
    cfg = Config(datadim="3d", inputdepth=4, filters=[4, 8, 16], skip=[4, 4],
                 upsample="nearest", epochs=6, scan_chunk=3, reg_noise_std=0.0,
                 fused_loss=True, dtype="float32", pocs=True, save_every=3)
    noise = (0.1 * np.random.RandomState(0).randn(16, 16, 16, 4)).astype(np.float32)
    cpu = DIPSolver(cfg, device="cpu")
    init_weights(cpu.model, torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in cpu.model.state_dict().items()}
    kw = dict(seed=0, init_params=init, noise=noise)
    r_cpu = cpu.solve(img, mask, **kw)
    launches = WG.wgrad3d.launches, FL.fused_sums.launches, FL.loss_sums_grad.launches
    straight = DIPSolver(cfg, device=cuda).solve(img, mask, **kw)
    assert WG.wgrad3d.launches > launches[0]
    assert (FL.fused_sums.launches - launches[1], FL.loss_sums_grad.launches - launches[2]) == (6, 6)
    for f in ("loss", "df", "reg", "eps", "th"):
        a, b = np.asarray(getattr(straight.history, f)), np.asarray(getattr(r_cpu.history, f))
        np.testing.assert_allclose(a[:3], b[:3], rtol=1e-4)
    assert sorted(straight.snapshots) == [3] and np.all(np.isfinite(straight.pocs))

    ckpt = str(tmp_path / "state.npz")
    DIPSolver(Config(**{**cfg.to_dict(), "epochs": 3}), device=cuda).solve(
        img, mask, checkpoint_path=ckpt, checkpoint_every=1, **kw)
    resumed = DIPSolver(cfg, device=cuda).solve(img, mask, checkpoint_path=ckpt, **kw)
    assert resumed.iters_run == 6 and len(resumed.history.loss) == 6
    np.testing.assert_allclose(resumed.history.loss[3:], straight.history.loss[3:], rtol=1e-4)
