"""Phase space, the optimised canvas and tapmm over spatial shards
(parallel/spatial.py) on a CUDA card, with the kernels: each sharded solve
over ``[cuda:0] * 2`` against the unsharded card solve at a small size
(float32, TF32 off, the fused loss, ``DPI_PALLAS_WGRAD=1``), first 3
losses rtol 1e-4 as the CPU tests hold them, every run with one
summation order (deterministic cuDNN, the wgrad kernel's first candidate
grid, as tests/test_torch_cuda_spatial_options.py runs); every shard launches each
kernel where the unsharded step launches it, so the phase convs' weight
gradients reach the wgrad kernel on every shard as they do unsharded.

Imports only torch and the port, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda_spatial_phase.py -q

Every test skips without a CUDA card (the kernels have no CPU mode); the
CPU tests hold the same solves against the unsharded port and the JAX
package (tests/test_torch_spatial_{phase,canvas_tapmm,jax_phase}.py)."""
import dataclasses

import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.engine import solver as S
from deep_prior_interpolation_tpu_torch.ops import fused_loss as FL
from deep_prior_interpolation_tpu_torch.ops import upsample as U
from deep_prior_interpolation_tpu_torch.ops import wgrad as WG

torch.set_num_threads(1)


def first_grid(x, dy, k):
    """The wgrad planner's first candidate grid for this shape, in place of
    the tuner's fastest: one summation order in every run."""
    pl = WG._plans(x.shape[1], dy.shape[1], *x.shape[2:], k, x.dtype == torch.bfloat16,
                   x.shape[0])[0]
    return pl, WG._args(pl, WG._aligned(x, dy), x.shape[0])


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    monkeypatch.setenv("DPI_PALLAS_WGRAD", "1")
    monkeypatch.setattr(WG, "_tune", first_grid)
    monkeypatch.setattr(WG, "_tuned", {})
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    # the launch counters count calls from Python, which a step replayed
    # from a one-device solve's CUDA graph does not make: the unsharded
    # reference steps eagerly (tests/test_torch_cuda_step_graph.py holds the
    # graphed solve against the eager one)
    monkeypatch.setattr(S, "_GRAPHS", False)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    yield torch.device("cuda:0")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def volume():
    rng = np.random.RandomState(1)
    t = np.linspace(0, 1, 16)[:, None, None]
    x = np.linspace(0, 1, 16)[None, :, None]
    y = np.linspace(0, 1, 16)[None, None, :]
    img = np.sin(2 * np.pi * (2 * t + x + y)).astype(np.float32)[..., None]
    mask = np.repeat((rng.rand(1, 16, 16) > 0.4).astype(np.float32), 16, 0)[..., None]
    return img, mask


def cfg(**kw):
    return Config(**{**dict(datadim="3d", inputdepth=4, filters=[4, 8, 16], skip=[4, 4],
                            upsample="linear", epochs=3, scan_chunk=3, gain=1.0,
                            fused_loss=True, dtype="float32"), **kw})


def counts():
    return (FL.fused_sums.launches, FL.loss_sums_grad.launches, WG.wgrad3d.launches,
            U.upsample_bwd.launches)


def launched(fn):
    """``fn()`` and the launches of each kernel it made."""
    before = counts()
    out = fn()
    return out, tuple(a - b for a, b in zip(counts(), before))


def against_unsharded(c, dev, shards=2):
    """The unsharded and the sharded card solve of ``c``, each with its
    launches; the first 3 losses held to rtol 1e-4, and each kernel
    launched once a shard where the unsharded solve launches it once."""
    img, mask = volume()
    ref, n_ref = launched(lambda: DIPSolver(c, device=dev).solve(img, mask, seed=0))
    got, n = launched(lambda: DIPSolver(c, device=dev).solve(
        img, mask, seed=0, spatial_mesh=[dev] * shards))
    np.testing.assert_allclose(got.history.loss[:3], ref.history.loss[:3], rtol=1e-4)
    assert np.all(np.isfinite(got.out_best)) and got.out_best.shape == img.shape
    assert n == tuple(shards * k for k in n_ref) and n[2] > 0
    return ref, got, n


@pytest.mark.parametrize("kw", [
    dict(phase_levels=1), dict(phase_levels=-1, phase_deep_levels=1, upsample="nearest"),
    dict(phase_levels=2, remat=True, dropout=0.1)])
def test_a_phase_net_over_two_shards_of_the_card(cuda, kw):
    _, _, n = against_unsharded(cfg(phase_space=True, **kw), cuda)
    if kw.get("phase_levels") == 1:   # resolution 2's upsample stays plain: on the kernel
        assert n[3] == 2 * 3


def test_an_optimised_canvas_over_two_shards_of_the_card(cuda, tmp_path):
    c = cfg(opt_over="net,input")
    against_unsharded(c, cuda)
    # the first step's canvas gradient: Adam's first moment after one
    # update, (1 - 0.9) g, from each solve's checkpoint (the shards' leaves
    # gathered whole). The canvas itself is not held: Adam's first step
    # moves each entry by lr times the sign of its gradient, so an entry
    # whose gradient is at rounding level can part by 2 lr
    img, mask = volume()
    mus = []
    for name, mesh in (("whole", None), ("sharded", [cuda] * 2)):
        DIPSolver(dataclasses.replace(c, epochs=1, scan_chunk=1), device=cuda).solve(
            img, mask, seed=0, spatial_mesh=mesh, checkpoint_path=str(tmp_path / name),
            checkpoint_every=1)
        with np.load(tmp_path / f"{name}.npz") as z:
            mus.append(z["canvas_mu"])
    np.testing.assert_allclose(mus[1], mus[0], rtol=0, atol=1e-4 * float(np.abs(mus[0]).max()))


def test_tapmm_with_phase_space_and_the_canvas_over_four_shards(cuda, tmp_path):
    c = cfg(vmap_conv_mode="tapmm", phase_space=True, phase_levels=2, opt_over="net,input",
            epochs=4, scan_chunk=2)
    against_unsharded(c, cuda, shards=4)
    img, mask = volume()

    def run(name, epochs):
        return DIPSolver(dataclasses.replace(c, epochs=epochs), device=cuda).solve(
            img, mask, seed=0, spatial_mesh=[cuda] * 4, checkpoint_path=str(tmp_path / name),
            checkpoint_every=1)
    straight = run("a", 4)
    run("b", 2)
    resumed = run("b", 4)
    assert resumed.iters_run == 4
    np.testing.assert_array_equal(resumed.history.loss, straight.history.loss)
    np.testing.assert_array_equal(resumed.out_best, straight.out_best)
    np.testing.assert_array_equal(resumed.noise, straight.noise)
