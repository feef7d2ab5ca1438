"""A net given to the solver whose output does not fit the solve (ROADMAP
D.14): ``DIPSolver`` builds a library net that makes its children at its
first call (``CBAM``, ``GridAttentionBlock``), as flax's ``init`` does, and
checks that the net's output is ``(1, outchannel, *padded)`` before
anything is drawn (``engine.solver.check_net_output``), sharded or not, in
one solve or in a batch of patches. A ConvGRU ensemble of two frames,
``CBAM(4)`` for one output channel and a skip net with even kernel sizes
raise ``TypeError`` naming both shapes, where the JAX solver's scan refuses
the carry (or, for ``filter_skip_size=2``, runs on with an output that
does not cover the patch); ``GridAttentionBlock`` keeps the ``TypeError``
of its missing second input. A skip net with even kernel sizes constructs,
and its forward equals the JAX module's (bridged weights, 32 x 32 in,
24 x 24 out for ``filter_size_down=4``); ``CBAM(4)`` with four output
channels is built by the solver and solves, sharded too."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deep_prior_interpolation_tpu.models as J
from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.engine import solver as E
from deep_prior_interpolation_tpu_torch.io import state_dict_to_jax_params
from deep_prior_interpolation_tpu_torch.models import (CBAM, Ensemble, GridAttentionBlock,
                                                      SkipNet, init_weights)
from deep_prior_interpolation_tpu_torch.parallel import solve_patches_batched

torch.set_num_threads(1)
CPU = torch.device("cpu")
SKIP = dict(filters=(4, 8), skip=(4,))

# what the solve refuses: the net, and what the TypeError says
MISFITS = {
    "ensemble_2_frames": (lambda: Ensemble(4, 1, num_frames=2, hidden=8),
                          r"output is \(2, 1, 32, 32\) for an input of \(1, 4, 32, 32\), not "
                          r"the tracked output's \(1, 1, 32, 32\)"),
    "cbam": (lambda: CBAM(4), r"output is \(1, 4, 32, 32\) .* \(1, 1, 32, 32\)"),
    "skip_down_4": (lambda: SkipNet(4, 1, 2, filter_size_down=4, **SKIP),
                    r"output is \(1, 1, 24, 24\) .* \(1, 1, 32, 32\)"),
    "skip_skip_2": (lambda: SkipNet(4, 1, 2, filter_skip_size=2, **SKIP),
                    r"output is \(1, 1, 30, 30\) .* \(1, 1, 32, 32\)"),
    "grid_attention": (lambda: GridAttentionBlock(4), "missing 1 required positional argument"),
}


def cfg(**kw):
    return Config(**{**dict(datadim="2d", epochs=2, scan_chunk=2, inputdepth=4, gain=1.0,
                            filters=[4, 8], skip=[4]), **kw})


def problem(channels=1):
    rng = np.random.RandomState(0)
    img = rng.randn(32, 32, channels).astype(np.float32)
    return img, (rng.rand(32, 32, channels) > 0.5).astype(np.float32)


@pytest.fixture
def drawn(monkeypatch):
    calls = []
    real = E._generators
    monkeypatch.setattr(E, "_generators", lambda *a: calls.append(1) or real(*a))
    return calls


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("net", list(MISFITS))
def test_a_net_that_does_not_fit_is_refused_before_anything_is_drawn(net, sharded, drawn):
    make, what = MISFITS[net]
    img, mask = problem()
    mesh = [CPU] * 2 if sharded else None
    with pytest.raises(TypeError, match=what):
        DIPSolver(cfg(), device="cpu", model=make()).solve(img, mask, spatial_mesh=mesh)
    assert not drawn


def test_a_batch_of_patches_refuses_it_too(drawn):
    img, mask = problem()
    patches = [{"image": img, "mask": mask}] * 2
    c = cfg()
    make, what = MISFITS["ensemble_2_frames"]
    with pytest.raises(TypeError, match=what):
        solve_patches_batched(c, DIPSolver(c, device="cpu", model=make()), patches)
    assert not drawn


@pytest.mark.parametrize("kw,side", [(dict(filter_size_down=4), 24),
                                     (dict(filter_size_down=[3, 4]), 28),
                                     (dict(filter_skip_size=2, pad="reflection"), 30)])
def test_an_even_kernel_skip_net_constructs_and_is_the_jax_module(kw, side):
    """Forward to 1e-5 of its largest value, from the port's weights
    bridged into the JAX module."""
    net = SkipNet(4, 1, 2, **SKIP, **kw)
    init_weights(net, torch.Generator().manual_seed(0), "xavier", 0.02)
    x = np.random.RandomState(1).randn(1, 32, 32, 4).astype(np.float32)
    jm = J.SkipNet(out_channels=1, ndim=2, **SKIP, **kw)
    ref = np.asarray(jax.jit(lambda p: jm.apply({"params": p}, jnp.asarray(x)))(
        state_dict_to_jax_params(net.state_dict())))
    with torch.no_grad():
        got = net(torch.from_numpy(np.moveaxis(x, -1, 1))).numpy()
    assert ref.shape == (1, side, side, 1)
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("sharded", [False, True])
def test_a_library_block_built_at_its_first_call_is_built_by_the_solver(sharded):
    """``CBAM(4)`` as the net of a 4-channel problem: built at the canvas's
    shape before its weights are drawn, then solved; over 2 shards its
    walk (the channel gate's volume max and mean, the spatial gate's 7 x 7
    halo) follows the unsharded solve's first loss to rtol 1e-5."""
    img, mask = problem(4)
    model = CBAM(4)
    assert not model._built and not list(model.parameters())
    ref = DIPSolver(cfg(), 4, device="cpu", model=CBAM(4)).solve(img, mask, seed=0)
    got = DIPSolver(cfg(), 4, device="cpu", model=model).solve(
        img, mask, seed=0, spatial_mesh=[CPU] * 2 if sharded else None)
    assert model._built and len(list(model.parameters())) == 8   # 2 Dense, Conv, Norm
    assert got.out_best.shape == img.shape and np.all(np.isfinite(got.history.loss))
    np.testing.assert_allclose(got.history.loss[0], ref.history.loss[0], rtol=1e-5)
