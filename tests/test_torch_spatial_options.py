"""The solver's options over spatial shards (parallel/spatial.py, ROADMAP
A.13c items 1-6) against the unsharded solve on the CPU: parameter noise,
canvas shaping, data forgetting, the virtual canvas, dropout and remat, each
in 2D and 3D over ``[cpu] * 2`` and ``[cpu] * 4``.

Both solves draw the same parameters, canvas, noise, parameter noise and
dropout masks from one seed: the sharded step draws each whole where the
unsharded one draws it and splits it. The shards sum the Norm statistics,
the weight gradients and the loss in another order, so a solve of 3
iterations is held to the sharded solves' bounds (tests/test_torch_cli.py):
losses rtol 1e-4, the best output within 1e-4 of its max (measured: 1e-7
and 6e-6). Later iterations part, as Adam's sign-like first steps amplify
rounding. With parameter noise the 3D net amplifies it from the second
update on: its best output parts by 2e-3 of its max after 3 iterations
even over a one-shard mesh, which splits nothing (measured: 1.7e-4 after
two updates), so there the parameter noise is held with ``lr=0``, where
the parameters move by the noise alone and must stay bit-equal. Remat is
bit-equal to the same sharded solve without it."""
import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.parallel import spatial as S

torch.set_num_threads(1)
CPU = torch.device("cpu")
SHARDS = (2, 4)


def one_patch():
    rng = np.random.RandomState(0)
    t = np.linspace(0, 1, 24)[:, None]
    x = np.linspace(0, 1, 32)[None, :]
    img = np.sin(2 * np.pi * (3 * t + 2 * x)).astype(np.float32)[..., None]
    mask = np.repeat((rng.rand(1, 32) > 0.5).astype(np.float32), 24, 0)[..., None]
    return img, mask


def volume():
    rng = np.random.RandomState(1)
    t = np.linspace(0, 1, 16)[:, None, None]
    x = np.linspace(0, 1, 16)[None, :, None]
    y = np.linspace(0, 1, 8)[None, None, :]
    img = np.sin(2 * np.pi * (2 * t + x + y)).astype(np.float32)[..., None]
    mask = np.repeat((rng.rand(1, 16, 8) > 0.4).astype(np.float32), 16, 0)[..., None]
    return img, mask


PROBLEMS = {
    "2d": (one_patch, dict(datadim="2d", inputdepth=4, filters=[8, 16, 32], skip=[4, 4],
                           gain=1.0)),
    "3d": (volume, dict(datadim="3d", inputdepth=4, filters=[4, 8], skip=[4], gain=1.0,
                        upsample="linear")),
}


def cfg(dim, **kw):
    return Config(**{**PROBLEMS[dim][1], "epochs": 3, "scan_chunk": 3, **kw})


def solves(c, dim, shards=SHARDS):
    """The unsharded solve and the sharded one over each shard count."""
    img, mask = PROBLEMS[dim][0]()
    ref = DIPSolver(c, device="cpu").solve(img, mask, seed=0)
    return ref, {n: DIPSolver(c, device="cpu").solve(img, mask, seed=0,
                                                     spatial_mesh=[CPU] * n)
                 for n in shards}


def held(dim, **kw):
    """The sharded solves of ``cfg(dim, **kw)`` against the unsharded one:
    losses rtol 1e-4, best output within 1e-4 of its max, the same canvas."""
    ref, got = solves(cfg(dim, **kw), dim)
    for res in got.values():
        np.testing.assert_allclose(res.history.loss, ref.history.loss, rtol=1e-4)
        np.testing.assert_allclose(res.out_best, ref.out_best, rtol=0,
                                   atol=1e-4 * float(np.abs(ref.out_best).max()))
        np.testing.assert_array_equal(res.noise, ref.noise)
        assert res.iters_run == ref.iters_run
    return ref, got


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_parameter_noise_reaches_every_shard_and_freezes(dim):
    # lr 0: the parameters move by the noise alone, so they stay bit-equal;
    # the early stop after iteration 1 leaves 3 steps of the chunk with
    # ``done``, whose perturbations ``frozen`` must undo on every path
    c = cfg(dim, param_noise=True, lr=0.0, epochs=5, scan_chunk=5, earlystop_patience=1,
            earlystop_min_delta=50.0)
    ref, got = solves(c, dim)
    assert ref.iters_run == 2 and ref.stopped_early
    for res in got.values():
        assert res.iters_run == 2
        np.testing.assert_allclose(res.history.loss, ref.history.loss, rtol=1e-5)
        assert all(torch.equal(res.params[k], v) for k, v in ref.params.items())
    moved = DIPSolver(cfg(dim), device="cpu").model.state_dict()
    assert not all(torch.equal(moved[k], v) for k, v in ref.params.items())
    if dim == "2d":
        held(dim, param_noise=True)
    else:   # the 3D net parts from the second update on (module docstring)
        ref, got = solves(cfg(dim, param_noise=True), dim)
        for res in got.values():
            np.testing.assert_allclose(res.history.loss, ref.history.loss, rtol=1e-4)


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_a_low_pass_canvas_is_shaped_whole_then_split(dim):
    ref, got = held(dim, lowpass_fs=250.0, lowpass_fc=40.0)
    plain = DIPSolver(cfg(dim), device="cpu").solve(*PROBLEMS[dim][0](), seed=0)
    assert not np.array_equal(ref.noise, plain.noise)   # the shaping took effect
    if dim == "2d":   # the wavelet flag shapes nothing and turns the virtual canvas off
        held(dim, filter_noise_with_wavelet=True, virtual_input=True)


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_data_forgetting_adds_its_term_to_every_shard(dim):
    ref, _ = held(dim, data_forgetting_factor=3, epochs=4, scan_chunk=2)
    plain = DIPSolver(cfg(dim, epochs=4, scan_chunk=2), device="cpu").solve(
        *PROBLEMS[dim][0](), seed=0)
    assert ref.history.loss[0] != plain.history.loss[0]
    if dim == "3d":   # a bfloat16 net's output is refused, as unsharded (D.4)
        c = cfg(dim, data_forgetting_factor=3, dtype="bfloat16")
        with pytest.raises(TypeError, match="tracked best output"):
            DIPSolver(c, device="cpu").solve(*volume(), seed=0, spatial_mesh=[CPU] * 2)


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_the_virtual_canvas_is_drawn_whole_and_split(dim, monkeypatch):
    stored, stored_shards = held(dim)
    sizes = []
    real = S.SpatialLayout.views
    monkeypatch.setattr(S.SpatialLayout, "views",
                        lambda self, t: sizes.append(t.shape) or real(self, t))
    ref, got = held(dim, virtual_input=True)
    assert len(sizes) == 2 * 3 * len(SHARDS)   # canvas and noise, 3 steps a solve
    # the stored solve's canvas, drawn again each step: bit for bit the
    # stored solves, sharded or not
    np.testing.assert_array_equal(ref.noise, stored.noise)
    np.testing.assert_array_equal(ref.history.loss, stored.history.loss)
    for n, res in got.items():
        np.testing.assert_array_equal(res.history.loss, stored_shards[n].history.loss)
        np.testing.assert_array_equal(res.out_best, stored_shards[n].out_best)


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_dropout_draws_one_mask_a_site_at_the_volume_s_shape(dim, monkeypatch):
    shapes = []
    real = torch.rand

    def spy(*a, **k):
        shapes.append(tuple(a[0]))
        return real(*a, **k)
    monkeypatch.setattr(torch, "rand", spy)
    ref, got = held(dim, dropout=0.1)
    plain = DIPSolver(cfg(dim), device="cpu").solve(*PROBLEMS[dim][0](), seed=0)
    assert ref.history.loss[0] != plain.history.loss[0]
    # every solve draws the same masks, in the same order, at the same shapes
    per_solve = len(shapes) // (1 + len(SHARDS))
    assert per_solve and shapes == shapes[:per_solve] * (1 + len(SHARDS))


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_remat_over_the_shards_recomputes_and_is_bit_equal(dim, monkeypatch):
    kw = dict(dropout=0.1, param_noise=True, epochs=4, scan_chunk=2)
    img, mask = PROBLEMS[dim][0]()
    calls = [0]
    real = S._HaloExchange.forward

    def spy(ctx, *a):
        calls[0] += 1
        return real(ctx, *a)
    monkeypatch.setattr(S._HaloExchange, "forward", staticmethod(spy))
    runs = {}
    for name, extra in (("plain", {}), ("remat", dict(remat=True)),
                        ("level0", dict(remat=True, remat_levels=1))):
        calls[0] = 0
        runs[name] = DIPSolver(cfg(dim, **kw, **extra), device="cpu").solve(
            img, mask, seed=0, spatial_mesh=[CPU] * 2)
        runs[name].halos = calls[0]
    # the recompute exchanges the halos again: every block, or level 0's
    assert runs["plain"].halos < runs["level0"].halos < runs["remat"].halos
    for name in ("remat", "level0"):
        np.testing.assert_array_equal(runs[name].history.loss, runs["plain"].history.loss)
        np.testing.assert_array_equal(runs[name].out_best, runs["plain"].out_best)
        assert all(torch.equal(runs[name].params[k], v) for k, v in runs["plain"].params.items())
    held(dim, remat=True, dropout=0.1)


def test_every_option_at_once_over_four_shards_along_the_first_axis():
    img, mask = volume()
    c = cfg("3d", remat=True, dropout=0.1, param_noise=True, lowpass_fs=250.0,
            lowpass_fc=40.0, data_forgetting_factor=3, lr=0.0)
    ref = DIPSolver(c, device="cpu").solve(img, mask, seed=0)
    got = DIPSolver(c, device="cpu").solve(img, mask, seed=0, spatial_mesh=[CPU] * 4,
                                           spatial_axis=0)
    np.testing.assert_allclose(got.history.loss, ref.history.loss, rtol=1e-5)
    np.testing.assert_allclose(got.out_best, ref.out_best, rtol=0,
                               atol=1e-4 * float(np.abs(ref.out_best).max()))
    assert all(torch.equal(got.params[k], v) for k, v in ref.params.items())
