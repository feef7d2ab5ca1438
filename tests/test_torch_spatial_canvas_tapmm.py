"""The optimised canvas and the tapmm formulation over spatial shards
(parallel/spatial.py, ROADMAP A.13c items 8 and 10) against the unsharded
solve on the CPU, float32, 2D and 3D, over ``[cpu] * 2`` and ``[cpu] * 4``.

Under ``opt_over="net,input"`` the sharded canvas is one Adam leaf a shard,
each with its own moments on its shard's device; the result's canvas, and
a checkpoint's canvas and moments, are gathered whole, and a resume splits
them again. Held as tests/test_torch_spatial_options.py holds the options:
3 iterations, losses rtol 1e-4, the best output within 1e-4 of its max;
the gathered canvas and its Adam moments within 1e-5 of their max
(measured: up to 2.0e-6 and 1.2e-6; the shards sum each canvas gradient in
another order).
tapmm over the shards computes every conv, the halo'd ones and the
stride-2 down convs with their one-sided pads, as a float32 product a tap."""
import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.engine import solver as SV
from deep_prior_interpolation_tpu_torch.ops import conv_vjp

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


def held(dim, shards=SHARDS, **kw):
    """The sharded solves of ``cfg(dim, **kw)`` against the unsharded one:
    losses rtol 1e-4, best output within 1e-4 of its max, the canvas within
    1e-5 of its max."""
    c = cfg(dim, **kw)
    img, mask = PROBLEMS[dim][0]()
    ref = DIPSolver(c, device="cpu").solve(img, mask, seed=0)
    got = {n: DIPSolver(c, device="cpu").solve(img, mask, seed=0, spatial_mesh=[CPU] * n)
           for n in shards}
    for res in got.values():
        np.testing.assert_allclose(res.history.loss, ref.history.loss, rtol=1e-4)
        np.testing.assert_allclose(res.out_best, ref.out_best, rtol=0,
                                   atol=1e-4 * float(np.abs(ref.out_best).max()))
        np.testing.assert_allclose(res.noise, ref.noise, rtol=0,
                                   atol=1e-5 * float(np.abs(ref.noise).max()))
        assert res.iters_run == ref.iters_run == 3
    return ref, got


@pytest.fixture
def tapmm_calls(monkeypatch):
    calls = []
    real = conv_vjp._tap_conv
    monkeypatch.setattr(conv_vjp, "_tap_conv",
                        lambda x, w, stride, pads: calls.append((stride, pads))
                        or real(x, w, stride, pads))
    return calls


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_an_optimised_canvas_is_a_leaf_a_shard(dim, monkeypatch, tmp_path):
    leaves = []
    real = SV._FlatParams.adam_step

    def spy(self, grads, *a, **k):
        leaves.append([(tuple(c.shape), c.device) for c in SV._parts(self.canvas)])
        return real(self, grads, *a, **k)
    monkeypatch.setattr(SV._FlatParams, "adam_step", spy)
    c = cfg(dim, opt_over="net,input")
    img, mask = PROBLEMS[dim][0]()
    ref = DIPSolver(c, device="cpu").solve(img, mask, seed=0,
                                           checkpoint_path=str(tmp_path / "whole"),
                                           checkpoint_every=1)
    got = DIPSolver(c, device="cpu").solve(img, mask, seed=0, spatial_mesh=[CPU] * 2,
                                           checkpoint_path=str(tmp_path / "sharded"),
                                           checkpoint_every=1)
    whole, sharded = leaves[0], leaves[3]
    assert len(whole) == 1 and len(sharded) == 2
    padded = whole[0][0]
    assert sum(s[3] for s, _ in sharded) == padded[3] and sharded[0][0][2:3] == padded[2:3]
    # the canvas moved, and the sharded one as the whole one
    plain = DIPSolver(cfg(dim), device="cpu").solve(img, mask, seed=0)
    assert not np.array_equal(ref.noise, plain.noise)
    np.testing.assert_allclose(got.history.loss, ref.history.loss, rtol=1e-4)
    np.testing.assert_allclose(got.noise, ref.noise, rtol=0,
                               atol=1e-5 * float(np.abs(ref.noise).max()))
    # the checkpoints hold the whole canvas and moments
    with np.load(tmp_path / "whole.npz") as a, np.load(tmp_path / "sharded.npz") as b:
        assert a["canvas"].shape == b["canvas"].shape == (1, 4) + padded[2:]
        for k in ("canvas", "canvas_mu", "canvas_nu"):
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-5 * float(np.abs(a[k]).max()),
                                       err_msg=k)
        assert int(a["count"]) == int(b["count"]) == 3
    held(dim, shards=(4,), opt_over="net,input")


def test_a_sharded_canvas_resumes_bit_equal(tmp_path):
    img, mask = volume()
    mesh = [CPU] * 4

    def run(name, epochs):
        return DIPSolver(cfg("3d", opt_over="net,input", epochs=epochs, scan_chunk=2),
                         device="cpu").solve(img, mask, seed=0, spatial_mesh=mesh,
                                             checkpoint_path=str(tmp_path / name),
                                             checkpoint_every=1)
    straight = run("a", 6)
    run("b", 2)
    resumed = run("b", 6)
    assert resumed.iters_run == 6
    np.testing.assert_array_equal(resumed.history.loss, straight.history.loss)
    np.testing.assert_array_equal(resumed.out_best, straight.out_best)
    np.testing.assert_array_equal(resumed.noise, straight.noise)
    with np.load(tmp_path / "a.npz") as a, np.load(tmp_path / "b.npz") as b:
        for k in ("canvas", "canvas_mu", "canvas_nu", "params"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_a_bfloat16_optimised_canvas_still_raises_over_shards():
    with pytest.raises(TypeError, match="bfloat16"):
        DIPSolver(cfg("3d", opt_over="net,input", dtype="bfloat16"), device="cpu").solve(
            *volume(), seed=0, spatial_mesh=[CPU] * 2)


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_tapmm_over_shards(dim, tapmm_calls):
    held(dim, vmap_conv_mode="tapmm")
    # the shards' stride-2 down convs (after their one-sided halo): no pad
    # along the sharded axis (1), one on each side of the others
    assert any(s == 2 and p[1] == (0, 0) and p[0] == (1, 1) for s, p in tapmm_calls)


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_tapmm_with_remat_over_shards_is_bit_equal(dim, tapmm_calls):
    img, mask = PROBLEMS[dim][0]()
    runs = {}
    for remat in (False, True):
        del tapmm_calls[:]
        runs[remat] = DIPSolver(cfg(dim, vmap_conv_mode="tapmm", remat=remat, dropout=0.1),
                                device="cpu").solve(img, mask, seed=0, spatial_mesh=[CPU] * 2)
        runs[remat].taps = len(tapmm_calls)
    assert runs[True].taps > runs[False].taps > 0   # the recompute runs tapmm again
    np.testing.assert_array_equal(runs[True].history.loss, runs[False].history.loss)
    np.testing.assert_array_equal(runs[True].out_best, runs[False].out_best)


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_tapmm_with_phase_space_over_shards(dim, tapmm_calls):
    # 3D at lr 0: the 3D test net's Adam amplifies rounding
    # (tests/test_torch_spatial_phase.py)
    kw = dict(lr=0.0) if dim == "3d" else {}
    held(dim, vmap_conv_mode="tapmm", phase_space=True, phase_levels=-1,
         upsample="linear", **kw)
    # the phase entry convs: stride 2, a halo of one plain plane each side
    assert any(s == 2 and p[1] == (0, 0) and p[0] == (1, 1) for s, p in tapmm_calls)


def test_every_item_at_once_over_four_shards_along_the_first_axis():
    img, mask = one_patch()
    c = cfg("2d", opt_over="net,input", vmap_conv_mode="tapmm", phase_space=True,
            phase_levels=2, remat=True, dropout=0.1, upsample="linear")
    ref = DIPSolver(c, device="cpu").solve(img, mask, seed=0)
    got = DIPSolver(c, device="cpu").solve(img, mask, seed=0, spatial_mesh=[CPU] * 4,
                                           spatial_axis=0)
    np.testing.assert_allclose(got.history.loss, ref.history.loss, rtol=1e-4)
    np.testing.assert_allclose(got.out_best, ref.out_best, rtol=0,
                               atol=1e-4 * float(np.abs(ref.out_best).max()))
    np.testing.assert_allclose(got.noise, ref.noise, rtol=0,
                               atol=1e-5 * float(np.abs(ref.noise).max()))
