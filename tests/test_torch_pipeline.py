"""The port's data pipeline (data/pipeline.py, data/bundled.py, ops/masks.py,
ops/filters.py bool2bin) against the JAX package's, on the same inputs.

All of it is numpy with random draws from the same seeded generators, and
the overlap-add sums the same float32 values in the same order, so every
comparison is exact (``assert_array_equal``), but one: XLA on the CPU
flushes subnormal float32 results to zero and torch keeps them, so a
reconstruction of the lines data (values down to 1e-39) agrees to float32's
smallest normal number, 1.2e-38 (``SUBNORMAL``)."""
import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu import config as jcfg
from deep_prior_interpolation_tpu.data import bundled as JB
from deep_prior_interpolation_tpu.data import pipeline as JP
from deep_prior_interpolation_tpu.ops import filters as JF
from deep_prior_interpolation_tpu.ops import masks as JM
from deep_prior_interpolation_tpu_torch import config as pcfg
from deep_prior_interpolation_tpu_torch.data import bundled as PB
from deep_prior_interpolation_tpu_torch.data import pipeline as PP
from deep_prior_interpolation_tpu_torch.engine import History
from deep_prior_interpolation_tpu_torch.io import save_run
from deep_prior_interpolation_tpu_torch.ops import filters as PF
from deep_prior_interpolation_tpu_torch.ops import masks as PM

torch.set_num_threads(1)
SUBNORMAL = dict(rtol=0, atol=float(np.finfo(np.float32).tiny))


def _nan_volume(shape=(12, 10, 8), seed=0):
    """A small volume and its corrupted copy with NaN at a third of the traces."""
    rng = np.random.RandomState(seed)
    vol = rng.randn(*shape).astype(np.float32)
    bad = np.repeat(rng.rand(1, *shape[1:]) < 0.33, shape[0], 0)
    return vol, np.where(bad, np.nan, vol).astype(np.float32)


def _volumes(kind):
    if kind == "lines-2d":
        img, mask = PB.lines_dataset()
        return dict(datadim="2d", gain=1.0, adirandel=0.2), img, mask
    vol, corrupted = _nan_volume()
    if kind == "nan-3d":
        return dict(datadim="3d", gain=40.0, adirandel=0.3, patch_shape=[6, 5, 8],
                    patch_stride=[3, 5, 4], seed=3), vol, corrupted
    return dict(datadim="2.5d", slice="xy", imgchannel=4, gain=2.0, adirandel=0.25,
                patch_shape=[-1, -1, -1], patch_stride=[-1, -1, 2], seed=5), vol, corrupted


@pytest.mark.parametrize("kind", ["lines-2d", "nan-3d", "2.5d"])
def test_extract_and_reconstruct_patches_match_jax(kind):
    kw, original, corrupted = _volumes(kind)
    jc, pc = jcfg.Config(**kw), pcfg.Config(**kw)
    want = JP.extract_patches(jc, original=original, corrupted=corrupted)
    got = PP.extract_patches(pc, original=original, corrupted=corrupted)
    assert [p["name"] for p in got] == [p["name"] for p in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["mask"], w["mask"])
    # an "output" per patch, reassembled by both packages
    outs = np.stack([p["image"] * (1.0 + p["mask"]) for p in want]).astype(np.float32)
    np.testing.assert_allclose(
        PP.reconstruct_patches(pc, patches_out=outs, original=original),
        JP.reconstruct_patches(jc, patches_out=outs, original=original), **SUBNORMAL)


def test_reconstruct_from_a_run_directory_matches_jax(tmp_path):
    kw, original, corrupted = _volumes("nan-3d")
    pc = pcfg.Config(**kw)
    patches = PP.extract_patches(pc, original=original, corrupted=corrupted)
    for p in patches:
        save_run(str(tmp_path), p["name"], History(2), p["mask"], p["image"],
                 p["image"] * 0.5, elapsed=0.0, device="cpu")
    got, hist = PP.reconstruct_patches(pc, results_dir=str(tmp_path), original=original,
                                       return_history=True)
    want = JP.reconstruct_patches(jcfg.Config(**kw), results_dir=str(tmp_path),
                                  original=original)
    np.testing.assert_array_equal(got, want)
    assert len(hist) == len(patches) and set(hist[0]) == set(History.FIELDS)


@pytest.mark.parametrize("rate,regular,shape", [
    (0.4, False, (5, 30)), (0.66, False, (4, 6, 5)), (0.6, True, (3, 11)),
    (0.3, True, (2, 5, 4)),
])
def test_build_mask_matches_jax(rate, regular, shape):
    data = np.ones(shape, np.float32)
    got = PM.build_mask(data, rate, regular, rng=np.random.default_rng(42))
    want = JM.build_mask(data, rate, regular, rng=np.random.default_rng(42))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_add_rand_mask_and_bool2bin_match_jax():
    mask = JM.build_mask(np.ones((6, 20, 4), np.float32), 0.3,
                         rng=np.random.default_rng(1))
    np.testing.assert_array_equal(
        PM.add_rand_mask(mask, 0.4, np.random.default_rng(2)),
        JM.add_rand_mask(mask, 0.4, np.random.default_rng(2)))
    _, corrupted = _nan_volume()
    for logic in (True, False):
        got, want = PF.bool2bin(corrupted, logic), JF.bool2bin(corrupted, logic)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_dilate_mask_and_mask_update_match_jax():
    m = np.zeros((4, 8, 8), np.float32)
    m[:, 4, 4] = 1
    m[:, 1, 6] = 1
    np.testing.assert_array_equal(PM.dilate_mask(m, 2), JM.dilate_mask(m, 2))
    pu = PM.MaskUpdate(m, threshold=2, step=3, rng=np.random.default_rng(0))
    ju = JM.MaskUpdate(m, threshold=2, step=3, rng=np.random.default_rng(0))
    for it in range(12):
        np.testing.assert_array_equal(pu.update(it), ju.update(it))


def test_bundled_data_and_25d_transposes_match_jax():
    for a, b in zip(PB.lines_dataset(), JB.lines_dataset()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(PB.lines_wavelet(), JB.lines_wavelet()):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        PB.dataset_path("lines/missing.npy")
    x = np.arange(2 * 3 * 4 * 5).reshape(2, 3, 4, 5)
    for s in ("xy", "ty", "tx", "yt"):
        for adj in (False, True):
            np.testing.assert_array_equal(PP.transpose_patches_25d(x, s, adj),
                                          JP.transpose_patches_25d(x, s, adj))
