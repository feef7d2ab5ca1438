"""The port's patch tiling and overlap-add (data/patcher.py) against the JAX
package's, on the same numpy inputs.

Extraction is numpy in both packages and reconstruction sums the same
float32 values over the same static index map, so every comparison is exact
(``assert_array_equal``)."""
import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu.data import patcher as J
from deep_prior_interpolation_tpu_torch.data import patcher as P

torch.set_num_threads(1)

CASES = {
    "2d-blocks": dict(shape=(20, 18), dim=(8, 6), stride=None),
    "2d-overlap": dict(shape=(24, 20), dim=(8, 8), stride=(4, 2)),
    "3d-blocks": dict(shape=(12, 10, 8), dim=(4, 5, 4), stride=None),
    "3d-overlap": dict(shape=(12, 10, 9), dim=(6, 4, 3), stride=(2, 2, 1)),
    "2d-hanning": dict(shape=(24, 24), dim=(8, 8), stride=(4, 4), tapering="hanning"),
    "2d-cosine": dict(shape=(24, 24), dim=(8, 8), stride=(4, 4), tapering="cosine"),
    "2d-padding": dict(shape=(6, 5), dim=(8, 8), stride=None, padding="reflect"),
    "2d-offset": dict(shape=(20, 20), dim=(8, 8), stride=(4, 4), offset=(2, 3)),
}


def _extractors(kw):
    kw = dict(kw)
    kw.pop("shape")
    return J.PatchExtractor(**kw), P.PatchExtractor(**kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_extract_and_reconstruct_match_jax(case):
    spec = CASES[case]
    x = np.random.RandomState(0).randn(*spec["shape"]).astype(np.float32)
    jpe, ppe = _extractors(spec)
    want, got = jpe.extract(x), ppe.extract(x)
    np.testing.assert_array_equal(got, want)
    assert ppe.in_content_cropped_shape == jpe.in_content_cropped_shape
    # the JAX package reconstructs in float32: hand both float32 patches
    patches = want.astype(np.float32)
    rec_j, rec_p = jpe.reconstruct(patches), ppe.reconstruct(patches)
    assert rec_p.dtype == rec_j.dtype and rec_p.shape == rec_j.shape
    np.testing.assert_array_equal(rec_p, rec_j)


@pytest.mark.parametrize("normalize", [True, False])
def test_overlap_add_matches_jax(normalize):
    # up to 8 patches overlap an element: the sums' order matters here
    image, dim, stride = (10, 9, 8), (4, 3, 4), (2, 1, 2)
    n = J.count_patches(image, dim, stride)
    patches = np.random.RandomState(1).randn(n, *dim).astype(np.float32)
    want = np.asarray(J.overlap_add(patches, image, dim, stride, normalize))
    got = P.overlap_add(torch.from_numpy(patches), image, dim, stride, normalize)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(P.flat_index_map(image, dim, stride),
                                  J.flat_index_map(image, dim, stride))


@pytest.mark.parametrize("sel", ["num", "indexes", "function", "rand"])
def test_patch_selection_matches_jax(sel):
    x = np.random.RandomState(2).rand(24, 24).astype(np.float32)
    kw = {"num": dict(num=3), "indexes": dict(indexes=[4, 0, 2]),
          "function": dict(function=J.mid_intensity_high_texture, threshold=0.5),
          "rand": dict(rand=True)}[sel]
    jpe = J.PatchExtractor(dim=(8, 8), stride=(4, 4), **kw)
    if sel == "function":
        kw = dict(function=P.mid_intensity_high_texture, threshold=0.5)
    ppe = P.PatchExtractor(dim=(8, 8), stride=(4, 4), **kw)
    np.random.seed(7)  # rand permutes with numpy's global generator
    want = jpe.extract(x)
    np.random.seed(7)
    np.testing.assert_array_equal(ppe.extract(x), want)
    assert ppe.patch_array_shape == jpe.patch_array_shape


def test_reconstruct_takes_a_tensor_and_returns_one():
    x = np.random.RandomState(3).randn(24, 20).astype(np.float32)
    pe = P.PatchExtractor(dim=(8, 8), stride=(4, 4))
    patches = pe.extract(x)
    got = pe.reconstruct(torch.from_numpy(patches))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), pe.reconstruct(patches))
    np.testing.assert_allclose(got.numpy(), x[:24, :20], rtol=0, atol=1e-6)


def test_tapers_and_shape_helpers_match_jax():
    for kind in ("hanning", "cosine", "cosinesquare", "rect"):
        np.testing.assert_array_equal(P.taper2d((16, 12), (4, 3), kind),
                                      J.taper2d((16, 12), (4, 3), kind))
    np.testing.assert_array_equal(P.taper3d(5, (8, 6), (2, 2)), J.taper3d(5, (8, 6), (2, 2)))
    for args in (((20, 18), (8, 6), (4, 3)), ((12, 10, 9), (6, 4, 3), (2, 2, 1))):
        assert P.count_patches(*args) == J.count_patches(*args)
        assert P.patch_array_shape(*args) == J.patch_array_shape(*args)
        assert P.in_content_cropped_shape(*args) == J.in_content_cropped_shape(*args)
