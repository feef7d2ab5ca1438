"""The port's signal-processing ops, forgetting data, source wavelet,
resampling blocks, reflection-padded conv and canvas shaping against the JAX
package's, on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu.config import Config as JaxConfig
from deep_prior_interpolation_tpu.data import source_wavelet as jax_source_wavelet
from deep_prior_interpolation_tpu.models import blocks as JB
from deep_prior_interpolation_tpu.ops import filters as JF
from deep_prior_interpolation_tpu.ops.noise import build_forgetting_data as jax_forgetting
from deep_prior_interpolation_tpu_torch import Config
from deep_prior_interpolation_tpu_torch.data import source_wavelet
from deep_prior_interpolation_tpu_torch.engine import build_base_input
from deep_prior_interpolation_tpu_torch.io import jax_params_to_state_dict
from deep_prior_interpolation_tpu_torch.models import blocks as PB
from deep_prior_interpolation_tpu_torch.ops import filters as PF
from deep_prior_interpolation_tpu_torch.ops.noise import build_forgetting_data

torch.set_num_threads(1)


def _cf(a: np.ndarray) -> torch.Tensor:
    """(N, *spatial, C) -> (N, C, *spatial)."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _cl(t: torch.Tensor) -> np.ndarray:
    """(N, C, *spatial) -> (N, *spatial, C) float32."""
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("shape,jax_axis", [((2, 19, 11, 3), 1), ((1, 9, 7, 5, 2), 1),
                                            ((1, 9, 7, 5, 2), 3)])
def test_convolve_kernel_1d_matches_jax(shape, jax_axis):
    x, taps = _rand(*shape), _rand(6, seed=1)  # even width: asymmetric padding
    want = np.asarray(JF.convolve_kernel_1d(jnp.asarray(x), jnp.asarray(taps), jax_axis))
    # channels-last axis a of (N, *s, C) is dim a + 1 of (N, C, *s)
    got = _cl(PF.convolve_kernel_1d(_cf(x), taps, jax_axis + 1))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_lowpass_taps_and_kernels_match_jax():
    np.testing.assert_array_equal(PF.lowpass_butterworth_taps(40.0, 250.0, 7, 4, 256),
                                  JF.lowpass_butterworth_taps(40.0, 250.0, 7, 4, 256))
    np.testing.assert_allclose(PF.ricker_wavelet(31, 3.5).numpy(),
                               np.asarray(JF.ricker_wavelet(31, 3.5)), rtol=1e-6, atol=1e-7)
    for m, sym in ((9, True), (8, False), (8, True)):
        np.testing.assert_allclose(PF.gaussian_kernel(m, 1.7, sym).numpy(),
                                   np.asarray(JF.gaussian_kernel(m, 1.7, sym)), rtol=1e-6)
    np.testing.assert_allclose(source_wavelet(21, 3.0), jax_source_wavelet(21, 3.0),
                               rtol=1e-6, atol=1e-7)
    for kt in ["lanczos2", "lanczos3", "box", "gauss"]:
        np.testing.assert_allclose(PB.resample_kernel_1d(2, kt).numpy(),
                                   np.asarray(JB.resample_kernel_1d(2, kt)), rtol=1e-6)
    with pytest.raises(ValueError):
        PB.resample_kernel_1d(2, "nope")


def test_gaussian_filter_matches_jax():
    x = _rand(1, 12, 10, 8, 2)
    want = np.asarray(JF.gaussian_filter(jnp.asarray(x), 5, 1.2))
    np.testing.assert_allclose(_cl(PF.gaussian_filter(_cf(x), 5, 1.2)), want,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("stencil", ["centered", "forward", "backward"])
def test_derivatives_match_jax(stencil):
    x = _rand(9, 7, 3)
    for axis in (0, 1):
        want = np.asarray(JF.first_derivative(jnp.asarray(x), 0.5, axis, stencil))
        got = PF.first_derivative(torch.from_numpy(x), 0.5, axis, stencil).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        want2 = np.asarray(JF.second_derivative(jnp.asarray(x), 0.5, axis))
        got2 = PF.second_derivative(torch.from_numpy(x), 0.5, axis).numpy()
        np.testing.assert_allclose(got2, want2, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="Stencil"):
        PF.first_derivative(torch.from_numpy(x), stencil="sideways")


def test_gain_and_bool2bin_match_jax():
    x = _rand(16, 5)
    np.testing.assert_array_equal(PF.normalize(x, 0.004, 2.0), JF.normalize(x, 0.004, 2.0))
    np.testing.assert_array_equal(PF.denormalize(x, 0.004, 2.0),
                                  JF.denormalize(x, 0.004, 2.0))
    x[3, 2] = np.nan
    np.testing.assert_array_equal(PF.bool2bin(x), JF.bool2bin(x))


def test_forgetting_data_matches_jax():
    x = _rand(1, 6, 5, 3)
    for depth in (3, 7, 8):
        want = np.asarray(jax_forgetting(jnp.asarray(x), depth))
        np.testing.assert_array_equal(_cl(build_forgetting_data(_cf(x), depth)), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lowpass_canvas_matches_jax(dtype):
    """The port's canvas is its raw noise low-passed along the first spatial
    axis; the JAX package's shaping of the same raw noise agrees."""
    kw = dict(datadim="3d", inputdepth=3, noise_std=0.1, lowpass_fs=250.0, lowpass_fc=40.0,
              dtype=dtype)
    padded = (24, 8, 8)
    got = build_base_input(Config(**kw), torch.Generator().manual_seed(4), padded, "cpu")
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    raw = build_base_input(Config(**{**kw, "lowpass_fs": None}),
                           torch.Generator().manual_seed(4), padded, "cpu")
    assert got.dtype == raw.dtype == tdt and got.shape == (1, 3) + padded
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    taps = JF.lowpass_butterworth_taps(fc=40.0, fs=250.0, ntaps=JaxConfig().lowpass_ntaps,
                                       order=4, nfft=32)
    want = JF.convolve_kernel_1d(jnp.asarray(_cl(raw)).astype(jdt), jnp.asarray(taps, jdt), 1)
    # bfloat16: the 7-tap sums may round differently: one bf16 ulp
    tol = dict(rtol=2 ** -7, atol=1e-3) if dtype == "bfloat16" else dict(rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_cl(got), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("support", [2, 3])
def test_lanczos_downsample_matches_jax(support):
    x = _rand(1, 16, 12, 3)
    want = np.asarray(JB.lanczos_downsample(jnp.asarray(x[0]), 2, support))[None]
    np.testing.assert_allclose(_cl(PB.lanczos_downsample(_cf(x), 2, support)), want,
                               rtol=1e-5, atol=1e-6)


def test_pooling_and_symmetry_match_jax():
    x = _rand(1, 9, 8, 6, 2)
    for mode in ("avg", "max"):
        want = np.asarray(JB.downsample_pool(jnp.asarray(x[0]), 2, mode))[None]
        np.testing.assert_allclose(_cl(PB.downsample_pool(_cf(x), 2, mode)), want,
                                   rtol=1e-6, atol=1e-7)
    s = _rand(1, 5, 5, 2)
    np.testing.assert_allclose(_cl(PB.symmetry(_cf(s))),
                               np.asarray(JB.symmetry(jnp.asarray(s))), rtol=1e-6)


@pytest.mark.parametrize("ndim", [2, 3])
def test_reflection_padded_conv_matches_jax(ndim):
    x = _rand(1, *(7,) * ndim, 3)
    params = {"kernel": _rand(*(3,) * ndim, 3, 4, seed=1), "bias": _rand(4, seed=2)}
    jm = JB.Conv(4, 3, ndim=ndim, pad="reflection")
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    pm = PB.Conv(3, 4, 3, ndim=ndim, pad="reflection")
    pm.load_state_dict(jax_params_to_state_dict(params, like=pm.state_dict()))
    np.testing.assert_allclose(_cl(pm(_cf(x))), want, rtol=1e-5, atol=1e-5)
