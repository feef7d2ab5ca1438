"""The port's linear operators and slopes (ops/linops.py, ops/slopes.py)
against the JAX package's, after the layout transpose ((B, H, W, C) there,
(N, C, H, W) here): every operator and its adjoint at rtol 1e-5, the port's
own adjoints by the dot test (rel 1e-4), ``auto_adjoint`` (a vjp here,
``jax.linear_transpose`` there) against the hand-written adjoints, and the
dips and the steered Laplacians at rtol 1e-4."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deep_prior_interpolation_tpu.ops as J
from deep_prior_interpolation_tpu_torch import ops as P

torch.set_num_threads(1)


def _cf(a: np.ndarray) -> torch.Tensor:
    """channels-last -> channels-first."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _cl(t: torch.Tensor) -> np.ndarray:
    return np.moveaxis(t.detach().numpy(), 1, -1)


WAVELET = np.asarray(J.ricker_wavelet(15, 3.0), np.float32)
THETA = np.array([0.0, 10.0, 20.0, 30.0], np.float32)
# (name, JAX operator, port operator, JAX domain shape, JAX range shape)
OPERATORS = {
    "vertical_grad": (J.vertical_grad(), P.vertical_grad(), (1, 16, 8, 2), (1, 16, 8, 2)),
    "vertical_conv": (J.vertical_conv(WAVELET), P.vertical_conv(WAVELET), (1, 32, 6, 2),
                      (1, 32, 6, 2)),
    "vertical_conv_even": (J.vertical_conv(WAVELET[:8]), P.vertical_conv(WAVELET[:8]),
                           (1, 20, 5, 1), (1, 20, 5, 1)),
    "avo_akirich": (J.avo_modelling(THETA, 0.5, 16, (8,)), P.avo_modelling(THETA, 0.5, 16, (8,)),
                    (1, 16, 8, 3), (1, 16, 8, 4)),
    "avo_fatti": (J.avo_modelling(THETA[:2] + 5, 0.5, 4, linearization="fatti"),
                  P.avo_modelling(THETA[:2] + 5, 0.5, 4, linearization="fatti"),
                  (1, 4, 3), (1, 4, 2)),
    "avo_vsvp_profile": (J.avo_modelling(THETA, np.linspace(0.4, 0.6, 6), 6, (3, 2)),
                         P.avo_modelling(THETA, np.linspace(0.4, 0.6, 6), 6, (3, 2)),
                         (1, 6, 3, 2, 3), (1, 6, 3, 2, 4)),
    "chain": (J.chain([J.vertical_grad(), J.vertical_conv(WAVELET)]),
              P.chain([P.vertical_grad(), P.vertical_conv(WAVELET)]), (1, 24, 4, 1),
              (1, 24, 4, 1)),
    "hessian": (J.hessian(J.vertical_grad()), P.hessian(P.vertical_grad()), (1, 12, 5, 2),
                (1, 12, 5, 2)),
}


@pytest.mark.parametrize("name", list(OPERATORS))
def test_operator_and_adjoint_match_jax(name):
    jop, pop, dom, rng_shape = OPERATORS[name]
    rng = np.random.RandomState(len(name))
    x = rng.randn(*dom).astype(np.float32)
    y = rng.randn(*rng_shape).astype(np.float32)
    for got, want in ((pop(_cf(x)), jop(jnp.asarray(x))), (pop.H(_cf(y)), jop.H(jnp.asarray(y)))):
        want = np.asarray(want)
        np.testing.assert_allclose(_cl(got), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("name", ["vertical_grad", "vertical_conv", "avo_akirich", "avo_fatti",
                                  "chain"])
def test_dot_test_of_the_ports_adjoints(name):
    _, pop, dom, rng_shape = OPERATORS[name]
    cf = (lambda s: (s[0], s[-1]) + s[1:-1])  # the port's shapes
    _, rel = P.dottest(pop, cf(dom), cf(rng_shape))
    assert rel < 1e-4


@pytest.mark.parametrize("name", ["chain", "avo_akirich"])
def test_auto_adjoint_matches_the_hand_written_one(name):
    _, pop, dom, rng_shape = OPERATORS[name]
    gen = torch.Generator().manual_seed(1)
    x = torch.zeros((dom[0], dom[-1]) + dom[1:-1])
    y = torch.randn((rng_shape[0], rng_shape[-1]) + rng_shape[1:-1], generator=gen)
    auto = P.auto_adjoint(pop.forward, x)
    torch.testing.assert_close(auto.H(y), pop.H(y), rtol=1e-6, atol=1e-6)


def test_structure_tensor_dips_match_jax():
    rng = np.random.RandomState(3)
    t = np.linspace(0, 4 * np.pi, 32)
    x = (np.sin(t[:, None] + 0.3 * np.arange(24)[None, :])[None, :, :, None]
         + 0.1 * rng.randn(1, 32, 24, 1)).astype(np.float32)
    for smooth in (0.0, 1.5):
        jphi, jan = J.structure_tensor_dips(jnp.asarray(x), 1.0, 2.0, smooth)
        phi, an = P.structure_tensor_dips(_cf(x), 1.0, 2.0, smooth)
        np.testing.assert_allclose(_cl(phi), np.asarray(jphi), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(_cl(an), np.asarray(jan), rtol=1e-4, atol=1e-5)


def test_directional_laplacian_and_hale_match_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(1, 16, 12, 2).astype(np.float32)
    theta = rng.uniform(-0.5, 0.5, x.shape).astype(np.float32)
    want = np.asarray(J.directional_laplacian(jnp.asarray(x), jnp.asarray(theta)))
    got = P.directional_laplacian(_cf(x), _cf(theta))
    np.testing.assert_allclose(_cl(got), want, rtol=1e-4, atol=1e-5)
    hale = P.Hale2D(_cf(theta))
    np.testing.assert_allclose(_cl(hale(_cf(x))), np.asarray(J.Hale2D(jnp.asarray(theta))(
        jnp.asarray(x))), rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(hale(_cf(x)), got, rtol=0, atol=0)
