"""The Langevin optimizers (engine/optimizers.py) against the JAX package's
optax transformations: with the noise draws set to zero, 20 steps on a
quadratic trace the same parameters (rtol 1e-5); SGLD's momentum is
torch SGD's with dampening; the noise has its stated std (1e5 draws,
within 3 %); the validation errors are the JAX package's."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep_prior_interpolation_tpu.engine import psgld as jax_psgld
from deep_prior_interpolation_tpu.engine import sgld as jax_sgld
from deep_prior_interpolation_tpu_torch.engine import PSGLD, SGLD, psgld, sgld

torch.set_num_threads(1)
TARGET = np.array([1.0, -2.0, 3.0, 0.5, -0.25], np.float32)


def _jax_trajectory(opt, steps):
    p = jnp.zeros(len(TARGET))
    state = opt.init(p)
    out = []
    for _ in range(steps):
        g = 2.0 * (p - jnp.asarray(TARGET))
        upd, state = opt.update(g, state, p)
        p = optax.apply_updates(p, upd)
        out.append(np.asarray(p))
    return np.stack(out)


def _port_trajectory(make, steps):
    p = torch.zeros(len(TARGET), requires_grad=True)
    opt = make([p])
    out = []
    for _ in range(steps):
        p.grad = 2.0 * (p.detach() - torch.from_numpy(TARGET))
        opt.step()
        out.append(p.detach().numpy().copy())
    return np.stack(out)


CASES = {
    "sgld": dict(lr=0.05),
    "sgld_momentum_dampening": dict(lr=0.05, momentum=0.9, dampening=0.3),
    "sgld_nesterov_weight_decay": dict(lr=0.05, momentum=0.5, nesterov=True, weight_decay=0.1),
    "psgld": dict(lr=5e-3, Lambda=1e-1),
    "psgld_centered_weight_decay": dict(lr=5e-3, beta=0.9, Lambda=1e-2, centered=True,
                                        weight_decay=0.05),
}


@pytest.mark.parametrize("name", list(CASES))
def test_noiseless_trajectory_matches_jax(name, monkeypatch):
    kw = CASES[name]
    # every noise draw zero in both packages: the update is the drift alone
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.zeros(shape, dtype))
    monkeypatch.setattr(torch, "randn", lambda shape, **k: torch.zeros(
        shape, dtype=k.get("dtype") or torch.float32, device=k.get("device")))
    is_sgld = name.startswith("sgld")
    jopt = (jax_sgld(noise_scale=0.1, **kw) if is_sgld else jax_psgld(**kw))
    make = ((lambda p: sgld(p, noise_scale=0.1, **kw)) if is_sgld
            else (lambda p: psgld(p, **kw)))
    want = _jax_trajectory(jopt, 20)
    got = _port_trajectory(make, 20)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert np.abs(got[-1]).max() > 0


def test_sgld_momentum_is_torch_sgd_with_dampening():
    g_seq = [np.array([1.0, -2.0], np.float32), np.array([0.5, 0.25], np.float32),
             np.array([-1.5, 3.0], np.float32)]
    lr, mom, damp = 0.1, 0.9, 0.3
    runs = []
    for make in (lambda p: torch.optim.SGD(p, lr=lr, momentum=mom, dampening=damp),
                 lambda p: SGLD(p, lr=lr, noise_scale=0.0, momentum=mom, dampening=damp)):
        p = torch.zeros(2, requires_grad=True)
        opt = make([p])
        for g in g_seq:
            p.grad = torch.from_numpy(g.copy())
            opt.step()
        runs.append(p.detach().numpy())
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-6)


def test_the_noise_has_its_stated_std():
    n = 100_000
    p = torch.zeros(n, requires_grad=True)
    p.grad = torch.zeros(n)
    SGLD([p], lr=0.0, noise_scale=0.25, generator=torch.Generator().manual_seed(0)).step()
    assert abs(float(p.detach().std()) / 0.5 - 1) < 0.03
    lr, beta, lam, c = 1e-3, 0.99, 1e-8, 2.0
    q = torch.zeros(n, requires_grad=True)
    q.grad = torch.full((n,), c)
    PSGLD([q], lr=lr, beta=beta, Lambda=lam, seed=1).step()
    big_g = np.sqrt((1 - beta) * c * c) + lam
    assert abs(float(q.detach().std()) / np.sqrt(2 * lr / big_g) - 1) < 0.03
    assert abs(float(q.detach().mean()) + lr * c / big_g) < 0.03 * np.sqrt(2 * lr / big_g)


def test_the_generator_gives_the_noise():
    draws = []
    for seed in (3, 3, 4):
        p = torch.zeros(8, requires_grad=True)
        p.grad = torch.zeros(8)
        SGLD([p], lr=0.1, generator=torch.Generator().manual_seed(seed)).step()
        draws.append(p.detach().clone())
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])


@pytest.mark.parametrize("kw, fn", [
    (dict(lr=-1.0), "sgld"), (dict(lr=0.1, momentum=-0.5), "sgld"),
    (dict(lr=0.1, nesterov=True), "sgld"), (dict(lr=0.1, momentum=0.9, dampening=0.1,
                                                 nesterov=True), "sgld"),
    (dict(beta=-0.5), "psgld"), (dict(Lambda=-1.0), "psgld"), (dict(lr=-0.1), "psgld"),
])
def test_validation_errors_are_the_jax_packages(kw, fn):
    with pytest.raises(ValueError) as jerr:
        (jax_sgld if fn == "sgld" else jax_psgld)(**kw)
    with pytest.raises(ValueError) as perr:
        (sgld if fn == "sgld" else psgld)([torch.zeros(1, requires_grad=True)], **kw)
    assert str(perr.value) == str(jerr.value)
