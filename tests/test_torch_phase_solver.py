"""The solver and the CLI with phase space and the alternative conv
formulations: ``pad_multiple_for`` against the JAX package's, a tiny phase
solve against the JAX solver (its noise canvas and the port's initial
parameters bridged into both, no per-step input noise), the CLI with
``--phase_space --phase_levels 2``, ``vmap_conv_mode="tapmm"`` and the
packed weight gradient in a solve, and an exact resume of a phase solve.

Tolerances: against JAX, tests/test_torch_solver.py's; the port's phase or
tapmm solve against its own plain one (the same function, rounded in
other places, through Adam's sign-like first steps), rel 1e-4 on the loss
over 4 iterations; on the CPU a resumed solve is bit for bit the straight
one."""
import os

import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu.config import Config as JaxConfig
from deep_prior_interpolation_tpu.engine import DIPSolver as JaxDIPSolver
from deep_prior_interpolation_tpu.engine.solver import pad_multiple_for as jax_pad_multiple_for
from deep_prior_interpolation_tpu_torch import Config, DIPSolver, cli
from deep_prior_interpolation_tpu_torch.config import parse_arguments, read_args
from deep_prior_interpolation_tpu_torch.data import dataset_path, flagship_problem
from deep_prior_interpolation_tpu_torch.engine import pad_multiple_for
from deep_prior_interpolation_tpu_torch.io import load_run, state_dict_to_jax_params
from deep_prior_interpolation_tpu_torch.models import init_weights

torch.set_num_threads(1)

SMALL = dict(datadim="3d", epochs=4, scan_chunk=2, inputdepth=4, filters=[4, 8, 16],
             skip=[4, 4], reg_noise_std=0.0, upsample="linear")
PHASE = dict(phase_space=True, phase_levels=2)


@pytest.mark.parametrize("kw", [
    dict(), dict(phase_space=True), dict(phase_space=True, phase_levels=-1),
    dict(phase_space=True, phase_levels=2, phase_deep_levels=1),
    dict(phase_space=True, phase_levels=3, phase_deep_levels=3, filters=[4, 8, 16, 32, 64],
         skip=[4, 4, 4, 4]),
    dict(phase_space=True, phase_levels=1, phase_deep_levels=2, filters=[4, 8], skip=[4]),
    dict(phase_space=True, phase_levels=-1, phase_deep_levels=2, filters=[4], skip=[]),
    dict(phase_space=True, pad_multiple=6),
])
def test_pad_multiple_matches_jax(kw):
    cfg = dict(SMALL, **kw)
    assert pad_multiple_for(Config(**cfg)) == jax_pad_multiple_for(JaxConfig(**cfg))


def _solve_pair(img, mask, **kw):
    """The port's phase solve and its plain solve from the same parameters
    and canvas."""
    out = []
    for extra in (PHASE, {}):
        solver = DIPSolver(Config(**SMALL, **extra, **kw), device="cpu")
        init_weights(solver.model, torch.Generator().manual_seed(0), "xavier", 0.02)
        noise = 0.1 * np.random.RandomState(0).randn(*img.shape[:-1], 4).astype(np.float32)
        out.append(solver.solve(img, mask, seed=0, noise=noise))
    return out


def test_phase_solve_matches_the_jax_phase_solve():
    img, mask = flagship_problem(8, 16, 16)
    port = DIPSolver(Config(**SMALL, **PHASE), device="cpu")
    init_weights(port.model, torch.Generator().manual_seed(0), "xavier", 0.02)
    init = {k: v.clone() for k, v in port.model.state_dict().items()}
    ref = JaxDIPSolver(JaxConfig(**SMALL, **PHASE), outchannel=1).solve(
        img, mask, seed=0, init_params=state_dict_to_jax_params(init))
    got = port.solve(img, mask, seed=0, init_params=init, noise=ref.noise)
    assert got.iters_run == ref.iters_run == 4
    np.testing.assert_allclose(got.history.loss, ref.history.loss, rtol=2e-4)
    np.testing.assert_allclose(got.history.snr, ref.history.snr, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.out_best, ref.out_best, rtol=1e-3, atol=1e-4)


def test_phase_solve_matches_the_plain_solve():
    img, mask = flagship_problem(8, 16, 16)
    phase, plain = _solve_pair(img, mask)
    np.testing.assert_allclose(phase.history.loss, plain.history.loss, rtol=1e-4)
    np.testing.assert_allclose(phase.out_best, plain.out_best, rtol=0,
                               atol=1e-4 * np.abs(plain.out_best).max())


@pytest.mark.parametrize("env", [{}, {"DPI_PACKED_WGRAD": "1", "DPI_FOLD_WGRAD": "1"}])
def test_tapmm_and_packed_solves_match_the_plain_solve(env, monkeypatch):
    """``vmap_conv_mode="tapmm"`` runs every conv of the step as per-tap
    products; the packed (and folded) weight gradient is taken where the
    gate admits it."""
    img, mask = flagship_problem(8, 16, 16)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    res = {}
    for mode in ("grouped", "tapmm"):
        solver = DIPSolver(Config(**SMALL, vmap_conv_mode=mode), device="cpu")
        init_weights(solver.model, torch.Generator().manual_seed(0), "xavier", 0.02)
        noise = 0.1 * np.random.RandomState(0).randn(8, 16, 16, 4).astype(np.float32)
        res[mode] = solver.solve(img, mask, seed=0, noise=noise)
    np.testing.assert_allclose(res["tapmm"].history.loss, res["grouped"].history.loss,
                               rtol=1e-4)


def test_phase_resume_is_bit_exact(tmp_path):
    img, mask = flagship_problem(8, 16, 16)
    cfg = Config(**{**SMALL, **PHASE, "reg_noise_std": 0.03, "phase_deep_levels": 1})
    straight = DIPSolver(cfg, device="cpu").solve(img, mask, seed=0)
    ckpt = str(tmp_path / "state.npz")
    half = Config(**{**cfg.to_dict(), "epochs": 2})
    DIPSolver(half, device="cpu").solve(img, mask, seed=0, checkpoint_path=ckpt,
                                        checkpoint_every=1)
    resumed = DIPSolver(cfg, device="cpu").solve(img, mask, seed=0, checkpoint_path=ckpt)
    for f in straight.history.FIELDS:
        np.testing.assert_array_equal(getattr(resumed.history, f), getattr(straight.history, f))
    np.testing.assert_array_equal(resumed.out_best, straight.out_best)


def test_cli_runs_phase_space(tmp_path):
    """The README's 2D command cut to a tiny net, with the phase flags: two
    (170, 50) patches padded to multiples of 4, each solved by the phase
    net. Its first loss is the plain net's on the same padding (hence the
    same canvas) to rel 1e-6; Adam's sign-like steps on the near-zero
    gradients of this 2D net grow the rounding differences to ~4e-3 of the
    loss by iteration 3 (measured), so the later ones are held to 1e-2."""
    lines = os.path.dirname(dataset_path("lines/original.npy"))

    def run(outdir, *flags):
        cfg = parse_arguments([
            "--imgdir", lines, "--imgname", "original.npy", "--maskname", "random66.npy",
            "--datadim", "2d", "--gain", "1", "--outdir", outdir, "--epochs", "4",
            "--scan_chunk", "2", "--inputdepth", "4", "--filters", "4", "8", "--skip", "4",
            "--patch_shape", "170", "50", "1", "--reg_noise_std", "0", *flags])
        return cfg, cli.run(cfg, str(tmp_path), device="cpu")
    cfg, out = run("phase", "--phase_space", "--phase_levels", "2", "--phase_deep_levels", "1")
    assert (cfg.phase_space, cfg.phase_levels, cfg.phase_deep_levels) == (True, 2, 1)
    assert pad_multiple_for(cfg) == 4
    back = read_args(os.path.join(out, "args.txt"))
    assert (back.phase_space, back.phase_levels, back.phase_deep_levels) == (True, 2, 1)
    _, plain = run("plain", "--pad_multiple", "4")
    for n in ("0", "1"):
        got = load_run(os.path.join(out, f"{n}_run.npz"))
        ref = load_run(os.path.join(plain, f"{n}_run.npz"))
        assert got["output"].shape == (170, 50, 1)
        np.testing.assert_allclose(got["history"]["loss"][0], ref["history"]["loss"][0],
                                   rtol=1e-6)
        np.testing.assert_allclose(got["history"]["loss"], ref["history"]["loss"], rtol=1e-2)
