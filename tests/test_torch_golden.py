"""The port's convergence goldens (scripts/torch_golden.py) against the JAX
repository's golden scripts.

Each workload is the JAX script's own, bit for bit: the arrays from its
functions (``golden_3d.make_problem``, ``golden_25d.make_workload``, the
JAX package's ``lines_dataset`` and ``decimated_pair``/``extract_patches``,
``bench.synth_hyperbolic``) and its ``Config``, field for field. ``accept``
reproduces the verdicts stored in the JAX goldens from their columns. The
2.5D and POCS stop-grad configurations, at narrow widths, solve as the JAX
solver does: the same initial parameters (drawn by the port, bridged to
JAX), the JAX run's canvas and no per-step input noise (JAX and torch draw
different random numbers); the losses of iterations 0-1 agree to 1e-5
relative (float32 both sides, the sums in other orders)."""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu.config import Config as JaxConfig
from deep_prior_interpolation_tpu.engine import DIPSolver as JaxDIPSolver
from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.io import state_dict_to_jax_params
from deep_prior_interpolation_tpu_torch.models import init_weights

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))
sys.path.insert(0, str(REPO))

import bench  # noqa: E402
import golden_25d  # noqa: E402
import golden_3d  # noqa: E402
import torch_golden as G  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "deep_prior_interpolation_tpu"}

# the JAX scripts' Config arguments (golden_3d.py:162-171, golden_25d.py:
# 127-133, golden_2d.py:108-113, golden_pocs.py:132-139, quality_3d.py)
JAX_CONFIGS = {
    "g3d": dict(datadim="3d", epochs=150, loss="mae", lr=1e-3, inputdepth=64, gain=1.0,
                upsample="linear", reg_noise_std=0.03, noise_std=0.1, scan_chunk=25),
    "g25d": dict(datadim="2.5d", slice="tx", imgchannel=8, epochs=300, loss="mae", lr=1e-3,
                 inputdepth=64, gain=1.0, reg_noise_std=0.03, noise_std=0.1, scan_chunk=50),
    "g2d": dict(datadim="2d", epochs=300, loss="mae", lr=1e-3, inputdepth=64, gain=1.0,
                reg_noise_std=0.03, noise_std=0.1, scan_chunk=50),
    "gpocs": dict(datadim="2d", epochs=300, loss="mae", lr=1e-3, inputdepth=64, gain=1.0,
                  reg_noise_std=0.03, noise_std=0.1, scan_chunk=50, pocs=True,
                  pocs_alpha=0.1, pocs_thresh=5.0, pocs_eps_mode="stop_grad"),
    "flagship": dict(datadim="3d", epochs=2000, loss="mae", lr=1e-3, inputdepth=64,
                     upsample="linear", gain=40.0, reg_noise_std=0.03, noise_std=0.1,
                     scan_chunk=25, dtype="bfloat16", remat=False, phase_space=True,
                     phase_levels=3, virtual_input=False),
}


@pytest.mark.parametrize("s", [0, 7])
def test_g3d_problem_is_the_jax_scripts(s):
    for got, want in zip(G.g3d_problem(s), golden_3d.make_problem(s)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_g25d_workload_is_the_jax_scripts():
    for got, want in zip(G.g25d_workload(), golden_25d.make_workload()):
        np.testing.assert_array_equal(got, want)
        assert got.shape == (32, 32, 8)


def test_lines_are_the_jax_scripts():
    # golden_2d.py and golden_pocs.py's load_lines: the bundled gather as float32
    from deep_prior_interpolation_tpu.data import lines_dataset
    for got, want in zip(G.lines(), lines_dataset()):
        np.testing.assert_array_equal(got, np.asarray(want, np.float32))


def test_flagship_volume_is_quality_3ds():
    vol = bench.synth_hyperbolic(256, 128, 128)
    rng = np.random.RandomState(1)
    mask = np.repeat((rng.rand(1, 128, 128) > 0.66).astype(np.float32), 256, 0)
    img, msk = G.flagship_problem()
    np.testing.assert_array_equal(img, (vol * 40.0)[..., None])
    np.testing.assert_array_equal(msk, mask[..., None])


def test_field_scale_patches_are_the_jax_examples():
    # examples/field_scale.py's gather and tiling
    from deep_prior_interpolation_tpu.data import decimated_pair as jax_pair
    from deep_prior_interpolation_tpu.data import extract_patches as jax_extract
    from deep_prior_interpolation_tpu_torch.data import decimated_pair, extract_patches
    kw = dict(datadim="2d", gain=1.0, patch_shape=[128, 64], patch_stride=[64, 32])
    want = jax_extract(JaxConfig(**kw), *jax_pair(nt=256, nx=128, ny=None, rate=0.5, seed=3))
    got = extract_patches(Config(**kw), *decimated_pair(nt=256, nx=128, ny=None, rate=0.5,
                                                        seed=3))
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        for k in ("image", "mask"):
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("workload", list(JAX_CONFIGS))
def test_config_is_the_jax_scripts(workload):
    # every field both packages' Configs have, but the fused-loss switch
    want = dataclasses.asdict(JaxConfig(**JAX_CONFIGS[workload]))
    got = dataclasses.asdict(G.config(workload, JAX_CONFIGS[workload]["epochs"], True))
    assert got["fused_loss"] is True
    shared = (set(got) & set(want)) - {"fused_loss"}
    assert len(shared) > 60
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}


@pytest.mark.parametrize("name,golden,run_iters", [("golden_3d.json", "g3d_150", 600),
                                                  ("golden_25d.json", "g25d", 300),
                                                  ("golden_2d.json", "g2d_300", 3000)])
def test_accept_reproduces_the_stored_verdicts(name, golden, run_iters):
    with open(REPO / name) as fh:
        d = json.load(fh)
    o, r = d["ours"]["best_snr"], d["reference"]["best_snr"]
    assert G.stats(o["values"])["mean"] == pytest.approx(o["mean"], abs=1e-9)
    assert G.accept(G.stats(o["values"]), r) == d["accept"] is True
    # a copy moved away from the reference by 3 sigma is refused
    shift = 3 * max(o["std"], r["std"]) * (1 if o["mean"] >= r["mean"] else -1)
    assert not G.accept(G.stats([v + shift for v in o["values"]]), r)
    # a run of the golden's seeds, as long as the longest golden of its
    # workload, is judged on its first iterations: "ours" as the port's
    # best SNR there (and 99 dB later) gives the stored verdict
    n = G.GOLDENS[golden].iters
    run = {"iters": run_iters, "seeds": len(o["values"]), "runner": "solve", "kernels": "on",
           "launches": {}, "wall_s": 0.0, "s_per_iter": None, "peak_memory_bytes": None,
           "per_seed": [{"snr": [v - 1.0] * (n - 1) + [v] + [99.0] * (run_iters - n),
                         "loss": [1.0] * run_iters, "snr_out_best": v} for v in o["values"]]}
    rec = G.summarise(golden, G.GOLDENS[golden], run)
    assert rec["best_snr"]["values"] == pytest.approx(o["values"], abs=1e-12)
    assert rec["reference"]["accept"] == d["accept"]
    assert rec["accept"] is True and rec["jax"]["gap_db"] == pytest.approx(0.0, abs=1e-9)


NARROW = dict(epochs=5, scan_chunk=5, inputdepth=4, filters=[4, 8], skip=[4],
              reg_noise_std=0.0)


def _solve_both(workload, img, mask, outchannel):
    """The narrow JAX solve (plain loss: its fused kernel in interpret mode
    compiles for a minute) and the port's (fused loss: its plain version on
    the CPU) from the same parameters and canvas."""
    kw = {**JAX_CONFIGS[workload], **NARROW}
    port = DIPSolver(Config(**kw), outchannel, device="cpu")
    init_weights(port.model, torch.Generator().manual_seed(0), "xavier", 0.02)
    init = {k: v.clone() for k, v in port.model.state_dict().items()}
    ref = JaxDIPSolver(JaxConfig(**kw), outchannel=outchannel).solve(
        img, mask, seed=0, init_params=state_dict_to_jax_params(init))
    got = DIPSolver(Config(**kw, fused_loss=True), outchannel, device="cpu").solve(
        img, mask, seed=0, init_params=init, noise=ref.noise)
    assert got.iters_run == ref.iters_run == 5
    np.testing.assert_allclose(got.history.loss[:2], ref.history.loss[:2], rtol=1e-5)
    assert np.all(np.isfinite(got.history.snr)) and len(got.history.snr) == 5
    return got, ref


def test_25d_solve_matches_jax():
    img, mask = G.g25d_workload()
    got, ref = _solve_both("g25d", img, mask, 8)
    assert got.out_best.shape == ref.out_best.shape == (32, 32, 8)


def test_pocs_stop_grad_solve_matches_jax():
    img, mask = G.lines()
    got, ref = _solve_both("gpocs", img, mask, 1)
    for f in ("df", "eps"):
        np.testing.assert_allclose(getattr(got.history, f)[:2], getattr(ref.history, f)[:2],
                                   rtol=1e-5)


def test_scripts_and_examples_import_no_jax():
    from test_torch_imports import _imported_modules
    files = [REPO / "scripts" / "torch_golden.py", REPO / "examples" / "torch_poc_2d.py",
             REPO / "examples" / "torch_poc_3d.py", REPO / "examples" / "torch_field_scale.py"]
    bad = {f.name: sorted(set(_imported_modules(f)) & FORBIDDEN) for f in files}
    assert not any(bad.values()), f"forbidden imports: {bad}"
    assert "deep_prior_interpolation_tpu_torch" in set(_imported_modules(files[0]))
