"""The port's patch batches (parallel/mesh.py) against the port's own solo
solves on the CPU: lane i of a batch computes what ``DIPSolver.solve(seed =
cfg.seed + i)`` computes (the same draws; only the grouped ops round
differently), with the options, the conv formulations, 3D phase space with
remat, per-lane early stop, padding to the mesh, POCS and snapshots; and
each lane's setup does not depend on the lanes beside it. The configs are
the tiny ones of tests/test_parallel.py."""
import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.engine import (StepSettings, pad_multiple_for,
                                                       padded_spatial)
from deep_prior_interpolation_tpu_torch.ops import conv_vjp
from deep_prior_interpolation_tpu_torch.parallel import (make_mesh, setup_patch_batch,
                                                         solve_patches_batched)

torch.set_num_threads(1)


def make_patches(n, nt=24, nx=16, seed=0):
    rng = np.random.RandomState(seed)
    t = np.linspace(0, 1, nt)[:, None]
    x = np.linspace(0, 1, nx)[None, :]
    out = []
    for i in range(n):
        img = np.sin(2 * np.pi * ((2 + i) * t + 2 * x)).astype(np.float32)[..., None]
        mask = np.repeat((rng.rand(1, nx) > 0.5).astype(np.float32), nt, 0)[..., None]
        out.append({"image": img, "mask": mask, "name": str(i)})
    return out


def make_patches_3d(n, nt=16, nx=8, ny=8, seed=0):
    """Half structured (keeps improving), half noise (dries up early)."""
    rng = np.random.RandomState(seed)
    t = np.linspace(0, 1, nt)[:, None, None]
    x = np.linspace(0, 1, nx)[None, :, None]
    y = np.linspace(0, 1, ny)[None, None, :]
    out = []
    for i in range(n):
        if i % 2 == 0:
            img = np.sin(2 * np.pi * ((2 + i) * t + 2 * x + y)).astype(np.float32)
        else:
            img = rng.randn(nt, nx, ny).astype(np.float32)
        mask = np.repeat((rng.rand(1, nx, ny) > 0.4).astype(np.float32), nt, 0)
        out.append({"image": img[..., None], "mask": mask[..., None], "name": str(i)})
    return out


def cfg(**kw):
    base = dict(datadim="2d", epochs=20, inputdepth=4, filters=[8, 16], skip=[4],
                scan_chunk=10, gain=1.0)
    base.update(kw)
    return Config(**base)


def cfg3d(**kw):
    base = dict(datadim="3d", epochs=9, inputdepth=4, filters=[8, 16], skip=[4],
                scan_chunk=3, gain=1.0, upsample="linear", phase_space=True,
                phase_levels=1, remat=True)
    base.update(kw)
    return Config(**base)


def solo(c, patch, i, **kw):
    return DIPSolver(c, device="cpu").solve(patch["image"], patch["mask"], seed=c.seed + i,
                                            **kw)


@pytest.mark.parametrize("kw", [
    dict(), dict(fused_loss=True), dict(dropout=0.1, param_noise=True),
    dict(virtual_input=True), dict(opt_over="net,input"),
    dict(data_forgetting_factor=5, reduce_lr=True, lr_patience=2, lr_thresh=0.5),
])
def test_lane_matches_its_solo_solve(kw):
    """float32: the first 5 losses to rtol 1e-4, the endpoint as
    tests/test_parallel.py holds it, the canvas of a lane equal to the solo
    solve's (but under input optimisation, which moves it)."""
    c = cfg(**kw)
    patches = make_patches(2)
    results = solve_patches_batched(c, DIPSolver(c, device="cpu"), patches)
    assert len(results) == 2
    for i, (patch, r) in enumerate(zip(patches, results)):
        seq = solo(c, patch, i)
        np.testing.assert_allclose(r.history.loss[:5], seq.history.loss[:5], rtol=1e-4,
                                   atol=1e-7)
        assert abs(r.history.loss[-1] - seq.history.loss[-1]) < 0.5 * seq.history.loss[0]
        assert r.iters_run == seq.iters_run == 20 and not r.stopped_early
        assert r.out_best.shape == seq.out_best.shape and np.all(np.isfinite(r.out_best))
        assert r.noise.shape == seq.noise.shape
        if "opt_over" not in kw:
            np.testing.assert_array_equal(r.noise, seq.noise)
        assert r.params.keys() == seq.params.keys()


def test_tapmm_lanes_match_the_solo_conv_solve():
    """vmap_conv_mode="tapmm" (one batched float32 product a tap) against
    the solo cuDNN-formulation solve, rtol 1e-3 as the JAX package's test;
    the conv formulation is restored after the solve."""
    c = cfg(vmap_conv_mode="tapmm")
    patches = make_patches(2)
    batched = solve_patches_batched(c, DIPSolver(c, device="cpu"), patches)
    assert conv_vjp.current_conv_impl() == "conv"
    for i, (patch, r) in enumerate(zip(patches, batched)):
        seq = solo(cfg(), patch, i)
        np.testing.assert_allclose(r.history.loss[:5], seq.history.loss[:5], rtol=1e-3,
                                   atol=1e-6)
        assert np.all(np.isfinite(r.out_best))


def test_3d_phase_remat_over_a_mesh_matches_solo():
    """3D patches with phase space and remat over a mesh of 2 CPU shards,
    3 chunks: each lane reproduces its solo solve (step 0 to rtol 1e-6,
    the first 3 steps to rtol 1e-4)."""
    c = cfg3d(mesh_shape=2)
    patches = make_patches_3d(4)
    results = solve_patches_batched(c, DIPSolver(c, device="cpu"), patches)
    for i, (patch, r) in enumerate(zip(patches, results)):
        seq = solo(c, patch, i)
        np.testing.assert_allclose(r.history.loss[0], seq.history.loss[0], rtol=1e-6)
        np.testing.assert_allclose(r.history.loss[:3], seq.history.loss[:3], rtol=1e-4)
        assert r.out_best.shape == seq.out_best.shape and np.all(np.isfinite(r.out_best))


def test_divergent_early_stops_freeze_their_lanes():
    """Lanes stop at different iterations over several chunks: each lane's
    iterations equal its solo solve's, and a frozen lane's history is not
    extended."""
    c = cfg3d(earlystop_patience=2, earlystop_min_delta=1.0, phase_space=False, remat=False)
    patches = make_patches_3d(4)
    results = solve_patches_batched(c, DIPSolver(c, device="cpu"), patches,
                                    mesh=make_mesh(2, [torch.device("cpu")] * 2))
    iters = []
    for i, (patch, r) in enumerate(zip(patches, results)):
        seq = solo(c, patch, i)
        assert r.iters_run == seq.iters_run, (i, r.iters_run, seq.iters_run)
        assert r.stopped_early == seq.stopped_early
        assert len(r.history.loss) == r.iters_run
        iters.append(r.iters_run)
    assert len(set(iters)) > 1, f"early stops did not diverge: {iters}"


def test_a_batch_is_padded_to_the_mesh():
    """5 patches on a mesh of 4: padded by repeating the last patch, 5
    results, each lane as its solo solve."""
    c = cfg(epochs=6, scan_chunk=6, mesh_shape=4)
    patches = make_patches(5)
    results = solve_patches_batched(c, DIPSolver(c, device="cpu"), patches)
    assert len(results) == 5
    for i in (0, 4):
        seq = solo(c, patches[i], i)
        np.testing.assert_allclose(results[i].history.loss, seq.history.loss, rtol=1e-4)


def test_pocs_lanes():
    """DIP + POCS (FFT projection, adaptive eps) in the lane step."""
    c = cfg(epochs=6, scan_chunk=2, pocs=True)
    patches = make_patches(3)
    results = solve_patches_batched(c, DIPSolver(c, device="cpu"), patches)
    for i, (patch, r) in enumerate(zip(patches, results)):
        assert np.all(np.isfinite(r.history.loss)) and np.all(np.isfinite(r.history.eps))
        assert r.pocs is not None and r.pocs.shape == r.out_best.shape
        seq = solo(c, patch, i)
        np.testing.assert_allclose(r.history.eps[:3], seq.history.eps[:3], rtol=1e-4)
        np.testing.assert_allclose(r.pocs, seq.pocs, rtol=1e-3, atol=1e-4)


def test_snapshots_of_each_lane():
    c = cfg(save_every=10, scan_chunk=5)
    patches = make_patches(2)
    results = solve_patches_batched(c, DIPSolver(c, device="cpu"), patches)
    for i, (patch, r) in enumerate(zip(patches, results)):
        seq = solo(c, patch, i)
        assert sorted(r.snapshots) == sorted(seq.snapshots) == [10]
        np.testing.assert_allclose(r.snapshots[10], seq.snapshots[10], rtol=1e-3, atol=1e-4)


def test_setup_patch_batch_lane_composition_invariance():
    """Lane i's initial state does not depend on the lanes beside it: lane 2
    set up alone (seed cfg.seed + 2) equals lane 2 of a batch of 4."""
    c = cfg()
    patches = make_patches(4)
    solver = DIPSolver(c, device="cpu")
    spatial = tuple(patches[0]["image"].shape[:-1])
    padded = padded_spatial(spatial, pad_multiple_for(c))
    input_shape = (1, c.inputdepth) + padded
    s = StepSettings.from_config(c, spatial, input_shape=input_shape)
    imgs = np.stack([p["image"] for p in patches])
    masks = np.stack([p["mask"] for p in patches])
    st_all, data_all = setup_patch_batch(c, solver, s, imgs, masks, padded, input_shape)
    st_2, data_2 = setup_patch_batch(c, solver, s, imgs[2:3], masks[2:3], padded, input_shape,
                                     seeds=np.array([c.seed + 2]))
    assert torch.equal(st_2["flat"].flat[0], st_all["flat"].flat[2])
    for k, v in data_2.items():
        if v is not None and k != "forget_w":
            assert torch.equal(v[0], data_all[k][2]), k
    for k in ("lr", "loss_min", "done", "es_bad"):
        assert torch.equal(st_2[k][0], st_all[k][2])
    assert torch.equal(st_2["gens"][0]["noise"].get_state(),
                       st_all["gens"][2]["noise"].get_state())
