"""The zoo nets over spatial shards (parallel/spatial_zoo.py, ROADMAP A.13c
item 11) against the unsharded solve on the CPU: the skip net, the U-Net,
the partial-conv U-Net and the attention MultiRes U-Net over ``[cpu] * 2``
and, where the test volume holds the blocks, ``[cpu] * 4``; dropout,
bfloat16 and linear upsampling (skip and U-Net), 2D and 3D; the CLI path;
and each walk against its net in float64 with its gradients.

The solves are held as tests/test_torch_spatial_options.py holds the
MulResUnet's options: 3 iterations, losses rtol 1e-4, the best output
within 1e-4 of its max (measured: 1.5e-7 and 1.5e-6). A bfloat16 solve
rounds its sums at other places over shards, and Adam's sign-like first
steps amplify that (2e-4 of the loss after one update, 0.3 of the output's
max after three), so it runs at ``lr=0``: the same net under three noise
and dropout draws, each iteration's output held to one bfloat16 rounding.
The float64 walks hold each net's sharded gradients to 1e-12 of the
largest."""
import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu_torch import Config, DIPSolver, cli
from deep_prior_interpolation_tpu_torch.config import parse_arguments
from deep_prior_interpolation_tpu_torch.data import dataset_path
from deep_prior_interpolation_tpu_torch.engine.solver import (_crop_center, pad_multiple_for,
                                                              shard_block)
from deep_prior_interpolation_tpu_torch.io import load_run
from deep_prior_interpolation_tpu_torch.models import get_net, init_weights, set_dropout_generator
from deep_prior_interpolation_tpu_torch.ops import losses as L
from deep_prior_interpolation_tpu_torch.parallel import spatial as S

torch.set_num_threads(1)
CPU = torch.device("cpu")
F64 = torch.float64
LINES = os.path.dirname(dataset_path("lines/original.npy"))


def patch(nt, nx):
    rng = np.random.RandomState(0)
    t = np.linspace(0, 1, nt)[:, None]
    x = np.linspace(0, 1, nx)[None, :]
    img = np.sin(2 * np.pi * (3 * t + 2 * x)).astype(np.float32)[..., None]
    mask = np.repeat((rng.rand(1, nx) > 0.5).astype(np.float32), nt, 0)[..., None]
    return img, mask


def volume(nt, nx, ny):
    rng = np.random.RandomState(1)
    t = np.linspace(0, 1, nt)[:, None, None]
    x = np.linspace(0, 1, nx)[None, :, None]
    y = np.linspace(0, 1, ny)[None, None, :]
    img = np.sin(2 * np.pi * (2 * t + x + y)).astype(np.float32)[..., None]
    mask = np.repeat((rng.rand(1, nx, ny) > 0.4).astype(np.float32), nt, 0)[..., None]
    return img, mask


# each net's test problem: the patch, and the configuration (sharded axis 1)
NETS = {
    "skip": (lambda: patch(24, 32), dict(datadim="2d", net="skip", filters=[8, 16], skip=[4])),
    "skip3d": (lambda: volume(8, 16, 8), dict(datadim="3d", net="skip", filters=[4, 8], skip=[4],
                                              upsample="linear")),
    "unet": (lambda: patch(16, 32), dict(datadim="2d", net="unet", filters=[4, 4, 8, 8, 8])),
    "unet3d": (lambda: volume(16, 32, 16), dict(datadim="3d", net="unet",
                                                filters=[2, 2, 4, 4, 4])),
    "part": (lambda: patch(32, 64), dict(datadim="2d", net="part", filters=[8, 16], skip=[4])),
    "part3d": (lambda: volume(8, 64, 8), dict(datadim="3d", net="part", filters=[4, 8],
                                              skip=[4])),
    "att": (lambda: patch(24, 32), dict(datadim="2d", net="attmultiunet", filters=[8, 16],
                                        skip=[4])),
}


def cfg(net, **kw):
    return Config(**{**NETS[net][1], "inputdepth": 4, "gain": 1.0, "epochs": 3,
                     "scan_chunk": 3, **kw})


def held(net, shards=(2,), **kw):
    """The sharded solves of ``cfg(net, **kw)`` against the unsharded one:
    losses rtol 1e-4, the best output within 1e-4 of its max, the same
    canvas. A bfloat16 solve runs at ``lr=0`` with a snapshot an
    iteration, and each iteration's output is held to one bfloat16
    rounding (2^-8 of its max) instead of the best one, which near-tied
    losses may pick from another iteration."""
    c = cfg(net, **kw)
    bf16 = c.dtype == "bfloat16"
    if bf16:
        c = dataclasses.replace(c, lr=0.0, save_every=1)
    img, mask = NETS[net][0]()
    ref = DIPSolver(c, device="cpu").solve(img, mask, seed=0)
    for n in shards:
        got = DIPSolver(c, device="cpu").solve(img, mask, seed=0, spatial_mesh=[CPU] * n)
        np.testing.assert_allclose(got.history.loss, ref.history.loss, rtol=1e-4)
        pairs = ([(got.snapshots[k], ref.snapshots[k]) for k in ref.snapshots] if bf16
                 else [(got.out_best, ref.out_best)])
        assert pairs
        for a, b in pairs:
            np.testing.assert_allclose(a, b, rtol=0, atol=(2 ** -8 if bf16 else 1e-4)
                                       * float(np.abs(b).max()))
        np.testing.assert_array_equal(got.noise, ref.noise)
        assert got.iters_run == ref.iters_run == 3 and np.all(np.isfinite(got.history.loss))
    return ref


def test_each_net_shards_on_its_own_block():
    """A shard holds whole blocks of 2^S planes for the net's S stride-2
    steps; the padding stays the JAX package's (``pad_multiple_for``)."""
    blocks = {"skip": 4, "unet": 16, "part": 32, "att": 2}
    for net, block in blocks.items():
        c = cfg(net)
        assert shard_block(c, get_net(c, 1)) == block
        assert pad_multiple_for(c) == 2 ** (len(c.filters) - 1)
    c = Config(filters=[8, 16, 32], skip=[4, 4])
    assert shard_block(c, get_net(c, 1)) == 4


@pytest.mark.parametrize("kw", [{}, dict(upsample="linear", dropout=0.1),
                                dict(dtype="bfloat16", dropout=0.1)])
def test_the_skip_net_over_shards(kw):
    held("skip", (2, 4) if not kw else (2,), **kw)


def test_the_3d_skip_net_over_shards():
    held("skip3d", dropout=0.1)


@pytest.mark.parametrize("kw", [{}, dict(upsample="linear", dropout=0.1, dtype="bfloat16")])
def test_the_unet_over_shards(kw):
    held("unet", **kw)


def test_the_3d_unet_over_shards():
    held("unet3d", upsample="linear")


def test_the_partial_conv_unet_over_shards():
    held("part", dropout=0.1)


def test_the_3d_partial_conv_unet_over_shards():
    held("part3d")


@pytest.mark.parametrize("kw", [dict(dropout=0.1), dict(upsample="linear")])
def test_the_attention_multires_unet_over_shards(kw):
    held("att", (2, 4), **kw)


def test_the_cli_runs_a_sharded_zoo_net(tmp_path):
    """``cli.run --net unet --spatial_shards 2`` on the lines gather (its
    (170, 100) patch padded to (176, 112): 7 blocks of 16 along axis 1)
    against the same run unsharded: its bundle's losses and output."""
    runs = []
    for n in (0, 2):
        c = parse_arguments([
            "--imgdir", LINES, "--imgname", "original.npy", "--maskname", "random66.npy",
            "--datadim", "2d", "--gain", "1", "--outdir", f"r{n}", "--epochs", "2",
            "--scan_chunk", "2", "--inputdepth", "4", "--net", "unet", "--filters", "4", "4",
            "4", "4", "4", "--spatial_shards", str(n)])
        runs.append(load_run(os.path.join(cli.run(c, str(tmp_path), device="cpu"),
                                          "0_run.npz")))
    np.testing.assert_allclose(runs[1]["history"]["loss"], runs[0]["history"]["loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(runs[1]["output"], runs[0]["output"], rtol=0,
                               atol=1e-4 * float(np.abs(runs[0]["output"]).max()))


@pytest.mark.parametrize("net,n,padded,spatial,axis", [
    ("skip3d", 2, (8, 16, 8), (8, 14, 8), 1),
    ("unet3d", 2, (16, 32, 16), (16, 30, 16), 1),
    ("part", 2, (32, 64), (30, 60), 1),
    ("att", 4, (24, 32), (22, 32), 1),
])
def test_each_walk_is_its_net_in_float64(net, n, padded, spatial, axis):
    """One step of the net in float64 (the partial-conv U-Net with a random
    mask, dropout 0.1 from one generator): the walk's output and loss equal
    the net's to 1e-12 and every gradient to 1e-12 of the largest; the
    U-Net's InstanceNorm takes float32 statistics, as in the plain net, so
    it holds to 1e-7 and 1e-9."""
    c = cfg(net, dropout=0.1, upsample="linear")
    model = get_net(c, 1).double()
    init_weights(model, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(4)
    x = 0.1 * torch.randn((1, 4) + padded, generator=g, dtype=F64)
    img = torch.randn((1, 1) + spatial, generator=g, dtype=F64)
    mask = (torch.rand((1, 1) + spatial, generator=g) > 0.5).double()
    nm = (torch.rand((1, 1) + padded, generator=g) > 0.3).double().expand(1, 4, *padded)
    takes = getattr(model, "takes_mask", False)
    params = list(model.parameters())
    set_dropout_generator(model, torch.Generator().manual_seed(9))
    y = _crop_center(model(x, nm) if takes else model(x), spatial)
    loss = L.masked_fit([y], [img], [mask], "mae")
    ref = torch.autograd.grad(loss, params)
    layout = S.SpatialLayout([CPU] * n, axis, padded, spatial, shard_block(c, model))
    step = S.ShardedStep(model, layout)
    data = {"img": layout.split(img, cropped=True), "mask": layout.split(mask, cropped=True)}
    set_dropout_generator(model, torch.Generator().manual_seed(9))
    outs = step(layout.split(x), layout.split(nm) if takes else None)
    outs, got_loss, _ = step.loss_terms(outs, data, SimpleNamespace(fused_loss=False, loss="mae"),
                                        F64, CPU)
    grads = torch.autograd.grad(got_loss, params)
    out, y = torch.cat([o.detach() for o in outs], 2 + axis), y.detach()
    tol_out, tol_grad = (1e-7, 1e-9) if net.startswith("unet") else (1e-12, 1e-12)
    assert float((out - y).abs().max()) <= tol_out * float(y.abs().max())
    assert abs(float(got_loss.detach()) - float(loss.detach())) <= tol_out * float(loss.detach())
    top = max(float(b.abs().max()) for b in ref)
    for (name, _), a, b in zip(model.named_parameters(), grads, ref):
        assert float((a - b).abs().max()) <= tol_grad * top, name
