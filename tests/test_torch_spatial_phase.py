"""Phase space over spatial shards (parallel/spatial.py, ROADMAP A.13c item
9): the sharded solve of a phase net against the unsharded one on the CPU,
over ``[cpu] * 2`` and ``[cpu] * 4``, 2D and 3D, ``phase_levels`` 1, 2 and
all, ``phase_deep_levels`` 1, nearest and linear upsampling, remat; the
sharded step against the net in float64; and each shard-aware piece alone
(the entry conv, the exit conv with its (1, 0) halo, the upsample into
phase layout, the phase ``Norm``) with its gradients.

The solves are held as tests/test_torch_spatial_options.py holds the
options: 3 iterations, losses rtol 1e-4, the best output within 1e-4 of
its max (measured: 2e-7 and 9e-6). The 3D test net amplifies rounding
through Adam: one entry of a conv kernel's gradient that a Norm nearly
cancels (3e-3 of the kernel's largest, all rounding) flips its sign over 2
shards, and Adam's first step moves it by 2 lr, so at lr 1e-3 the loss
parts by 2.6e-4 after one update and the output by 0.3 of its max after
three. The unsharded plain and phase nets of the same parameters part the
same way, and the float64 step below holds the sharded gradients to 1e-12
of the largest, so the 3D solves run at ``lr=0``: the same net and canvas
under three noise draws, each iteration's forward held. The 2D solves run
at the default rate."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.engine.solver import _crop_center, net_multiple
from deep_prior_interpolation_tpu_torch.models import get_net, init_weights
from deep_prior_interpolation_tpu_torch.models.blocks import Norm
from deep_prior_interpolation_tpu_torch.ops import losses as L
from deep_prior_interpolation_tpu_torch.ops import phase_space as ps
from deep_prior_interpolation_tpu_torch.parallel import spatial as S

torch.set_num_threads(1)
CPU = torch.device("cpu")
SHARDS = (2, 4)
F64 = torch.float64


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
                           gain=1.0, upsample="linear")),
    "3d": (volume, dict(datadim="3d", inputdepth=4, filters=[4, 8], skip=[4], gain=1.0,
                        upsample="linear", lr=0.0)),
}


def cfg(dim, **kw):
    return Config(**{**PROBLEMS[dim][1], "epochs": 3, "scan_chunk": 3, "phase_space": True,
                     **kw})


def held(dim, **kw):
    """The sharded solves of ``cfg(dim, **kw)`` against the unsharded one:
    losses rtol 1e-4, best output within 1e-4 of its max, the same canvas."""
    c = cfg(dim, **kw)
    img, mask = PROBLEMS[dim][0]()
    ref = DIPSolver(c, device="cpu").solve(img, mask, seed=0)
    got = {n: DIPSolver(c, device="cpu").solve(img, mask, seed=0, spatial_mesh=[CPU] * n)
           for n in SHARDS}
    for res in got.values():
        np.testing.assert_allclose(res.history.loss, ref.history.loss, rtol=1e-4)
        np.testing.assert_allclose(res.out_best, ref.out_best, rtol=0,
                                   atol=1e-4 * float(np.abs(ref.out_best).max()))
        np.testing.assert_array_equal(res.noise, ref.noise)
        assert res.iters_run == ref.iters_run == 3
    return ref, got


@pytest.mark.parametrize("dim", ["2d", "3d"])
@pytest.mark.parametrize("levels", [1, 2, -1])
def test_phase_levels_over_shards(dim, levels):
    ref, _ = held(dim, phase_levels=levels)
    plain = DIPSolver(Config(**{**PROBLEMS[dim][1], "epochs": 1}), device="cpu").solve(
        *PROBLEMS[dim][0](), seed=0)
    # the phase net is the plain net, up to rounding
    np.testing.assert_allclose(ref.history.loss[0], plain.history.loss[0], rtol=1e-5)


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_deep_phase_levels_and_nearest_upsampling_over_shards(dim, monkeypatch):
    seen = []
    real = ps.space_to_depth
    monkeypatch.setattr(S, "space_to_depth", lambda x: seen.append(x.shape) or real(x))
    held(dim, phase_levels=-1 if dim == "2d" else 1, phase_deep_levels=1,
         upsample="nearest")
    assert seen   # resolution 0 at depth 2: blocked again on every shard


@pytest.mark.parametrize("dim", ["2d", "3d"])
def test_remat_walks_the_phase_blocks_again_and_is_bit_equal(dim, monkeypatch):
    calls = [0]
    real = S._HaloExchange.forward

    def spy(ctx, *a):
        calls[0] += 1
        return real(ctx, *a)
    monkeypatch.setattr(S._HaloExchange, "forward", staticmethod(spy))
    img, mask = PROBLEMS[dim][0]()
    runs = {}
    for remat in (False, True):
        calls[0] = 0
        runs[remat] = DIPSolver(cfg(dim, phase_levels=-1, remat=remat, dropout=0.1),
                                device="cpu").solve(img, mask, seed=0, spatial_mesh=[CPU] * 2)
        runs[remat].halos = calls[0]
    assert runs[True].halos > runs[False].halos
    np.testing.assert_array_equal(runs[True].history.loss, runs[False].history.loss)
    np.testing.assert_array_equal(runs[True].out_best, runs[False].out_best)
    held(dim, phase_levels=-1, remat=True)


@pytest.mark.parametrize("kw,n,padded,spatial,axis", [
    (dict(datadim="2d", filters=[8, 16, 32], skip=[4, 4], phase_levels=-1,
          phase_deep_levels=1, upsample="nearest"), 4, (24, 32), (24, 30), 1),
    (dict(datadim="3d", filters=[4, 8], skip=[4], phase_levels=2, phase_deep_levels=1,
          upsample="linear"), 2, (16, 16, 8), (14, 13, 8), 0),
])
def test_the_sharded_phase_step_is_the_net_in_float64(kw, n, padded, spatial, axis):
    c = Config(inputdepth=4, phase_space=True, **kw)
    net = get_net(c, 1).double()
    init_weights(net, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(4)
    x = 0.1 * torch.randn((1, 4) + padded, generator=g, dtype=F64)
    img = torch.randn((1, 1) + spatial, generator=g, dtype=F64)
    mask = (torch.rand((1, 1) + spatial, generator=g) > 0.5).double()
    params = list(net.parameters())
    y = _crop_center(net(x), spatial)
    loss = L.masked_fit([y], [img], [mask], "mae")
    ref = torch.autograd.grad(loss, params)
    layout = S.SpatialLayout([CPU] * n, axis, padded, spatial, net_multiple(c))
    step = S.ShardedStep(net, layout)
    data = {"img": layout.split(img, cropped=True), "mask": layout.split(mask, cropped=True)}
    outs, got_loss, _ = step.loss_terms(step(layout.split(x)), data,
                                        SimpleNamespace(fused_loss=False, loss="mae"), F64, CPU)
    grads = torch.autograd.grad(got_loss, params)
    out, y = torch.cat([o.detach() for o in outs], 2 + axis), y.detach()
    assert float((out - y).abs().max()) <= 1e-12 * float(y.abs().max())
    assert abs(float(got_loss.detach()) - float(loss.detach())) <= 1e-12 * float(loss.detach())
    top = max(float(b.abs().max()) for b in ref)
    for (name, _), a, b in zip(net.named_parameters(), grads, ref):
        assert float((a - b).abs().max()) <= 1e-12 * top, name


def shards_of(x, n, axis=2):
    return list(x.split(x.shape[2 + axis] // n, 2 + axis))


def grads_of(ys, cot, inputs, axis=2):
    total = sum((a * b).sum() for a, b in zip(ys, shards_of(cot, len(ys), axis)))
    return torch.autograd.grad(total, inputs)


@pytest.mark.parametrize("piece", ["entry", "exit", "upsample", "norm"])
def test_each_phase_piece_over_shards_with_its_gradients(piece):
    """Over 4 shards along the last axis of a 3D phase net, float64: the
    piece's output shards concatenated are the unsharded piece's output,
    and the input's (and the weight's) gradients are its gradients."""
    g = torch.Generator().manual_seed(7)
    net = get_net(Config(datadim="3d", inputdepth=3, filters=[4, 8], skip=[4],
                         phase_space=True, phase_levels=-1), 1).double()
    init_weights(net, torch.Generator().manual_seed(1))
    step = S.ShardedStep(net, S.SpatialLayout([CPU] * 4, 2, (8, 8, 16), (8, 8, 16), 4))
    blk = net.get_submodule(net.block0)
    conv = {"entry": blk.ConvNormAct_0.Conv_0,
            "exit": net.get_submodule(net.levels[1]["down"])}.get(piece)
    shape = {"entry": (1, 3, 8, 8, 16), "upsample": (1, 5, 4, 4, 8),
             "exit": (1, 8 * conv.kernel.shape[1], 4, 4, 8) if piece == "exit" else None,
             "norm": (1, 8 * 6, 4, 4, 8)}[piece]
    x = torch.randn(shape, generator=g, dtype=F64, requires_grad=True)
    xs = [t.detach().requires_grad_() for t in shards_of(x, 4)]
    params = [x]
    if conv is not None:
        step._reps = {id(p): [p] * 4 for p in conv.parameters()}
        ys, y = step._conv(conv, xs), conv(x)
        params += [conv.kernel, conv.bias]
    elif piece == "upsample":
        net.upsample_mode = "linear"
        ys, y = step._upsample(xs, into_phase=True), ps.upsample_into_phase(x, "linear")
    else:
        norm = Norm(6, phase=8).double()
        with torch.no_grad():
            norm.scale.uniform_(0.5, 1.5, generator=g)
            norm.bias.uniform_(-0.5, 0.5, generator=g)
        step._reps = {id(p): [p] * 4 for p in norm.parameters()}
        ys, y = step._norm(norm, xs), norm(x)
        params += [norm.scale, norm.bias]
    torch.testing.assert_close(torch.cat(ys, 4), y, rtol=1e-12, atol=1e-12)
    cot = torch.randn(y.shape, generator=g, dtype=F64)
    got = grads_of(ys, cot, xs + params[1:])
    ref = torch.autograd.grad((y * cot).sum(), params)
    torch.testing.assert_close(torch.cat(got[:4], 4), ref[0], rtol=1e-11, atol=1e-11)
    for a, b in zip(got[4:], ref[1:]):   # the parameter gradients summed over the shards
        torch.testing.assert_close(a, b, rtol=1e-11, atol=1e-11)
    if piece == "exit":   # a left halo of one phase plane, none on the right
        assert conv.phase_in and not conv.phase_out and ps.phase_paddings(3, 2) == (1, 0)


def test_the_shards_lie_on_the_phase_net_s_block():
    # 2 levels, every resolution phased: resolution 1 at depth 1 needs
    # whole 4-plane blocks, so a 16-plane axis holds 4 of them; over 8
    # shards (refused before uneven shards) each shard holds 2 planes, the
    # phase grids' shards 1 or none, and the solve is the unsharded one's
    c = Config(datadim="2d", inputdepth=4, filters=[8, 16], skip=[4], phase_space=True,
               phase_levels=-1, epochs=1, scan_chunk=1)
    assert net_multiple(c) == 4
    assert net_multiple(dataclasses.replace(c, phase_space=False)) == 2
    img = np.ones((8, 16, 1), np.float32)
    res = DIPSolver(c, device="cpu").solve(img, img, spatial_mesh=[CPU] * 4)
    assert np.all(np.isfinite(res.out_best))
    img, mask = one_patch()
    img, mask = img[:8, :16], mask[:8, :16]
    ref = DIPSolver(c, device="cpu").solve(img, mask, seed=0)
    got = DIPSolver(c, device="cpu").solve(img, mask, seed=0, spatial_mesh=[CPU] * 8)
    np.testing.assert_allclose(got.history.loss, ref.history.loss, rtol=1e-5)
    np.testing.assert_allclose(got.out_best, ref.out_best, rtol=0,
                               atol=1e-5 * float(np.abs(ref.out_best).max()))
    with pytest.raises(ValueError, match="phase level 1 needs spatial dims divisible by 4"):
        DIPSolver(dataclasses.replace(c, pad_multiple=2), device="cpu").solve(
            np.ones((6, 16, 1), np.float32), np.ones((6, 16, 1), np.float32),
            spatial_mesh=[CPU] * 2)
