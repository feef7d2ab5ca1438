"""The port's spatial mesh, shard boundaries, state placement and
collectives (parallel/spatial.py) on the CPU, and what a sharded solve
refuses for now (ROADMAP A.13c).

* ``make_spatial_mesh`` raises past the devices that exist (the JAX one
  truncates) and takes a list of one repeated device (``[cpu] * 8``, as the
  JAX tests' 8 virtual CPU devices).
* Boundaries lie on multiples of 2^L planes, even and uneven; a short
  axis and an axis that is not spatial raise ``ValueError`` (the JAX
  module asserts, or shards the batch dim of a negative axis).
* ``shard_solver_state`` splits the volume entries as the JAX
  ``tests/test_spatial.py::test_placement_specs`` places them and leaves
  parameters and trackers whole.
* The three collectives against the unsharded ops, forward and backward,
  and under float64 ``gradcheck``."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.models.blocks import upsample
from deep_prior_interpolation_tpu_torch.ops.conv_vjp import conv_halo
from deep_prior_interpolation_tpu_torch.parallel import make_spatial_mesh, shard_solver_state
from deep_prior_interpolation_tpu_torch.parallel import spatial as S

torch.set_num_threads(1)
CPU = torch.device("cpu")


def test_the_mesh_takes_repeats_and_raises_past_the_devices(monkeypatch):
    assert make_spatial_mesh(8, [CPU] * 8) == [CPU] * 8
    assert make_spatial_mesh(2, [CPU] * 8) == [CPU] * 2
    with pytest.raises(RuntimeError, match="9 devices"):
        make_spatial_mesh(9, [CPU] * 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert make_spatial_mesh(4) == [torch.device("cuda", i) for i in range(4)]
    with pytest.raises(RuntimeError, match="8 CUDA devices was asked for and 4 exist"):
        make_spatial_mesh(8)


@pytest.mark.parametrize("extent,n,block,want", [
    (32, 8, 2, [(4 * i, 4 * i + 4) for i in range(8)]),
    (24, 4, 4, [(0, 8), (8, 16), (16, 20), (20, 24)]),
    (128, 4, 16, [(0, 32), (32, 64), (64, 96), (96, 128)]),
    (48, 5, 8, [(0, 16), (16, 24), (24, 32), (32, 40), (40, 48)]),
])
def test_boundaries_lie_on_whole_blocks(extent, n, block, want):
    got = S.shard_bounds(extent, n, block)
    assert got == want
    assert all(a % block == 0 and b % block == 0 for a, b in got)


def test_a_short_axis_and_a_bad_axis_raise_value_errors():
    with pytest.raises(ValueError, match="at most 4 shards"):
        S.shard_bounds(16, 8, 4)
    with pytest.raises(ValueError, match="whole number of 4-plane blocks"):
        S.shard_bounds(18, 2, 4)
    small = {"img": torch.zeros(1, 1, 24, 4)}   # x = 4 < 8 shards
    with pytest.raises(ValueError, match="at most 4 shards"):
        shard_solver_state([CPU] * 8, 1, small, {})
    for axis in (2, -1):
        with pytest.raises(ValueError, match="spatial_axis"):
            shard_solver_state([CPU] * 2, axis, small, {})
    img = np.zeros((24, 32, 1), np.float32)
    cfg = Config(datadim="2d", epochs=2, inputdepth=4, filters=[8, 16], skip=[4])
    with pytest.raises(ValueError, match="spatial_axis"):
        DIPSolver(cfg, device="cpu").solve(img, img, spatial_mesh=[CPU] * 2, spatial_axis=2)


def test_shard_solver_state_splits_the_volume_entries():
    # a (20, 30) patch padded to (24, 32): the canvas splits at multiples of
    # 4, the data and the best output at the same planes less the padding
    g = torch.Generator().manual_seed(0)
    base = torch.randn(1, 4, 24, 32, generator=g)
    img, mask = torch.randn(1, 1, 20, 30, generator=g), torch.ones(1, 1, 20, 30)
    state = {"out_best": torch.randn(1, 1, 20, 30, generator=g), "loss_min": torch.tensor(1.0),
             "flat": object()}
    data, placed = shard_solver_state([CPU] * 4, 1, {"img": img, "mask": mask,
                                                     "base_input": base}, state, block=4)
    assert [t.shape[3] for t in data["base_input"]] == [8, 8, 8, 8]
    # the volume's 30 columns start at column 1 of the 32
    assert [t.shape[3] for t in data["img"]] == [7, 8, 8, 7]
    assert torch.equal(torch.cat(data["base_input"], 3), base)
    assert torch.equal(torch.cat(data["img"], 3), img)
    assert torch.equal(torch.cat(placed["out_best"], 3), state["out_best"])
    assert all(t.is_contiguous() for t in data["img"] + data["base_input"])
    assert placed["loss_min"] is state["loss_min"] and placed["flat"] is state["flat"]
    layout = S.SpatialLayout([CPU] * 4, 1, (24, 32), (20, 30), 4)
    assert layout.crops == [(0, 7), (7, 15), (15, 23), (23, 30)]
    assert layout.local_crops == [(1, 7), (0, 8), (0, 8), (0, 7)]


def _shards(t, n, dim=3):
    return list(torch.chunk(t, n, dim=dim))


def test_the_all_reduce_sums_in_shard_order_forward_and_backward():
    xs = [torch.randn(2, 3, dtype=torch.float64, requires_grad=True) for _ in range(3)]
    outs = S.all_reduce(xs)
    want = (xs[0] + xs[1]) + xs[2]
    assert all(torch.equal(o, want) for o in outs)
    assert len({o.data_ptr() for o in outs}) == 3   # a copy a shard
    assert torch.autograd.gradcheck(lambda *t: S._AllReduce.apply(*t), tuple(xs))


def _padded(x, lo, hi, edge):
    """The last dim padded with zeros or copies of its edge planes."""
    first, last = x[..., :1], x[..., -1:]
    if edge == "zero":
        first, last = torch.zeros_like(first), torch.zeros_like(last)
    return torch.cat([first] * lo + [x] + [last] * hi, dim=-1)


@pytest.mark.parametrize("edge", ["zero", "replicate"])
def test_the_halo_exchange_against_the_whole_volume(edge):
    x = torch.randn(1, 2, 5, 12, dtype=torch.float64)
    pad = _padded(x, 1, 2, edge)
    shards = S.halo_exchange(_shards(x, 3), 1, 1, 2, edge)
    for i, sh in enumerate(shards):   # each shard's 4 planes and 1 + 2 of its halo
        assert torch.equal(sh, pad[..., 4 * i:4 * i + 7])
    xs = [t.clone().requires_grad_() for t in _shards(x, 3)]
    assert torch.autograd.gradcheck(lambda *t: S._HaloExchange.apply(1, 1, 2, edge, *t),
                                    tuple(xs))
    # the backward adds each halo plane's gradient back where it came from
    gs = [torch.randn(sh.shape, dtype=torch.float64) for sh in shards]
    whole = x.clone().requires_grad_()
    ref = _padded(whole, 1, 2, edge)
    (dx_ref,) = torch.autograd.grad(sum((ref[..., 4 * i:4 * i + 7] * g).sum()
                                        for i, g in enumerate(gs)), whole)
    got = torch.autograd.grad(S.halo_exchange(xs, 1, 1, 2, edge), xs, gs)
    torch.testing.assert_close(torch.cat(got, 3), dx_ref, rtol=1e-12, atol=1e-12)


def test_the_replicate_sums_the_shards_gradients():
    p = torch.randn(4, dtype=torch.float64, requires_grad=True)
    q = torch.randn(2, 3, dtype=torch.float64, requires_grad=True)
    reps = S._Replicate.apply((CPU,) * 3, p, q)
    assert len(reps) == 6 and all(torch.equal(r, p) for r in reps[0::2])
    assert torch.autograd.gradcheck(lambda a, b: S._Replicate.apply((CPU,) * 3, a, b), (p, q))


def test_a_halo_conv_and_the_linear_upsample_on_shards_are_the_whole_ones():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 3, 6, 8, 12, dtype=torch.float64, generator=g)
    w = torch.randn(4, 3, 3, 3, 3, dtype=torch.float64, generator=g)
    cot = torch.randn(1, 4, 6, 8, 12, dtype=torch.float64, generator=g)
    xs = [t.clone().requires_grad_() for t in _shards(x, 3, dim=4)]
    wl = w.clone().requires_grad_()
    ys = [conv_halo(e, wl, 2, 1) for e in S.halo_exchange(xs, 2, 1, 1, "zero")]
    whole = x.clone().requires_grad_()
    wr = w.clone().requires_grad_()
    y = F.conv3d(whole, wr, padding=1)
    torch.testing.assert_close(torch.cat(ys, 4), y, rtol=1e-12, atol=1e-12)
    got = torch.autograd.grad(sum((a * b).sum() for a, b in zip(ys, _shards(cot, 3, 4))),
                              xs + [wl])
    ref = torch.autograd.grad((y * cot).sum(), [whole, wr])
    torch.testing.assert_close(torch.cat(got[:3], 4), ref[0], rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(got[3], ref[1], rtol=1e-10, atol=1e-10)
    # the x2 linear upsample: a replicate halo plane each side, 2 output
    # planes cropped each side
    ups = [upsample(e, 2, "linear").narrow(4, 2, 8)
           for e in S.halo_exchange(xs, 2, 1, 1, "replicate")]
    torch.testing.assert_close(torch.cat(ups, 4), upsample(x, 2, "linear"),
                               rtol=1e-12, atol=1e-12)


# what a sharded solve still refuses: ROADMAP A.13c items 8-11
REFUSED = [
    ({"opt_over": "net,input"}, "opt_over"),
    ({"opt_over": "input", "pocs": True}, "opt_over"),
    ({"phase_space": True, "phase_levels": 1}, "phase space"),
    ({"phase_space": True, "phase_levels": -1}, "phase space"),
    ({"vmap_conv_mode": "tapmm"}, "tapmm"),
    ({"vmap_conv_mode": "tapmm", "remat": True}, "tapmm"),
    ({"net": "skip"}, "--net skip"),
    ({"net": "unet", "filters": [4, 8, 8, 8, 8], "skip": [4, 4, 4, 4]}, "--net unet"),
    ({"net": "part"}, "--net part"),
    ({"net": "attmultiunet"}, "--net attmultiunet"),
]


def test_each_a13c_item_is_refused_when_the_solve_starts(monkeypatch):
    img = np.zeros((8, 16, 1), np.float32)
    drawn = []
    real = S.SpatialLayout.__init__
    monkeypatch.setattr(S.SpatialLayout, "__init__",
                        lambda self, *a, **k: drawn.append(1) or real(self, *a, **k))
    for kw, what in REFUSED:
        cfg = Config(**{**dict(datadim="2d", epochs=2, inputdepth=4, filters=[4, 8], skip=[4]),
                        **kw})
        with pytest.raises(NotImplementedError, match=f"{what}.*ROADMAP A.13c"):
            DIPSolver(cfg, device="cpu").solve(img, img, spatial_mesh=[CPU] * 2)
    assert not drawn
