"""``DIPSolver(cfg, outchannel, device, model=...)``: a net of the caller's
in place of ``get_net(cfg, outchannel)``, as the JAX solver takes one. It
is drawn by ``init_weights`` or loaded from ``init_params`` as the built
net is, so a solve with ``model=get_net(cfg)`` is the solve without it.
Over spatial shards a given net runs on the walk that covers its class
(every library net with any of its constructor options: the skip net's
pool and Lanczos downsampling, reflection padding and per-scale mode
lists, the U-Net's deconv up path, the CBAM U-Net among them; a subclass
that keeps its base's forward takes its base's walk); a module of the
caller's own runs on the sharded walker (tests/test_torch_spatial_custom.py);
a sharded axis that is not a whole number of the net's blocks splits on
narrower blocks and solves as the unsharded net does."""
import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.models import AttentionUnet, SkipNet, UNet, get_net
from deep_prior_interpolation_tpu_torch.parallel.spatial_zoo import uncovered

torch.set_num_threads(1)
CPU = torch.device("cpu")


def patch(nt=24, nx=32):
    rng = np.random.RandomState(0)
    t = np.linspace(0, 1, nt)[:, None]
    x = np.linspace(0, 1, nx)[None, :]
    img = np.sin(2 * np.pi * (3 * t + 2 * x)).astype(np.float32)[..., None]
    mask = np.repeat((rng.rand(1, nx) > 0.5).astype(np.float32), nt, 0)[..., None]
    return img, mask


def cfg(**kw):
    return Config(**{**dict(datadim="2d", epochs=3, scan_chunk=3, inputdepth=4, gain=1.0,
                            filters=[8, 16], skip=[4]), **kw})


@pytest.mark.parametrize("net", ["multiunet", "part"])
def test_a_given_model_solves_as_the_built_one(net):
    c = cfg(net=net, dropout=0.1)
    img, mask = patch(32, 32)
    ref = DIPSolver(c, device="cpu").solve(img, mask, seed=0)
    model = get_net(c, 1)
    solver = DIPSolver(c, device="cpu", model=model)
    assert solver.model is model
    got = solver.solve(img, mask, seed=0)
    np.testing.assert_array_equal(got.history.loss, ref.history.loss)
    np.testing.assert_array_equal(got.out_best, ref.out_best)
    for k, v in ref.params.items():
        np.testing.assert_array_equal(got.params[k], v)


def test_a_given_model_is_loaded_from_init_params():
    c = cfg()
    img, mask = patch()
    first = DIPSolver(c, device="cpu").solve(img, mask, seed=0)
    init = {k: v + 0.01 for k, v in first.params.items()}
    ref = DIPSolver(c, device="cpu").solve(img, mask, seed=1, init_params=init)
    got = DIPSolver(c, device="cpu", model=get_net(c, 1)).solve(img, mask, seed=1,
                                                               init_params=init)
    np.testing.assert_array_equal(got.history.loss, ref.history.loss)


def test_a_given_skip_net_with_pool_downsampling_runs_over_shards():
    """Options ``get_net`` never sets but a walk covers: the skip net's avg
    and max pool downsampling by scale and a per-scale upsample list."""
    c = cfg(net="skip")
    img, mask = patch()

    def model():
        return SkipNet(4, 1, 2, filters=(8, 16), skip=(4,), downsample_mode=["avg", "max"],
                       upsample_mode=["nearest", "bilinear"])
    ref = DIPSolver(c, device="cpu", model=model()).solve(img, mask, seed=0)
    got = DIPSolver(c, device="cpu", model=model()).solve(img, mask, seed=0,
                                                          spatial_mesh=[CPU] * 4)
    np.testing.assert_allclose(got.history.loss, ref.history.loss, rtol=1e-4)
    np.testing.assert_allclose(got.out_best, ref.out_best, rtol=0,
                               atol=1e-4 * float(np.abs(ref.out_best).max()))


@pytest.mark.parametrize("model,what", [
    (lambda: SkipNet(4, filters=(8, 16), skip=(4,), pad="reflection"),
     r"SkipNet\(pad='reflection'\)"),
    (lambda: UNet(4, filters=(4, 4, 4, 4, 4), upsample_mode="deconv"),
     r"UNet\(upsample_mode='deconv'\)"),
    (lambda: AttentionUnet(4), "AttentionUnet"),
])
def test_a_sharded_solve_of_an_uncovered_model_is_refused(model, what):
    """Nets no walk covered before the zoo's remaining walks (``what``, the
    constructor call ROADMAP A.13c item 12 refused) run over 2 shards and
    follow the unsharded solve at iteration 0 (the CBAM U-Net's float32
    trajectory parts by 1e-3 at iteration 2 under a one-ulp change of its
    canvas, unsharded, as ROADMAP D.12's attention net does): the loss to
    rtol 1e-5, the output within 1e-3 of its max (a one-ulp change of the
    canvas moves the CBAM U-Net's own output by 2.2e-4 of its max, its
    float64 gradients by 6e-12 of the largest); a subclass of the same net
    that keeps its forward, which ROADMAP A.13c item 13 refused before the
    sharded walker, takes its base's walk: its sharded solve is the base's,
    bit for bit."""
    img, mask = patch(32, 32)
    assert uncovered(model()) is None, what
    ref = DIPSolver(cfg(epochs=1), device="cpu", model=model()).solve(img, mask, seed=0)
    got = DIPSolver(cfg(epochs=1), device="cpu", model=model()).solve(img, mask, seed=0,
                                                                      spatial_mesh=[CPU] * 2)
    np.testing.assert_allclose(got.history.loss, ref.history.loss, rtol=1e-5)
    np.testing.assert_allclose(got.out_best, ref.out_best, rtol=0,
                               atol=1e-3 * float(np.abs(ref.out_best).max()))
    mine = model()
    mine.__class__ = type(f"My{type(mine).__name__}", (type(mine),), {})
    assert uncovered(mine) is None, what
    sub = DIPSolver(cfg(epochs=1), device="cpu", model=mine).solve(img, mask, seed=0,
                                                                  spatial_mesh=[CPU] * 2)
    np.testing.assert_array_equal(sub.history.loss, got.history.loss)
    np.testing.assert_array_equal(sub.out_best, got.out_best)


def test_a_sharded_axis_of_part_blocks_is_refused():
    """The skip net of [8, 16] downsamples twice: a 34-plane axis (padded
    to the JAX package's multiple of 2), which was refused before uneven
    shards, is not a whole number of its 4-plane blocks; it splits into 17
    and 17 planes (no shard halves at every level, and its concats crop
    along the axis) and solves as the unsharded net does: the losses to
    rtol 1e-4, the output within 1e-4 of its max."""
    img, mask = patch(24, 34)
    ref = DIPSolver(cfg(net="skip"), device="cpu").solve(img, mask, seed=0)
    got = DIPSolver(cfg(net="skip"), device="cpu").solve(img, mask, seed=0,
                                                         spatial_mesh=[CPU] * 2)
    np.testing.assert_allclose(got.history.loss, ref.history.loss, rtol=1e-4)
    np.testing.assert_allclose(got.out_best, ref.out_best, rtol=0,
                               atol=1e-4 * float(np.abs(ref.out_best).max()))
