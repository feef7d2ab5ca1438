"""The sharded MulResUnet (parallel/spatial.py ``ShardedStep``) against the
unsharded port net on the CPU: the same parameters and input, the output
shards gathered and the parameters' gradients summed over the shards.

2D and 3D, nearest and linear upsampling, 2, 3 and 4 shards along the
first and the second spatial axis, even ones and uneven ones (4 shards of
the 2D net's 40 columns, 3 of the 3D net's 16 planes). float32: the
outputs to 1e-5 of the output's scale and every conv kernel's gradient to
1e-4 of its largest entry (the shards sum the Norm statistics and the
weight gradients in another order; conv biases before a Norm and Norm
scales before another Norm have gradients at rounding level and are held
only through the whole gradient vector, to 1e-4 in norm). bfloat16: the
outputs to 2^-7 of the output's scale. The wgrad kernel's padded-dy route
(``conv_halo`` under ``DPI_PALLAS_WGRAD=1``, through ``wgrad3d_plain`` on
the CPU) gives the shard conv's own weight gradient."""
import pytest
import torch
import torch.nn.functional as F

from deep_prior_interpolation_tpu_torch import Config
from deep_prior_interpolation_tpu_torch.models import get_net, init_weights
from deep_prior_interpolation_tpu_torch.ops import conv_vjp as cv
from deep_prior_interpolation_tpu_torch.ops import wgrad as WG
from deep_prior_interpolation_tpu_torch.parallel.spatial import ShardedStep, SpatialLayout

torch.set_num_threads(1)
CPU = torch.device("cpu")
SPATIAL = {2: (24, 40), 3: (16, 16, 8)}


def _net(ndim, upsample, dtype="float32"):
    cfg = Config(datadim=f"{ndim}d", inputdepth=4, filters=[8, 16, 32], skip=[4, 4],
                 upsample=upsample, dtype=dtype)
    net = get_net(cfg, 1)
    init_weights(net, torch.Generator().manual_seed(0))
    return net


def _run(net, layout, x, cot):
    params = list(net.parameters())
    ys = ShardedStep(net, layout)(layout.split(x))
    grads = torch.autograd.grad(sum((a * b).sum() for a, b in zip(ys, layout.split(cot))),
                                params)
    return layout.gather([y.detach() for y in ys]), grads


@pytest.mark.parametrize("n,axis", [(2, 1), (4, 1), (3, 0)])
@pytest.mark.parametrize("upsample", ["nearest", "linear"])
@pytest.mark.parametrize("ndim", [2, 3])
def test_the_sharded_net_is_the_net(ndim, upsample, n, axis):
    sp = SPATIAL[ndim]
    net = _net(ndim, upsample)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((1, 4) + sp, generator=g)
    cot = torch.randn((1, 1) + sp, generator=g)
    params = list(net.parameters())
    y = net(x)
    ref = torch.autograd.grad((y * cot).sum(), params)
    # blocks of 4 planes (2 downsamplings): 4 shards of 40 and 3 of 16 are uneven
    layout = SpatialLayout([CPU] * n, axis, sp, sp, 4)
    out, grads = _run(net, layout, x, cot)
    y = y.detach()
    assert float((out - y).abs().max()) <= 1e-5 * float(y.abs().max())
    for (name, _), a, b in zip(net.named_parameters(), grads, ref):
        if name.endswith("kernel"):
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), name
    flat = torch.cat([a.flatten() for a in grads]), torch.cat([b.flatten() for b in ref])
    assert float((flat[0] - flat[1]).norm()) <= 1e-4 * float(flat[1].norm())


@pytest.mark.parametrize("ndim", [2, 3])
def test_the_bfloat16_sharded_net_is_the_net(ndim):
    sp = SPATIAL[ndim]
    net = _net(ndim, "linear", "bfloat16")
    g = torch.Generator().manual_seed(2)
    x = torch.randn((1, 4) + sp, generator=g)
    y = net(x).detach()
    out, _ = _run(net, SpatialLayout([CPU] * 2, 1, sp, sp, 4), x, torch.ones((1, 1) + sp))
    assert out.dtype == y.dtype == torch.float32
    assert float((out - y).abs().max()) <= 2.0 ** -7 * float(y.abs().max())


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_the_padded_dy_route_is_the_shard_conv_s_weight_gradient(monkeypatch, axis):
    g = torch.Generator().manual_seed(3)
    shape = [6, 5, 7]
    shape[axis] += 2   # the shard's planes and a halo plane on each side
    x = torch.randn((1, 3) + tuple(shape), generator=g)
    w = torch.randn(4, 3, 3, 3, 3, generator=g, requires_grad=True)
    pads = [1, 1, 1]
    pads[axis] = 0
    y = cv.conv_halo(x, w, axis, 1)
    dy = torch.randn(y.shape, generator=g)
    ref = torch.nn.grad.conv3d_weight(x, w.shape, dy, padding=tuple(pads))
    # the identity itself, then the route the conv takes with the kernel on
    spec = [0, 0] * 3
    spec[2 * (2 - axis)] = spec[2 * (2 - axis) + 1] = 1
    torch.testing.assert_close(WG.wgrad3d_plain(x, F.pad(dy, spec), 3), ref,
                               rtol=1e-5, atol=1e-5)
    seen = []
    monkeypatch.setattr(cv, "wgrad3d", lambda a, b, k: seen.append(b.shape) or
                        WG.wgrad3d(a, b, k))
    monkeypatch.setenv("DPI_PALLAS_WGRAD", "1")
    (dw,) = torch.autograd.grad(y, w, dy)
    assert seen == [x.shape[:1] + dy.shape[1:2] + x.shape[2:]]
    torch.testing.assert_close(dw, ref, rtol=1e-5, atol=1e-5)
