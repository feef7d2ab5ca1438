"""The sharded MulResUnet at the flagship's width (input depth 64, filters
16-256, four downsamplings, linear upsampling) against the unsharded port
net, in float64 on the CPU: the net, the crop to the unpadded volume and
the plain masked L1 loss (``ShardedStep.loss_terms``), then the
parameters' gradients summed over the shards.

float32 cannot hold this comparison tight: the flagship's gradients
amplify a change of summation order in the Norm statistics (1e-7 of a sum)
to 1e-2 of a conv kernel's largest gradient at these small volumes, so
the float32 tests hold a narrower net and the card holds the flagship
against its precision's own error. float64 rounds 1e9 times finer: the
outputs and the loss are held to 1e-10 of their scale, every gradient to
1e-10 of the largest gradient entry, and each conv kernel's to 1e-8 of its
own largest entry (the small gradient of a conv whose output a Norm
nearly cancels carries that amplification)."""
from types import SimpleNamespace

import pytest
import torch

from deep_prior_interpolation_tpu_torch import Config
from deep_prior_interpolation_tpu_torch.engine.solver import _crop_center
from deep_prior_interpolation_tpu_torch.models import get_net, init_weights
from deep_prior_interpolation_tpu_torch.ops import losses as L
from deep_prior_interpolation_tpu_torch.parallel.spatial import ShardedStep, SpatialLayout

torch.set_num_threads(1)
CPU = torch.device("cpu")
FLAGSHIP = dict(datadim="3d", inputdepth=64, filters=[16, 32, 64, 128, 256],
                skip=[16, 32, 64, 128], upsample="linear")


@pytest.mark.parametrize("n,padded,spatial", [(2, (16, 32, 16), (12, 30, 16)),
                                              (4, (16, 64, 16), (16, 58, 14))])
def test_the_flagship_width_sharded_step_is_the_net_in_float64(n, padded, spatial):
    net = get_net(Config(**FLAGSHIP), 1).double()
    init_weights(net, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(4)
    x = 0.1 * torch.randn((1, 64) + padded, generator=g, dtype=torch.float64)
    img = torch.randn((1, 1) + spatial, generator=g, dtype=torch.float64)
    mask = (torch.rand((1, 1) + spatial, generator=g) > 0.5).double()
    params = list(net.parameters())
    y = _crop_center(net(x), spatial)
    loss = L.masked_fit([y], [img], [mask], "mae")
    ref = torch.autograd.grad(loss, params)

    layout = SpatialLayout([CPU] * n, 1, padded, spatial, 16)
    step = ShardedStep(net, layout)
    data = {"img": layout.split(img, cropped=True), "mask": layout.split(mask, cropped=True)}
    outs, got_loss, _ = step.loss_terms(step(layout.split(x)), data,
                                        SimpleNamespace(fused_loss=False, loss="mae"),
                                        torch.float64, CPU)
    grads = torch.autograd.grad(got_loss, params)
    out = torch.cat([o.detach() for o in outs], dim=3)
    y = y.detach()
    assert out.shape == y.shape
    assert float((out - y).abs().max()) <= 1e-10 * float(y.abs().max())
    assert abs(float(got_loss) - float(loss)) <= 1e-10 * float(loss)
    top = max(float(b.abs().max()) for b in ref)
    for (name, _), a, b in zip(net.named_parameters(), grads, ref):
        err = float((a - b).abs().max())
        assert err <= 1e-10 * top, name
        if name.endswith("kernel"):   # conv biases before a Norm: 0 up to rounding
            assert err <= 1e-8 * float(b.abs().max()), name
