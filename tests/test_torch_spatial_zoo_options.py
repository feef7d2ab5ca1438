"""The zoo's remaining constructor options over spatial shards
(parallel/spatial_zoo.py): each walk against its unsharded net in float64
on the CPU, over 2 and 4 shards along axis 1, forward and every parameter
gradient of ``sum(out * cot)``.

The nets: the skip net with reflection padding (kernel 5, so that a
stride-2 conv takes a (2, 1) reflect halo and the deepest conv's halo of 2
reaches past a one-plane shard), with ``lanczos2`` (3D) and ``lanczos3``
downsampling (halos of 3 and 5 planes over shards of 2 and 4); the U-Net
with its deconv up path, ``concat_x`` and ``more_layers=1`` (3D); the CBAM
U-Net (its 7 x 7 spatial gates' halo of 3 over 2-plane shards at level 3)
and the ConvGRU ensemble of one frame. Dropout 0.1 from one generator
where the net has it. The library's blocks given to the solver alone (a
conv, with reflection padding too, a flax conv, a Norm, the MultiRes and
ResPath blocks, the U-Net's double conv, a ResNet block, CBAM's two
gates) are walked as the nets walk them, over 4 shards, and so is the
attention U-Net without its CBAM gates.

Tolerances, of the largest output and of the largest gradient: 1e-12; the
U-Net's InstanceNorm takes float32 statistics, as in the plain net, so it
holds to 1e-6 and 1e-9 (measured: up to 1.0e-7 and 1.5e-11; the 3D
``more_layers`` net has six levels of such Norms); the CBAM U-Net and the
ensemble to 1e-11 and 2e-10, their own conditioning: a one-ulp change of
another input moved the plain CBAM U-Net's output by 1e-12 and its
gradients by 6e-12, the plain ensemble's (40 Norms deep) by 3e-11 and 7e-11
(measured here: up to 7e-13 / 5.6e-12 and 1.7e-13 / 6.4e-13)."""
import pytest
import torch

from deep_prior_interpolation_tpu_torch import Config
from deep_prior_interpolation_tpu_torch.engine.solver import shard_block
from deep_prior_interpolation_tpu_torch.models import (
    AttentionUnet, ChannelGate, Conv, ConvNormAct, Ensemble, FlaxConv, MultiResBlock, Norm,
    ResNetBasicBlock, ResPath, SkipNet, SpatialGate, UNet, UNetConv, init_weights,
    set_dropout_generator)
from deep_prior_interpolation_tpu_torch.parallel import spatial as S

torch.set_num_threads(1)
CPU = torch.device("cpu")
F64 = torch.float64
TIGHT, INORM, CBAM_TOL, GRU_TOL = (1e-12, 1e-12), (1e-6, 1e-9), (1e-11, 1e-11), (2e-10, 2e-10)

# each net: its maker, the padded volume (axis 1 holds 4 of its blocks), tolerances
NETS = {
    "reflection": (lambda: SkipNet(4, 1, 2, (4, 8, 8), (4,), filter_size_down=5,
                                   pad="reflection", upsample_mode="bilinear", dropout=0.1),
                   (32, 32), TIGHT),
    "lanczos2": (lambda: SkipNet(4, 1, 3, (4, 4), (4,), downsample_mode="lanczos2",
                                 upsample_mode="trilinear", dropout=0.1), (8, 16, 8), TIGHT),
    "lanczos3": (lambda: SkipNet(4, 1, 2, (4, 8, 8), (4,), downsample_mode="lanczos3"),
                 (16, 32), TIGHT),
    "deconv": (lambda: UNet(4, 1, 2, (4, 4, 4, 4, 4), upsample_mode="deconv", dropout=0.1),
               (16, 64), INORM),
    "concat_x": (lambda: UNet(4, 1, 2, (8, 8, 8, 8, 8), concat_x=True,
                              upsample_mode="bilinear"), (16, 64), INORM),
    "more_layers": (lambda: UNet(4, 1, 3, (2, 2, 2, 2, 2), more_layers=1,
                                 upsample_mode="deconv"), (32, 128, 32), INORM),
    "cbam_unet": (lambda: AttentionUnet(4), (16, 64), CBAM_TOL),
    "ensemble": (lambda: Ensemble(4, 1, num_frames=1, hidden=8), (32, 128), GRU_TOL),
}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("net", list(NETS))
def test_each_walk_is_its_net_in_float64(net, n):
    make, padded, (out_tol, grad_tol) = NETS[net]
    model = make().double()
    init_weights(model, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(4)
    x = torch.randn((1, 4) + padded, generator=g, dtype=F64)
    params = list(model.parameters())
    set_dropout_generator(model, torch.Generator().manual_seed(9))
    y = model(x)
    cot = torch.randn(y.shape, generator=g, dtype=F64)
    ref = torch.autograd.grad((y * cot).sum(), params)

    layout = S.SpatialLayout([CPU] * n, 1, padded, padded, shard_block(Config(), model))
    set_dropout_generator(model, torch.Generator().manual_seed(9))
    outs = S.ShardedStep(model, layout)(layout.split(x))
    got = torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, layout.split(cot))),
                              params)
    torch.testing.assert_close(torch.cat(outs, 3).detach(), y.detach(), rtol=0,
                               atol=out_tol * float(y.detach().abs().max()))
    g_max = max(float(r.abs().max()) for r in ref)
    for (name, _), a, b in zip(model.named_parameters(), got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=grad_tol * g_max, msg=name)


def _built(m, *shape):
    return m.build(torch.zeros(shape)) if hasattr(m, "build") else m


# each block and its tolerances: the U-Net's double conv alone ends in a
# float32-statistics InstanceNorm, whose rounding (6e-8) reaches its output
# and its gradients directly (measured: 7.2e-8 and 7.2e-8)
BLOCKS = [(lambda: Conv(4, 3, 3), TIGHT), (lambda: Conv(4, 3, 5, pad="reflection"), TIGHT),
          (lambda: ConvNormAct(4, 3, 3), TIGHT), (lambda: Norm(4), TIGHT),
          (lambda: FlaxConv(4, 3, 3), TIGHT), (lambda: MultiResBlock(4, 6, 2, drop=0.1), TIGHT),
          (lambda: ResPath(4, 3, 2, drop=0.1, length=2), TIGHT),
          (lambda: _built(UNetConv(3, 2, "ReLU", True, drop=0.1), 1, 4, 8, 8), (1e-6, 1e-6)),
          (lambda: _built(ResNetBasicBlock(4), 1, 4, 8, 8), TIGHT),
          (lambda: _built(ChannelGate(2), 1, 4, 8, 8), TIGHT),
          (lambda: _built(SpatialGate(7), 1, 4, 8, 8), TIGHT),
          (lambda: AttentionUnet(4, att="none"), TIGHT)]


def test_each_library_block_alone_is_its_walk_in_float64():
    """Each block (and the gateless attention U-Net) over 4 shards of a
    (16, 64) input along axis 1 (16 planes a shard: the 16-plane block of
    the solver's default net and of the attention U-Net), output and
    gradients to 1e-12 of their largest (the double conv to 1e-6)."""
    for make, (out_tol, grad_tol) in BLOCKS:
        model = make().double()
        init_weights(model, torch.Generator().manual_seed(0))
        x = torch.randn((1, 4, 16, 64), generator=torch.Generator().manual_seed(4), dtype=F64)
        params = list(model.parameters())
        set_dropout_generator(model, torch.Generator().manual_seed(9))
        y = model(x)
        cot = torch.randn(y.shape, generator=torch.Generator().manual_seed(5), dtype=F64)
        ref = torch.autograd.grad((y * cot).sum(), params)
        layout = S.SpatialLayout([CPU] * 4, 1, (16, 64), (16, 64), shard_block(Config(), model))
        set_dropout_generator(model, torch.Generator().manual_seed(9))
        outs = S.ShardedStep(model, layout)(layout.split(x))
        got = torch.autograd.grad(sum((o * c).sum() for o, c in zip(outs, layout.split(cot))),
                                  params)
        name = type(model).__name__
        torch.testing.assert_close(torch.cat(outs, 3).detach(), y.detach(), rtol=0,
                                   atol=out_tol * float(y.detach().abs().max()), msg=name)
        g_max = max(float(r.abs().max()) for r in ref)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=grad_tol * g_max, msg=name)
