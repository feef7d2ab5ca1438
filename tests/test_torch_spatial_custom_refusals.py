"""What the sharded walker of a module of the caller's own refuses
(parallel/spatial_custom.py): each op outside its vocabulary raises
``NotImplementedError`` naming the op and ROADMAP A.13c item 13 when a
sharded solve starts, from the meta pass, before anything is drawn (the
solver's generators are never made): slicing, flipping, rolling or an FFT
along the sharded dim, a custom ``autograd.Function`` and a
``torch.no_grad()`` region in a forward that needs gradients, a pending
reflect pad used by another op than a conv or pool, a circular pad along
the axis, a max pool's indices, an ``align_corners`` resize, a per-shard
draw (``rand_like``, ``alpha_dropout``), a layer norm whose affine spans the
sharded dim, an ``einsum``. No op is run locally on shards in silence.
``.item()`` and ``bool()`` of a shard list, which a meta forward cannot
run (so a solve refuses them unsharded too), are refused by the walker
itself."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.engine import solver as E
from deep_prior_interpolation_tpu_torch.parallel import spatial as S

torch.set_num_threads(1)
CPU = torch.device("cpu")
ITEM = "ROADMAP A.13c item 13"


class Twice(torch.autograd.Function):
    """A custom autograd Function: its forward runs with the gradient off."""

    @staticmethod
    def forward(ctx, x):
        return 2.0 * x

    @staticmethod
    def backward(ctx, g):
        return 2.0 * g


def _quiet(y):
    with torch.no_grad():
        top = y.abs().amax()
    return y / top


class Refused(nn.Module):
    """A conv, then ``op(y, self)``; ``extra`` a module the op may use."""

    def __init__(self, op, extra=None):
        super().__init__()
        self.conv, self.op, self.extra = nn.Conv2d(4, 1, 3, padding=1), op, extra

    def forward(self, x):
        return self.op(self.conv(x), self)


# each op along spatial axis 1 (the last dim), and what the refusal names
REFUSED = {
    "slice": (lambda y, m: torch.cat([y[..., 1:], y[..., :1]], -1),
              r"Tensor.__getitem__ along the sharded dim"),
    "flip": (lambda y, m: y.flip(-1), r"Tensor.flip along the sharded dim"),
    "roll": (lambda y, m: torch.roll(y, 1, -1), r"torch.roll along the sharded dim"),
    "fft": (lambda y, m: torch.fft.ifft(torch.fft.fft(y, dim=-1), dim=-1).real, r"fft"),
    "function": (lambda y, m: Twice.apply(y),
                 r"under torch.no_grad\(\) or inside a custom autograd.Function"),
    "no_grad": (lambda y, m: _quiet(y), r"Tensor.abs under torch.no_grad\(\)"),
    "pending_pad": (lambda y, m: F.relu(F.pad(y, (1, 1, 1, 1), mode="reflect"))[..., 1:-1, 1:-1],
                    r"F.relu of a pending pad"),
    "circular": (lambda y, m: F.conv2d(F.pad(y, (1, 1, 1, 1), mode="circular"),
                                       m.conv.weight[:1, :1]),
                 r"F.pad\(mode='circular', value=None\) along the sharded dim"),
    "indices": (lambda y, m: F.max_unpool2d(*F.max_pool2d(y, 2, return_indices=True), 2),
                r"F.max_pool2d_with_indices"),
    "align_corners": (lambda y, m: F.interpolate(F.avg_pool2d(y, 2), scale_factor=2,
                                                 mode="bilinear", align_corners=True),
                      r"F.interpolate\(mode='bilinear', align_corners=True\)"),
    "rand_like": (lambda y, m: y + 0.1 * torch.rand_like(y), r"torch.rand_like"),
    "alpha_dropout": (lambda y, m: F.alpha_dropout(y, 0.1, True), r"F.alpha_dropout"),
    "layer_norm": (lambda y, m: m.extra(y), r"F.layer_norm over the sharded dim with an "
                                             r"elementwise affine"),
    "einsum": (lambda y, m: y * torch.einsum("nchw,nchw->nch", y, y)[..., None],
               r"torch.einsum"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_each_op_outside_the_vocabulary_is_refused_before_anything_is_drawn(name,
                                                                            monkeypatch):
    op, what = REFUSED[name]
    extra = nn.LayerNorm([32, 32]) if name == "layer_norm" else None
    drawn = []
    real = E._generators
    monkeypatch.setattr(E, "_generators", lambda *a: drawn.append(1) or real(*a))
    cfg = Config(datadim="2d", epochs=2, inputdepth=4, filters=[4, 8], skip=[4], gain=1.0)
    img = np.ones((32, 32, 1), np.float32)
    with pytest.raises(NotImplementedError, match=f"{what}.*: {ITEM}"):
        DIPSolver(cfg, device="cpu", model=Refused(op, extra)).solve(
            img, img, spatial_mesh=[CPU] * 2, spatial_axis=1)
    assert not drawn


@pytest.mark.parametrize("op,what", [
    (lambda y, m: y * y.mean().item(), r"Tensor.item"),
    (lambda y, m: y if y.mean() > 0 else -y, r"Tensor.__bool__"),
])
def test_a_host_read_of_a_shard_list_is_refused(op, what):
    """``.item()`` and ``bool()`` of a replicated mean, on real shards."""
    model = Refused(op)
    layout = S.SpatialLayout([CPU] * 2, 1, (32, 32), (32, 32), 2)
    x = torch.randn(1, 4, 32, 32, generator=torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match=f"{what}.*: {ITEM}"):
        S.ShardedStep(model, layout)(layout.split(x))
