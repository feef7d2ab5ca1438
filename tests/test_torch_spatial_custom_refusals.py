"""What the sharded walker of a module of the caller's own still refuses
(parallel/spatial_custom.py): only what the JAX package's jitted step
refuses too, each raising ``NotImplementedError`` naming the op and
ROADMAP D.4 when a sharded solve starts, from the meta pass, before
anything is drawn (the solver's generators are never made): an output
whose shape depends on values (``nonzero``, ``masked_select``,
``unique``, indexing by a boolean mask: ``jax.jit`` cannot trace them),
``out=`` and an in-place op into a plain tensor (a flax module has
neither). ``.item()``, ``bool()`` and ``.tolist()`` of a shard list (a
host read, ``jax.jit``'s ``ConcretizationTypeError``), which a meta
forward cannot run (so a solve refuses them unsharded too), are refused
by the walker itself. Every op the walker refused before its relayout,
window and whole routes runs: tests/test_torch_spatial_whole.py."""
import numpy as np
import pytest
import torch
from torch import nn

from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.engine import solver as E
from deep_prior_interpolation_tpu_torch.parallel import spatial as S

torch.set_num_threads(1)
CPU = torch.device("cpu")
D4 = r"\(ROADMAP D\.4\)"


class Refused(nn.Module):
    """A conv, then ``op(y, self)``; ``extra`` a module the op may use."""

    def __init__(self, op, extra=None):
        super().__init__()
        self.conv, self.op, self.extra = nn.Conv2d(4, 1, 3, padding=1), op, extra

    def forward(self, x):
        return self.op(self.conv(x), self)


# each op along spatial axis 1 (the last dim) that stays refused, and what
# the refusal names
REFUSED = {
    "nonzero": (lambda y, m: y + torch.nonzero(y).sum(), r"torch.nonzero on spatial shards"),
    "masked_select": (lambda y, m: y + torch.masked_select(y, y > 0).mean(),
                      r"torch.masked_select on spatial shards"),
    "unique": (lambda y, m: y + torch.unique(y).sum(), r"torch.unique on spatial shards"),
    "boolean_mask": (lambda y, m: y + y[y > 0].mean(),
                     r"Tensor.__getitem__ on spatial shards: an output whose shape depends"),
    "out": (lambda y, m: torch.add(y, 1.0, out=torch.empty_like(y)),
            r"torch.add\(out=...\) on spatial shards"),
    "into_plain": (lambda y, m: torch.zeros(1, 1, 32, 32).add_(y),
                   r"Tensor.add_ into a plain tensor on spatial shards"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_each_op_outside_the_vocabulary_is_refused_before_anything_is_drawn(name,
                                                                            monkeypatch):
    """The walker's meta pass names the op and D.4; a sharded solve
    refuses it before anything is drawn (a value-dependent shape already
    in the unsharded meta forward that checks the net's output, as an
    unsharded solve does)."""
    op, what = REFUSED[name]
    with pytest.raises(NotImplementedError, match=f"{what}.*{D4}"):
        S.check_supported(Refused(op), (1, 4, 32, 32), 2, 1)
    drawn = []
    real = E._generators
    monkeypatch.setattr(E, "_generators", lambda *a: drawn.append(1) or real(*a))
    cfg = Config(datadim="2d", epochs=2, inputdepth=4, filters=[4, 8], skip=[4], gain=1.0)
    img = np.ones((32, 32, 1), np.float32)
    with pytest.raises(NotImplementedError):
        DIPSolver(cfg, device="cpu", model=Refused(op)).solve(
            img, img, spatial_mesh=[CPU] * 2, spatial_axis=1)
    assert not drawn


@pytest.mark.parametrize("op,what", [
    (lambda y, m: y * y.mean().item(), r"Tensor.item"),
    (lambda y, m: y if y.mean() > 0 else -y, r"Tensor.__bool__"),
    (lambda y, m: y * y.amax(dim=(2, 3)).tolist()[0][0], r"Tensor.tolist"),
])
def test_a_host_read_of_a_shard_list_is_refused(op, what):
    """``.item()``, ``bool()`` and ``.tolist()`` of a replicated value, on
    real shards."""
    model = Refused(op)
    layout = S.SpatialLayout([CPU] * 2, 1, (32, 32), (32, 32), 2)
    x = torch.randn(1, 4, 32, 32, generator=torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match=f"{what} on spatial shards: a host read.*{D4}"):
        S.ShardedStep(model, layout)(layout.split(x))
