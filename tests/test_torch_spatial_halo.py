"""The spatial shards' halo exchange at any width and the volume's max
(parallel/spatial.py) on the CPU.

``halo_exchange`` gives each shard the planes around it from whichever
shard holds them, however many shards away, and past the volume's ends
zeros, copies of the end plane, its mirror without the end plane or -inf:
each extended shard equals the same planes of ``F.pad`` of the whole
volume (constant, replicate, reflect; -inf as a constant), and its backward
equals the whole pad's gradient, in float64 to 1e-12. The narrow exchanges
the nets made before any-width halos (zeros or copies of the end plane, a
halo no wider than the neighbouring shard) keep their results bit for bit,
forward and backward, against that exchange's own algorithm. ``all_max``
splits its cotangent over the tied voxels of the whole volume, as
``torch.amax`` does, also when the ties lie on two shards."""
import pytest
import torch
import torch.nn.functional as F

from deep_prior_interpolation_tpu_torch.parallel import spatial as S

torch.set_num_threads(1)
F64 = torch.float64
SIZES = [1, 3, 1, 2, 4]   # uneven shards along the last dim: 11 planes
EDGES = {"zero": ("constant", 0.0), "replicate": ("replicate", None),
         "reflect": ("reflect", None), "-inf": ("constant", -float("inf"))}


def _whole(x, lo, hi, edge):
    mode, value = EDGES[edge]
    if value is None:
        return F.pad(x, (lo, hi, 0, 0), mode=mode)
    return F.pad(x, (lo, hi, 0, 0), mode=mode, value=value)


def _extended(pad, lo, hi):
    """Each shard's planes of the whole padded volume, with its halos."""
    out, a = [], 0
    for s in SIZES:
        out.append(pad[..., a:a + s + lo + hi])
        a += s
    return out


@pytest.mark.parametrize("edge", list(EDGES))
@pytest.mark.parametrize("lo,hi", [(1, 2), (5, 4)])
def test_each_extended_shard_is_the_whole_pad(edge, lo, hi):
    """Widths up to 5 planes: 3 shards away from a 1-plane shard."""
    x = torch.randn(1, 2, 3, sum(SIZES), dtype=F64)
    got = S.halo_exchange(list(x.split(SIZES, -1)), 1, lo, hi, edge)
    for g, want in zip(got, _extended(_whole(x, lo, hi, edge), lo, hi)):
        assert torch.equal(g, want)


@pytest.mark.parametrize("edge", list(EDGES))
def test_the_backward_is_the_whole_pads_gradient(edge):
    lo, hi = 4, 5
    x = torch.randn(1, 2, 3, sum(SIZES), dtype=F64)
    xs = [t.clone().requires_grad_() for t in x.split(SIZES, -1)]
    shards = S.halo_exchange(xs, 1, lo, hi, edge)
    gs = [torch.randn(t.shape, dtype=F64) for t in shards]
    got = torch.autograd.grad(shards, xs, gs)
    whole = x.clone().requires_grad_()
    parts = _extended(_whole(whole, lo, hi, edge), lo, hi)
    (ref,) = torch.autograd.grad(sum((p * g).sum() for p, g in zip(parts, gs)), whole)
    torch.testing.assert_close(torch.cat(got, -1), ref, rtol=1e-12, atol=1e-12)
    if edge != "-inf":
        assert torch.autograd.gradcheck(lambda *t: S._HaloExchange.apply(1, 2, 3, edge, *t),
                                        tuple(xs))


def _neighbour_exchange(xs, dim, lo, hi, edge):
    """The exchange the nets made before any-width halos: the left and the
    right neighbour's edge planes; zeros or copies of the shard's own end
    plane at the volume's ends; the backward adds the left neighbour's
    halo gradient, the right one's, then the end's sum, shard by shard."""
    n = len(xs)

    def end(x, plane, count):
        if edge == "zero":
            return torch.zeros_like(x.narrow(dim, 0, 1)).expand(
                *[count if d == dim else -1 for d in range(x.dim())])
        return x.narrow(dim, plane, 1).expand(*[count if d == dim else -1
                                                for d in range(x.dim())])
    outs = []
    for i, x in enumerate(xs):
        left = xs[i - 1].narrow(dim, xs[i - 1].shape[dim] - lo, lo) if i else end(x, 0, lo)
        right = (xs[i + 1].narrow(dim, 0, hi) if i < n - 1
                 else end(x, x.shape[dim] - 1, hi))
        outs.append(torch.cat([left, x, right], dim))

    def backward(gs):
        dxs = []
        for i, g in enumerate(gs):
            size = xs[i].shape[dim]
            dx = g.narrow(dim, lo, size).clone()
            if i > 0:
                dx.narrow(dim, 0, hi).add_(gs[i - 1].narrow(dim, lo + xs[i - 1].shape[dim], hi))
            if i < n - 1:
                dx.narrow(dim, size - lo, lo).add_(gs[i + 1].narrow(dim, 0, lo))
            if edge == "replicate":
                if i == 0:
                    dx.narrow(dim, 0, 1).add_(g.narrow(dim, 0, lo).sum(dim, keepdim=True))
                if i == n - 1:
                    dx.narrow(dim, size - 1, 1).add_(
                        g.narrow(dim, lo + size, hi).sum(dim, keepdim=True))
            dxs.append(dx)
        return dxs
    return outs, backward


@pytest.mark.parametrize("edge", ["zero", "replicate"])
def test_the_neighbour_exchanges_keep_their_bits(edge):
    """float32, one-plane halos over one-plane shards (a net's deepest
    level, the linear upsample's replicate halo) and a (3, 2) halo over
    wider shards (the 7 x 7 stride-2 conv's)."""
    g = torch.Generator().manual_seed(0)
    for sizes, lo, hi in (([1, 1, 1, 1], 1, 1), ([4, 6, 4], 3, 2)):
        x = torch.randn((1, 3, 5, sum(sizes)), generator=g)
        xs = [t.clone().requires_grad_() for t in x.split(sizes, -1)]
        got = S.halo_exchange(xs, 1, lo, hi, edge)
        want, backward = _neighbour_exchange([t.detach() for t in xs], 3, lo, hi, edge)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        gs = [torch.randn(t.shape, generator=g) for t in got]
        dxs = torch.autograd.grad(got, xs, gs)
        assert all(torch.equal(a, b) for a, b in zip(dxs, backward(gs)))


def test_a_reflection_past_the_mirror_is_refused():
    xs = list(torch.zeros(1, 1, 2, 4).split([2, 2], -1))
    with pytest.raises(ValueError, match="mirrors at most 3 planes"):
        S.halo_exchange(xs, 1, 4, 0, "reflect")


@pytest.mark.parametrize("dtype", [F64, torch.bfloat16])
def test_the_volumes_max_splits_over_ties_on_every_shard(dtype):
    """Equal maxima on all three shards: the gradient equals
    ``torch.amax``'s over the whole volume, each tie a third of it."""
    x = torch.randn(1, 2, 4, 9, dtype=F64).to(dtype)
    for c, (h, w) in enumerate([(0, 1), (3, 7)]):
        x[0, c, h, w] = x[0, c, 2, 4] = x[0, c, 1, 8] = 10.0
    cot = torch.tensor([[1.5, -0.75]], dtype=dtype)
    whole = x.clone().requires_grad_()
    (ref,) = torch.autograd.grad((torch.amax(whole, dim=(2, 3)) * cot).sum(), whole)
    xs = [t.clone().requires_grad_() for t in x.split([3, 3, 3], -1)]
    tops = S.all_max(xs, (2, 3))
    assert all(torch.equal(t.flatten(1), torch.amax(x, dim=(2, 3))) for t in tops)
    # each shard's copy takes a part of the cotangent: the parts add up
    parts = [cot * w for w in (0.5, 0.25, 0.25)]
    got = torch.autograd.grad([t.flatten(1) for t in tops], xs, parts)
    assert torch.equal(torch.cat(got, -1), ref)
    assert float(ref.abs().max()) == 0.5 and int((ref != 0).sum()) == 6
