"""The port's phase-space ops (ops/phase_space.py) against the JAX
package's: the layout transforms, the kernel transforms, the entry, phase
and exit convs (k 1 and 3, 2D and 3D, depth 1 and 2), the upsample into
phase layout, and the phase conv's gradients through the weight selection.

The port is channels-first: a JAX phase tensor (N, *sp/2, C*B) is the
port's (N, C*B, *sp/2) with the channel axis moved, a JAX kernel
(*k, Ci, Co) the port's (Co, Ci, *k). float32 throughout: the transforms
are exact (equal), the convs sum in other orders (1e-5 of the output's
largest value)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deep_prior_interpolation_tpu.ops import phase_space as jps
from deep_prior_interpolation_tpu_torch.ops import phase_space as ps

torch.set_num_threads(1)

TOL = 1e-5


def _t(a: np.ndarray) -> torch.Tensor:
    """JAX layout (N, *sp, C) -> the port's (N, C, *sp)."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a, np.float32), -1, 1)))


def _j(t: torch.Tensor) -> np.ndarray:
    """The port's (N, C, *sp) -> JAX layout."""
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def _wt(w: np.ndarray) -> torch.Tensor:
    """JAX kernel (*k, Ci, Co) -> the port's (Co, Ci, *k)."""
    d = w.ndim - 2
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(w, (d + 1, d) + tuple(range(d))).astype(np.float32)))


def _close(got: np.ndarray, ref: np.ndarray) -> None:
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * np.abs(ref).max())


def _plain_conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    conv = {2: F.conv2d, 3: F.conv3d}[w.ndim - 2]
    return conv(x, w, stride=stride, padding=(w.shape[2] - 1) // 2)


@pytest.mark.parametrize("sp", [(8, 6), (8, 6, 4)])
def test_space_to_depth_layout_and_round_trip(sp):
    x = np.random.RandomState(0).randn(2, *sp, 3).astype(np.float32)
    got = ps.space_to_depth(_t(x))
    np.testing.assert_array_equal(_j(got), np.asarray(jps.space_to_depth(jnp.asarray(x))))
    np.testing.assert_array_equal(ps.depth_to_space(got).numpy(), _t(x).numpy())
    # channel c*B + lin(phi): c = 1, phi = (1, 0, ...) -> 1*B + B/2
    b = 2 ** len(sp)
    want = _t(x)[(0, 1, slice(1, None, 2)) + (slice(0, None, 2),) * (len(sp) - 1)]
    np.testing.assert_array_equal(got[0, b + b // 2].numpy(), want.numpy())


@pytest.mark.parametrize("sp", [(6, 4), (6, 4, 4)])
def test_phase_pad_matches_jax_and_the_padded_plain_tensor(sp):
    x = np.random.RandomState(1).randn(1, *sp, 3).astype(np.float32)
    got = ps.phase_pad(ps.space_to_depth(_t(x)))
    ref = jps.phase_pad(jps.space_to_depth(jnp.asarray(x)))
    np.testing.assert_array_equal(_j(got), np.asarray(ref))
    padded = F.pad(_t(x), (1, 1) * len(sp))
    np.testing.assert_array_equal(got.numpy(), ps.space_to_depth(padded).numpy())


@pytest.mark.parametrize("k,sp,depth", [
    (3, (8, 8), 1), (1, (8, 8), 1), (3, (8, 8, 4), 1), (1, (8, 8, 4), 1),
    (3, (8, 8), 2), (3, (8, 8, 8), 2)])
def test_entry_phase_and_exit_convs_match_jax(k, sp, depth):
    d = len(sp)
    rng = np.random.RandomState(2)
    x = rng.randn(1, *sp, 5).astype(np.float32)
    w = (0.2 * rng.randn(*(k,) * d, 5, 7)).astype(np.float32)
    xt, wt = _t(x), _wt(w)
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    plain = _plain_conv(xt, wt)
    blocked = xt
    for _ in range(depth):
        blocked = ps.space_to_depth(blocked)

    entry = ps.phase_entry_conv(xt, wt, depth)
    _close(_j(entry), np.asarray(jps.phase_entry_conv(xj, wj, depth)))
    want = plain
    for _ in range(depth):
        want = ps.space_to_depth(want)
    _close(entry.numpy(), want.numpy())

    inner = ps.phase_conv(blocked, wt, depth)
    _close(_j(inner), np.asarray(jps.phase_conv(jnp.asarray(_j(blocked)), wj, depth)))
    _close(inner.numpy(), want.numpy())

    if k == 3:
        out = ps.phase_exit_conv(blocked, wt, depth)
        _close(_j(out), np.asarray(jps.phase_exit_conv(jnp.asarray(_j(blocked)), wj, depth)))
        _close(out.numpy(), _plain_conv(xt, wt, stride=2).numpy())


def test_kernel_transforms_equal_jax():
    """The selections are exact: equal to JAX's gathers, entry for entry."""
    def port_layout(a):
        return _wt(np.asarray(a)).numpy()
    for k, d in [(3, 3), (1, 3), (3, 2), (5, 2)]:
        w = np.random.RandomState(3).randn(*(k,) * d, 4, 6).astype(np.float32)
        wt, wj = _wt(w), jnp.asarray(w)
        np.testing.assert_array_equal(ps.phase_kernel(wt, 1).numpy(),
                                      port_layout(jps.phase_kernel(wj, 1)))
        np.testing.assert_array_equal(ps.phase_kernel(wt, 2).numpy(),
                                      port_layout(jps.phase_kernel(wj, 2)))
        np.testing.assert_array_equal(ps.entry_kernel(wt).numpy(),
                                      port_layout(jps.entry_kernel(wj)))
        assert ps.phase_paddings(k, 1) == jps.phase_paddings(k, 1)
        assert ps.phase_paddings(k, 2) == jps.phase_paddings(k, 2)


@pytest.mark.parametrize("mode,sp", [("nearest", (8, 6)), ("nearest", (6, 4, 4)),
                                     ("linear", (8, 6)), ("linear", (6, 4, 4))])
def test_upsample_into_phase_matches_jax_and_the_resize(mode, sp):
    x = np.random.RandomState(4).randn(1, *sp, 3).astype(np.float32)
    got = ps.upsample_into_phase(_t(x), mode)
    ref = np.asarray(jps.upsample_into_phase(jnp.asarray(x), mode))
    if mode == "nearest":
        np.testing.assert_array_equal(_j(got), ref)
        want = F.interpolate(_t(x), scale_factor=2, mode="nearest")
    else:
        _close(_j(got), ref)
        want = F.interpolate(_t(x), scale_factor=2, align_corners=False,
                             mode={2: "bilinear", 3: "trilinear"}[len(sp)])
    _close(ps.depth_to_space(got).numpy(), want.numpy())


def test_concat_commutes_with_the_phase_layout():
    rng = np.random.RandomState(5)
    a, b = _t(rng.randn(1, 4, 6, 2)), _t(rng.randn(1, 4, 6, 3))
    lhs = torch.cat([ps.space_to_depth(a), ps.space_to_depth(b)], 1)
    np.testing.assert_array_equal(lhs.numpy(), ps.space_to_depth(torch.cat([a, b], 1)).numpy())
    assert ps.phase_channels(lhs.shape[1], 2) == 5
    assert ps.conv_dimension_numbers(3) == ("NCDHW", "OIDHW", "NCDHW")


def test_phase_conv_gradients_match_jax_and_the_plain_conv():
    """dW flows from the phase weight's gradient back through the selection
    (the wgrad kernel's dW' on a card), dx through the phase conv."""
    rng = np.random.RandomState(6)
    x = rng.randn(1, 8, 6, 4, 3).astype(np.float32)
    w = (0.3 * rng.randn(3, 3, 3, 3, 5)).astype(np.float32)

    def jloss(ww, xx):
        return jnp.sum(jps.phase_conv(jps.space_to_depth(xx), ww) ** 2)
    gw_j, gx_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(x))

    xt, wt = _t(x).requires_grad_(True), _wt(w).requires_grad_(True)
    (ps.phase_conv(ps.space_to_depth(xt), wt) ** 2).sum().backward()
    _close(wt.grad.numpy(), _wt(np.asarray(gw_j)).numpy())
    _close(_j(xt.grad), np.asarray(gx_j))

    xp, wp = _t(x).requires_grad_(True), _wt(w).requires_grad_(True)
    (_plain_conv(xp, wp) ** 2).sum().backward()
    _close(wt.grad.numpy(), wp.grad.numpy())
    _close(xt.grad.numpy(), xp.grad.numpy())
