"""The port's conv formulations (ops/conv_vjp.py) against the JAX
package's: tapmm (the conv as a float32 matrix product a kernel tap), the
packed and the folded weight gradients, the packed gate ``_use_packed``,
the ``conv_impl`` context, the order in which the backward picks its weight
gradient, and ``conv_same`` with per-dim (lo, hi) padding.

Numpy inputs from a seed; the port is channels-first, so JAX's (N, *sp, C)
and (*k, Ci, Co) arrays are moved into (N, C, *sp) and (Co, Ci, *k).
float32 sums of the same products in other orders: 1e-5 of the largest
value; bf16: one bf16 rounding (2^-8 of each value) of the same float32
sum."""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deep_prior_interpolation_tpu.ops import conv_vjp as jcv
from deep_prior_interpolation_tpu_torch.ops import conv_vjp as cv

torch.set_num_threads(1)

TOL = 1e-5
_CONV = {2: F.conv2d, 3: F.conv3d}
_DW = {2: torch.nn.grad.conv2d_weight, 3: torch.nn.grad.conv3d_weight}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a, np.float32), -1, 1)))


def _w(a):
    d = a.ndim - 2
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(a, np.float32), (d + 1, d) + tuple(range(d)))))


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def _inputs(sp, ci, co, k, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(1, *sp, ci).astype(np.float32)
    w = (0.3 * rng.randn(*(k,) * len(sp), ci, co)).astype(np.float32)
    return x, w


def _reference(x, w, stride, pads):
    """PyTorch's own conv and its gradients (the explicit pad, then a conv)."""
    x, w = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    flat = [v for p in reversed(pads) for v in p]
    y = _CONV[w.ndim - 2](F.pad(x, flat), w, stride=stride)
    gx, gw = torch.autograd.grad((y ** 2).sum(), (x, w))
    return y.detach(), gx, gw


def _port(x, w, stride, pads, mode="conv"):
    x, w = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    with cv.conv_impl(mode):
        y = cv.conv_same(x, w, stride, pads)
    gx, gw = torch.autograd.grad((y ** 2).sum(), (x, w))
    return y.detach(), gx, gw


# (spatial, Ci, Co, k, stride, pads): a same-pad conv, the stride-2 down
# conv, an exit-like conv with (1, 0) pads, the phase entry conv
TAP_CASES = [((8, 6, 6), 4, 5, 3, 1, ((1, 1),) * 3), ((8, 6, 6), 4, 5, 3, 2, ((1, 1),) * 3),
             ((8, 6), 3, 4, 2, 1, ((1, 0), (1, 0))), ((8, 8, 4), 3, 8, 4, 2, ((1, 1),) * 3)]


@pytest.mark.parametrize("case", TAP_CASES)
def test_tapmm_and_asymmetric_pads_match_the_conv(case):
    sp, ci, co, k, stride, pads = case
    x, w = _inputs(sp, ci, co, k)
    ref = _reference(_t(x), _w(w), stride, pads)
    for mode in ("conv", "tapmm"):
        for got, want in zip(_port(_t(x), _w(w), stride, pads, mode), ref):
            _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tapmm_matches_jax_tap_conv(dtype):
    """Both accumulate every tap's product in float32 and round once."""
    x, w = _inputs((8, 6, 6), 5, 6, 3, seed=1)
    pads = ((1, 1),) * 3
    jdt = getattr(jnp, dtype)
    prec = None if dtype == "bfloat16" else jcv.lax.Precision.HIGHEST
    ref = np.asarray(jcv._tap_conv(jnp.asarray(x, jdt), jnp.asarray(w, jdt), 1, pads, prec),
                     np.float32)
    tdt = getattr(torch, dtype)
    got = cv._tap_conv(_t(x).to(tdt), _w(w).to(tdt), 1, pads)
    assert got.dtype == tdt
    got = np.moveaxis(got.float().numpy(), 1, -1)
    if dtype == "float32":
        _close(got, ref)
    else:  # the float32 sums agree to ~1e-6; their bf16 roundings to one ulp
        assert np.all(np.abs(got - ref) <= 2.0 ** -8 * np.abs(ref) + 1e-6)


def _jax_dy(x, w, stride, pads, seed=2):
    y = np.asarray(jcv.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride,) * (w.ndim - 2), list(pads),
        dimension_numbers=jcv._dn(w.ndim - 2)))
    return np.random.RandomState(seed).randn(*y.shape).astype(np.float32)


@pytest.mark.parametrize("sp,k,cap", [((8, 6, 6), 3, "512"), ((40, 40, 24), 3, "1")])
def test_packed_wgrad_matches_jax_and_the_library(sp, k, cap, monkeypatch):
    """The second case's canvases exceed a 1 MB cap: a group a tap."""
    monkeypatch.setenv("DPI_WGRAD_CAP_MB", cap)
    x, w = _inputs(sp, 3, 16, k, seed=3)
    pads = ((1, 1),) * 3
    dy = _jax_dy(x, w, 1, pads)
    ref = np.asarray(jcv._packed_wgrad(jnp.asarray(x), jnp.asarray(dy), w.shape, 1, pads))
    got = cv._packed_wgrad(_t(x), _t(dy), tuple(_w(w).shape), 1, pads)
    assert got.dtype == torch.float32
    _close(got.numpy(), _w(ref).numpy())
    lib = _DW[3](_t(x), _w(w).shape, _t(dy), stride=1, padding=1)
    _close(got.numpy(), lib.numpy())
    if cap == "1":
        assert cv._tap_groups(27, 42 * 42 * 26, 16, 4) == (1, 27)


@pytest.mark.parametrize("sp,k,pad", [((8, 8, 4), 4, 1), ((9, 7), 3, 1)])
def test_folded_wgrad_matches_jax_and_the_library(sp, k, pad):
    """The phase entry conv (k + 1 = 4, stride 2) and the odd-sized down conv."""
    d = len(sp)
    x, w = _inputs(sp, 3, 5, k, seed=4)
    pads = ((pad, pad),) * d
    dy = _jax_dy(x, w, 2, pads)
    ref = np.asarray(jcv._folded_wgrad(jnp.asarray(x), jnp.asarray(dy), w.shape, 2, pads))
    got = cv._folded_wgrad(_t(x), _t(dy), tuple(_w(w).shape), 2, pads)
    _close(got.numpy(), _w(ref).numpy())
    lib = _DW[d](_t(x), _w(w).shape, _t(dy), stride=2, padding=pad)
    _close(got.numpy(), lib.numpy())


def test_use_packed_decides_as_jax(monkeypatch):
    """Over shapes, dtypes and every setting of the three switches."""
    from jax import ShapeDtypeStruct
    shapes = [((1, 64, 64, 32), (3, 3, 3), 4, 8, 1, 1), ((1, 64, 64, 32), (4, 4, 4), 4, 8, 2, 1),
              ((1, 256, 128, 128), (3, 3, 3), 25, 16, 1, 1),
              ((1, 256, 128, 128), (4, 4, 4), 64, 32, 2, 1),
              ((1, 17, 9, 5), (3, 3, 3), 4, 8, 2, 1), ((1, 32, 24), (1, 1), 7, 3, 1, 0)]
    n = 0
    for packed in ("0", "1"):
        for fold in ("0", "1"):
            for cap in ("512", "8"):
                monkeypatch.setenv("DPI_PACKED_WGRAD", packed)
                monkeypatch.setenv("DPI_FOLD_WGRAD", fold)
                monkeypatch.setenv("DPI_WGRAD_CAP_MB", cap)
                for xs, ks, ci, co, stride, p in shapes:
                    pads = ((p, p),) * len(ks)
                    for dt, size in ((jnp.bfloat16, 2), (jnp.float32, 4)):
                        jx = ShapeDtypeStruct(xs[:1] + xs[1:] + (ci,), dt)
                        jw = ShapeDtypeStruct(ks + (ci, co), dt)
                        want = jcv._use_packed(jx, jw, stride, pads)
                        got = cv._use_packed((xs[0], ci) + xs[1:], (co, ci) + ks, stride, pads,
                                             size)
                        assert got == want, (packed, fold, cap, xs, ks, stride, dt)
                        n += want
    assert n > 0   # some shapes take the packed form


def test_conv_impl_restores_on_exit_and_is_the_calling_threads():
    assert cv.current_conv_impl() == "conv"
    seen = {}

    def other():
        seen["other"] = cv.current_conv_impl()
    with cv.conv_impl("tapmm"):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        with cv.conv_impl("conv"):
            assert cv.current_conv_impl() == "conv"
        assert cv.current_conv_impl() == "tapmm"
    assert seen["other"] == "conv" and cv.current_conv_impl() == "conv"
    with pytest.raises(RuntimeError):
        with cv.conv_impl("tapmm"):
            raise RuntimeError("boom")
    assert cv.current_conv_impl() == "conv"
    with pytest.raises(ValueError):
        with cv.conv_impl("grouped"):
            pass


def test_the_backward_takes_the_forwards_formulation_on_another_thread(monkeypatch):
    """Autograd runs a CUDA backward on a thread of its own: the conv
    records its formulation when it runs, so the backward follows it."""
    calls = []
    real = cv._tap_conv_input

    def spy(*a):
        calls.append(threading.get_ident())
        return real(*a)
    monkeypatch.setattr(cv, "_tap_conv_input", spy)
    x, w = _inputs((6, 6, 4), 3, 4, 3, seed=5)
    xt, wt = _t(x).requires_grad_(True), _w(w).requires_grad_(True)
    with cv.conv_impl("tapmm"):
        y = cv.conv_same(xt, wt, 1, 1)
    t = threading.Thread(target=lambda: (y ** 2).sum().backward())
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and len(calls) == 1 and calls[0] != threading.get_ident()
    ref = _reference(_t(x), _w(w), 1, ((1, 1),) * 3)
    _close(xt.grad, ref[1])
    _close(wt.grad, ref[2])


def test_the_weight_gradient_order(monkeypatch):
    """The wgrad kernel first (its gate), then the packed or folded form
    (``_use_packed``), then the library; tapmm's own dW last of all."""
    used = []
    for name in ("wgrad3d", "_packed_wgrad", "_folded_wgrad", "_tap_conv_weight"):
        real = getattr(cv, name)
        monkeypatch.setattr(cv, name, lambda *a, _n=name, _r=real: (used.append(_n), _r(*a))[1])
    x, w = _inputs((8, 6, 6), 3, 4, 3, seed=6)

    def run(stride, mode="conv", **env):
        for key in ("DPI_PALLAS_WGRAD", "DPI_PACKED_WGRAD", "DPI_FOLD_WGRAD"):
            monkeypatch.setenv(key, env.get(key.split("_")[1].lower(), "0"))
        used.clear()
        got = _port(_t(x), _w(w), stride, ((1, 1),) * 3, mode)
        _close(got[2], _reference(_t(x), _w(w), stride, ((1, 1),) * 3)[2])
        return list(used)
    assert run(1, pallas="1", packed="1") == ["wgrad3d"]
    assert run(1, packed="1") == ["_packed_wgrad"]
    assert run(2, pallas="1", packed="1") == []               # no fold: the library
    # the fold, then the packed dW of the folded conv
    assert run(2, pallas="1", packed="1", fold="1") == ["_folded_wgrad", "_packed_wgrad"]
    assert run(1) == []
    assert run(1, "tapmm") == ["_tap_conv_weight"]
    assert run(1, "tapmm", pallas="1") == ["wgrad3d"]
