"""The skip net's reference (``reference/skipnet.py``) as the benchmark reads
it: its convs and FLOPs against ``torch.utils.flop_counter``, its controls,
the ``skip3d`` cell through the harness at a tiny size (sound, and each
fault caught), and the two metrics it brought (``library_wgrad_ms``,
``norm_pair_ms``) on a synthetic trace."""
from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts, faults, harness, traffic
from benchmark.reference import skipnet
from conftest import make_tiny, run_cpu

CELL = "skip3d.solo256"


def _net(quant=None):
    return skipnet.SkipNet(4, 1, 3, (8, 8, 8, 8, 8), (2, 2, 2, 2, 2), upsample="linear",
                           quant=quant)


def test_the_harness_finds_the_skip_net():
    cell = harness.load_cell(CELL)
    net = harness.reference_net(cell)
    assert isinstance(net, skipnet.SkipNet) and net.in_channels == 32
    assert net.filters == (128,) * 5 and net.skip == (4,) * 5 and net.linear


def test_layers_are_the_skip_nets():
    """Five convs a level (skip 1x1, stride-2, conv, up, 1x1) and the head;
    the stride-1 3x3x3 ones, which the wgrad kernel may take, are two a
    level: the up conv at the level's size, the conv at the next one's."""
    lay = counts.layers(_net(), (32, 32, 32))
    assert len(lay["convs"]) == 26 and len(lay["upsamples"]) == 5
    s1 = counts.wgrad_convs(lay)
    assert sorted((c["cin"], c["cout"], c["vout"]) for c in s1) == sorted(
        [(10, 8, 32 ** 3 >> 3 * i) for i in range(5)]
        + [(8, 8, 32 ** 3 >> 3 * i) for i in range(1, 6)])


def test_step_flops_are_the_convs():
    """flop_counter's count of a step is, conv by conv, its forward, its
    weight gradient and its data gradient, 2 k^3 Ci Co V_out each, but for
    the data gradients of the two convs that read the canvas (level 0's skip
    and stride-2 convs)."""
    net, shape = _net(), (32, 32, 32)
    lay = counts.layers(net, shape)
    per = [2 * c["k"] ** 3 * c["cin"] * c["cout"] * c["vout"] for c in lay["convs"]]
    assert counts.step_flops(net, shape, shape) == 3 * sum(per) - per[0] - per[1]
    params = {n: torch.randn(s, requires_grad=True) for n, s, _ in net.spec()}
    with FlopCounterMode(display=False) as fc:
        net(params, torch.randn((1, 4) + shape))
    assert fc.get_total_flops() == sum(per)


@pytest.mark.parametrize("quant", ["fp8", "tf32"])
def test_controls_run_and_part_from_float32(quant):
    """Each control runs forward and backward and parts from float32; TF32
    within 1e-2 of the largest output (fp8 may part by more than that)."""
    net, ref = _net(quant), _net()
    flat = traffic.weights(ref.spec(), 1, 2 ** 31 + 9, 0.02, "cpu")
    (params,) = traffic.state_dicts(ref.spec(), flat)
    x = torch.randn((1, 4, 32, 32, 32), generator=torch.Generator().manual_seed(1))
    p = {n: t.clone().requires_grad_(True) for n, t in params.items()}
    out = net(p, x)
    (g,) = torch.autograd.grad(out.abs().mean(), [p["Conv_0.kernel"]])
    with torch.no_grad():
        want = ref(params, x)
    assert torch.isfinite(out).all() and torch.isfinite(g).all()
    err = float((out.detach() - want).abs().max()) / float(want.abs().max())
    assert 0 < err < (1e-2 if quant == "tf32" else float("inf"))


@pytest.mark.parametrize("seed", [2 ** 31 + 3, 2 ** 32 + 17])
def test_fp8_control_is_not_correct(tmp_path, seed):
    tiny = harness.load_cell(make_tiny(tmp_path, CELL), tmp_path)
    c = tiny["config"]["config"]
    spec = harness.reference_net(tiny).spec()
    (prob,) = traffic.make_pool(tiny["traffic"], spec, c["gain"], c["initgain"], seed, "cpu")
    ref = harness.reference_lanes(tiny, prob, "cpu")
    control = harness.reference_lanes(tiny, prob, "cpu", quant=tiny["config"]["control"])
    readings = harness.compare(control, ref)
    assert any(readings[k] > v for k, v in tiny["workload"]["limits"].items()), readings


@pytest.mark.parametrize("fault", (None,) + faults.NAMES)
def test_fault_makes_a_run_incorrect(tmp_path, fault):
    name = make_tiny(tmp_path, CELL)
    if fault is None:
        rc, res, _ = run_cpu(tmp_path, name)
        assert rc == 0 and res["correct"], res["check"]
        return
    with faults.planted(fault, lanes=False):
        rc, res, _ = run_cpu(tmp_path, name)
    assert rc == 0 and not res["correct"], res["check"]


def _rec(names, steps=2):
    trace = SimpleNamespace(kernels=[(n, 1e-3) for n in names])
    return SimpleNamespace(trace=trace, steps_traced=steps)


KERNELS = [
    "void (anonymous namespace)::wgrad3d_mma<3, 2, 8>(unsigned short const*)",
    "void (anonymous namespace)::wgrad3d_sum(float const*, float*)",
    "sm90_xmma_wgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32_ndhwc_kernel",
    "void cudnn::cnn::convolveNd_wgrad_engine<__nv_bfloat16, 3, 128>(...)",
    "void wgrad_alg1_nd_float_engine<float, float, 3, 0, 5, 7, 4, 3>(...)",
    "void (anonymous namespace)::norm_stats_kernel<unsigned short>(...)",
    "void (anonymous namespace)::norm_apply_kernel<unsigned short>(...)",
    "void (anonymous namespace)::norm_grad_sums_kernel<unsigned short>(...)",
    "void (anonymous namespace)::norm_grad_kernel<unsigned short, float>(...)",
    "sm80_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
    "void at::native::batch_norm_collect_statistics_kernel<float>(...)",
]


def test_new_metrics_read_a_trace_by_kernel_name():
    from benchmark.metrics import library_wgrad_ms, norm_pair_ms
    rec = _rec(KERNELS)
    # 1 ms each, over 2 steps: three library wgrad kernels, four Norm kernels
    assert library_wgrad_ms.read(rec) == pytest.approx(1.5)
    assert norm_pair_ms.read(rec) == pytest.approx(2.0)
    assert library_wgrad_ms.read(_rec(KERNELS[:2])) == 0.0
    assert norm_pair_ms.read(_rec(KERNELS[:5])) == 0.0


def test_new_metrics_are_silent_without_a_trace():
    from benchmark.metrics import library_wgrad_ms, norm_pair_ms
    for m in (library_wgrad_ms, norm_pair_ms):
        assert m.read(SimpleNamespace(trace=None, steps_traced=0)) is None
        assert m.read(_rec(KERNELS, steps=0)) is None
