"""The solve's step from one CUDA graph on a card (``engine/solver.py``
``_StepGraph``): under deterministic cuDNN a graphed solve equals the eager
one bit for bit (history, ``out_best``, parameters, canvas), for the
MulResUnet with one lane and with 8 lanes, the skip net, parameter noise
with dropout, an optimised canvas and POCS; the probes' wrappers on
``_FlatParams.adam_step`` and ``solver._step`` see every step; the device
trace holds the port's kernels as many times as the eager solve's, while
the launch counters, which count calls from Python, count the eager and
the captured step only; ``graph_routes`` reads one eager step, one
captured and the rest replayed; sharded, ``virtual_input`` and
data-forgetting solves stay eager, and so does a step that cannot be
captured (it copies from the host); a checkpointed solve resumes exactly;
the peak of allocated memory is the eager solve's, within the benchmark's
bound.

Imports only torch and the port, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda_step_graph.py -q

Every test skips without a CUDA card (a CUDA graph has no CPU mode); the
CPU tests hold the rule that picks the graph (tests/test_torch_step_graph.py).
"""
import collections
import re
import warnings

import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.data import flagship_problem
from deep_prior_interpolation_tpu_torch.engine import solver as S
from deep_prior_interpolation_tpu_torch.models.skip import SkipNet
from deep_prior_interpolation_tpu_torch.ops import fused_loss as FL
from deep_prior_interpolation_tpu_torch.ops import norm_act as NA
from deep_prior_interpolation_tpu_torch.parallel import solve_patches_batched
from deep_prior_interpolation_tpu_torch.utils import spans

torch.set_num_threads(1)

# two chunks of 3: a solve runs whole chunks
EPOCHS = 6


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    monkeypatch.setenv("DPI_PALLAS_WGRAD", "1")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    return torch.device("cuda")


def _cfg(**kw) -> Config:
    base = dict(datadim="3d", inputdepth=8, filters=[8, 16, 32], skip=[4, 4],
                upsample="linear", epochs=EPOCHS, scan_chunk=3, fused_loss=True,
                dtype="bfloat16", gain=40.0)
    return Config(**{**base, **kw})


# the port's kernels by name in the device trace
PORT_KERNELS = re.compile(r"\b(loss_sums_kernel|loss_grad_kernel|"
                          r"norm_(?:stats|apply|grad_sums|grad)_kernel|"
                          r"upsample_bwd_(?:tma|direct)|wgrad3d_(?:mma|fma|sum))\b")


def _run(monkeypatch, graphs: bool, fn, trace: bool = False):
    """``fn()`` with the step graphs on or off: its result, the steps by
    route, the fused loss's launches counted from Python, and (``trace``)
    the port's kernels in the device trace by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    monkeypatch.setattr(S, "_GRAPHS", graphs)
    routes0 = dict(S.graph_routes)
    calls0 = FL.fused_sums.launches + FL.fused_sums_lanes.launches
    kernels = collections.Counter()
    if trace:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            res = fn()
            torch.cuda.synchronize()
        for e in prof.events():
            m = PORT_KERNELS.search(e.name) if e.device_type == DeviceType.CUDA else None
            if m:
                kernels[m.group(1)] += 1
    else:
        res = fn()
    routes = {k: n - routes0.get(k, 0) for k, n in S.graph_routes.items()
              if n != routes0.get(k, 0)}
    calls = FL.fused_sums.launches + FL.fused_sums_lanes.launches - calls0
    return res, routes, calls, kernels


def _same(a, b) -> None:
    """Two SolveResults bit for bit."""
    for f in a.history.FIELDS:
        assert np.array_equal(getattr(a.history, f), getattr(b.history, f)), f
    assert np.array_equal(a.out_best, b.out_best)
    assert a.params.keys() == b.params.keys()
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    assert (a.noise is None) == (b.noise is None)
    if a.noise is not None:
        assert np.array_equal(a.noise, b.noise)
    if a.pocs is not None:
        assert np.array_equal(a.pocs, b.pocs)
    assert a.iters_run == b.iters_run == EPOCHS


def _solo(cuda, cfg, shape=(32, 32, 32), **kw):
    img, mask = flagship_problem(*shape)
    return lambda: DIPSolver(cfg, device=cuda).solve(img, mask, seed=5, **kw)


def _compare(monkeypatch, fn):
    """The solve graphed and eager, after a first eager run that sets up
    what a shape's first call sets up (the wgrad tuner times its grids on
    the card): bit-equal results and the same kernels in the device trace,
    and Python's launch calls at the eager and the captured step only.
    Returns the graphed solve's step routes and its kernels."""
    _run(monkeypatch, False, fn)
    graphed, routes, calls, kernels = _run(monkeypatch, True, fn, trace=True)
    eager, routes_eager, calls_eager, kernels_eager = _run(monkeypatch, False, fn, trace=True)
    for a, b in zip(graphed if isinstance(graphed, list) else [graphed],
                    eager if isinstance(eager, list) else [eager]):
        _same(a, b)
    assert routes_eager == {"eager": EPOCHS}
    assert kernels == kernels_eager and kernels["loss_sums_kernel"] == EPOCHS
    assert calls_eager == EPOCHS and calls == 2
    return routes, kernels


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_one_lane_graphed_equals_eager(cuda, monkeypatch, dtype):
    routes, kernels = _compare(monkeypatch, _solo(cuda, _cfg(dtype=dtype)))
    assert routes == {"eager": 1, "captured": 1, "replayed": EPOCHS - 2}
    assert kernels["loss_grad_kernel"] == EPOCHS
    assert kernels["wgrad3d_mma"] + kernels["wgrad3d_fma"] > 0
    assert kernels["norm_apply_kernel"] > 0 and kernels["upsample_bwd_tma"] > 0


def test_eight_lanes_graphed_equals_eager(cuda, monkeypatch):
    cfg = _cfg()
    patches = []
    for i in range(8):
        img, mask = flagship_problem(16, 32, 32, seed=i)
        patches.append({"image": img, "mask": mask})
    routes, kernels = _compare(monkeypatch, lambda: solve_patches_batched(
        cfg, DIPSolver(cfg, device=cuda), patches))
    assert routes == {"eager": 1, "captured": 1, "replayed": EPOCHS - 2}
    assert kernels["wgrad3d_mma"] > 0 and kernels["norm_apply_kernel"] > 0


@pytest.mark.parametrize("down", ["stride", "lanczos2"])
def test_the_skip_net_graphed_equals_eager(cuda, monkeypatch, down):
    """The zoo's skip net from the config, bit for bit the eager solve; and
    with Lanczos downsampling (its taps made once a device, not copied at
    every call) captured without falling back to eager steps: its edge
    padding's backward sums with atomics, so two of its solves differ in
    rounding, graphed or not."""
    cfg = _cfg(net="skip", inputdepth=8, filters=[16, 16, 16], skip=[4, 4, 4])
    if down == "stride":
        routes, kernels = _compare(monkeypatch, _solo(cuda, cfg))
    else:
        model = SkipNet(8, 1, 3, (16, 16, 16), (4, 4, 4), pad="reflection",
                        upsample_mode="linear", downsample_mode=down)
        img, mask = flagship_problem(32, 32, 32)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res, routes, calls, kernels = _run(monkeypatch, True, lambda: DIPSolver(
                cfg, device=cuda, model=model).solve(img, mask, seed=5), trace=True)
        assert not [w for w in caught if "cannot be captured" in str(w.message)]
        assert calls == 2 and kernels["loss_sums_kernel"] == EPOCHS
        assert np.all(np.isfinite(res.history.loss))
    assert routes == {"eager": 1, "captured": 1, "replayed": EPOCHS - 2}
    assert kernels["norm_apply_kernel"] > 0


@pytest.mark.parametrize("kw", [dict(param_noise=True, dropout=0.1),
                                dict(dtype="float32", opt_over="net,input"),
                                dict(pocs=True, save_every=3)],
                         ids=["param_noise_dropout", "opt_input", "pocs"])
def test_the_options_graphed_equal_eager(cuda, monkeypatch, kw):
    routes, _ = _compare(monkeypatch, _solo(cuda, _cfg(**kw)))
    assert routes == {"eager": 1, "captured": 1, "replayed": EPOCHS - 2}


def test_the_probes_wrappers_see_every_step(cuda, monkeypatch):
    """A wrapper on the class's ``adam_step`` (the harness's AdamSpy) and
    one on the solver object's ``_step`` (its ChunkTracer) are called once a
    step, every step, graphed as eager."""
    img, mask = flagship_problem(32, 32, 32)
    calls = collections.Counter()
    real_adam = S._FlatParams.adam_step

    def adam_step(flat, *a, **k):
        calls["adam"] += 1
        return real_adam(flat, *a, **k)
    monkeypatch.setattr(S._FlatParams, "adam_step", adam_step)
    solver = DIPSolver(_cfg(), device=cuda)
    real_step, its = solver._step, []

    def step(it, *a, **k):
        its.append(it)
        return real_step(it, *a, **k)
    solver._step = step
    res, routes, _, _ = _run(monkeypatch, True, lambda: solver.solve(img, mask, seed=5))
    assert calls["adam"] == EPOCHS and its == list(range(EPOCHS))
    assert routes == {"eager": 1, "captured": 1, "replayed": EPOCHS - 2}
    assert len(res.history.loss) == EPOCHS


@pytest.mark.parametrize("kw", [dict(virtual_input=True), dict(data_forgetting_factor=3)],
                         ids=["virtual_input", "data_forgetting"])
def test_host_driven_steps_stay_eager(cuda, monkeypatch, kw):
    cfg = _cfg(dtype="float32", **kw)
    _, routes, _, _ = _run(monkeypatch, True, _solo(cuda, cfg))
    assert routes == {"eager": EPOCHS}


def test_a_sharded_solve_stays_eager(cuda, monkeypatch):
    from deep_prior_interpolation_tpu_torch.parallel import make_spatial_mesh
    img, mask = flagship_problem(32, 32, 32)
    solver = DIPSolver(_cfg(dtype="float32"), device=cuda)
    _, routes, _, _ = _run(monkeypatch, True, lambda: solver.solve(
        img, mask, seed=5, spatial_mesh=make_spatial_mesh(2, [cuda] * 2)))
    assert routes == {"eager": EPOCHS}


def test_a_checkpointed_solve_resumes_exactly(cuda, monkeypatch, tmp_path):
    """Cut after the first chunk and resumed in a new solve (whose first
    step is eager again): the straight graphed run's history and output."""
    img, mask = flagship_problem(32, 32, 32)
    cfg = _cfg()
    monkeypatch.setattr(S, "_GRAPHS", True)
    straight = DIPSolver(cfg, device=cuda).solve(img, mask, seed=5)
    ckpt = str(tmp_path / "state.npz")
    DIPSolver(_cfg(epochs=3), device=cuda).solve(img, mask, seed=5, checkpoint_path=ckpt,
                                                 checkpoint_every=1)
    resumed, routes, _, _ = _run(monkeypatch, True, lambda: DIPSolver(cfg, device=cuda).solve(
        img, mask, seed=5, checkpoint_path=ckpt))
    _same(resumed, straight)
    assert routes == {"eager": 1, "captured": 1, "replayed": EPOCHS - 5}


def test_the_spans_of_a_graphed_solve(cuda, monkeypatch):
    """Each step's route on its span; the first two steps' forward and
    backward in their spans, the later ones in ``step.replay`` with the
    captured step's Norm and weight-gradient counters."""
    monkeypatch.setattr(S, "_GRAPHS", True)
    spans.enable()
    try:
        _solo(cuda, _cfg())()
    finally:
        spans.disable()
    recs = spans.drain()
    kids = collections.defaultdict(list)
    for r in recs:
        kids[r.parent].append(r)
    steps = sorted((r for r in recs if r.name == "step"), key=lambda r: r.attrs["it"])
    assert [r.attrs["step_graph"] for r in steps] == \
        ["eager", "captured"] + ["replayed"] * (EPOCHS - 2)
    names = [[k.name for k in sorted(kids[r.id], key=lambda k: k.start_ns)] for r in steps]
    phases = ["step.forward", "step.backward"]
    assert names[0] == phases + ["step.adam", "step.track"]
    assert names[1] == phases + ["step.replay", "step.adam", "step.track"]
    assert all(n == ["step.replay", "step.adam", "step.track"] for n in names[2:])
    fwd = next(k for k in kids[steps[1].id] if k.name == "step.forward").attrs
    bwd = next(k for k in kids[steps[1].id] if k.name == "step.backward").attrs
    for step in steps[2:]:
        (replay,) = [k for k in kids[step.id] if k.name == "step.replay"]
        assert replay.attrs == {**fwd, **bwd} and replay.attrs["norm_kernel"] > 0


def test_a_capture_under_the_profiler(cuda, monkeypatch):
    """The harness's tracer profiles a chunk from the solve's first step,
    so the capture runs under the profiler: the device trace holds every
    step's Norms, while the route counter, counted from Python, holds the
    eager and the captured step's."""
    fn = _solo(cuda, _cfg())
    norms0 = NA.routes["kernel"]
    res, routes, _, kernels = _run(monkeypatch, True, fn, trace=True)
    per_step = (NA.routes["kernel"] - norms0) // 2
    assert routes == {"eager": 1, "captured": 1, "replayed": EPOCHS - 2}
    assert kernels["norm_apply_kernel"] == EPOCHS * per_step > 0   # one a Norm
    assert np.all(np.isfinite(res.history.loss))


class _HostConstant(torch.nn.Module):
    """A net of the caller's whose forward copies a constant from the host
    at every call: a step that no CUDA graph can capture."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv3d(8, 1, 3, padding=1)

    def forward(self, x):
        return self.conv(x) * torch.tensor(2.0).to(x.device)


def test_a_step_that_reads_the_host_stays_eager(cuda, monkeypatch):
    """Its capture fails: a warning, and the solve goes on eagerly from the
    state the capture left untouched, bit for bit the eager solve."""
    torch.manual_seed(0)
    model = _HostConstant()
    init = {k: v.clone() for k, v in model.state_dict().items()}
    img, mask = flagship_problem(32, 32, 32)

    def fn():
        return DIPSolver(_cfg(dtype="float32"), device=cuda, model=model).solve(
            img, mask, seed=5, init_params=init)
    with pytest.warns(RuntimeWarning, match="cannot be captured"):
        graphed, routes, calls, _ = _run(monkeypatch, True, fn)
    eager, routes_eager, calls_eager, _ = _run(monkeypatch, False, fn)
    _same(graphed, eager)
    assert routes == routes_eager == {"eager": EPOCHS}
    assert calls == calls_eager == EPOCHS


def test_the_graphed_peak_is_the_eager_peak(cuda, monkeypatch):
    """What is live at each moment of the step is the same: at a size whose
    peak of allocated memory passes 1 GiB, the graphed peak stays within
    0.01 GiB (under 1 %) of the eager one, the benchmark's bound on
    ``peak_mem_gib`` (the graph's pool adds reserved memory only)."""
    fn = _solo(cuda, _cfg(), shape=(128, 128, 128))
    peaks = {}
    for graphs in (False, True, False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _run(monkeypatch, graphs, fn)
        peaks.setdefault(graphs, []).append(torch.cuda.max_memory_allocated())
    assert min(peaks[False]) > 2 ** 30
    assert max(peaks[True]) <= min(peaks[False]) + 0.01 * 2 ** 30
