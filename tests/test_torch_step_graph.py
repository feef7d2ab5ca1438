"""The rule that runs a solve's step forward and backward from one CUDA graph
(``engine/solver.py`` ``takes_step_graph``), case by case, and what a CPU
solve shows of it: every step eager, the step spans as before with their
route. The graph itself runs on a card only (tests/test_torch_cuda_step_graph.py).
"""
import dataclasses

import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu_torch import Config, DIPSolver
from deep_prior_interpolation_tpu_torch.engine import solver as S
from deep_prior_interpolation_tpu_torch.engine.solver import StepSettings, takes_step_graph
from deep_prior_interpolation_tpu_torch.parallel import solve_patches_batched
from deep_prior_interpolation_tpu_torch.utils import spans

torch.set_num_threads(1)

CUDA0 = torch.device("cuda", 0)
CPU = torch.device("cpu")
PLAIN = StepSettings(reg_noise_std=0.03, fused_loss=True, input_shape=(1, 4, 16, 16, 16))


@pytest.mark.parametrize("device,mesh,spatial,settings,want", [
    (CUDA0, None, False, {}, True),
    ("cuda", None, False, {}, True),
    (CUDA0, [CUDA0], False, {}, True),
    (CPU, None, False, {}, False),
    (CPU, [CPU], False, {}, False),
    (CUDA0, [CUDA0, torch.device("cuda", 1)], False, {}, False),
    (CUDA0, [CUDA0, CUDA0], False, {}, False),
    (CUDA0, None, True, {}, False),
    (CUDA0, None, False, {"virtual_input": True}, False),
    (CUDA0, None, False, {"forget_factor": 5}, False),
    (CUDA0, None, False, {"param_noise": True, "pocs": True, "track_last": True}, True),
    (CUDA0, None, False, {"opt_input": True, "takes_mask": True, "conv_mode": "tapmm"}, True),
    (CUDA0, None, False, {"reg_noise_std": 0.0, "fused_loss": False, "loss": "mse"}, True),
], ids=["cuda", "cuda_by_name", "mesh_of_one", "cpu", "cpu_mesh", "two_cards",
        "one_card_twice", "spatial", "virtual_input", "data_forgetting", "noise_pocs_snapshots",
        "canvas_mask_tapmm", "no_noise_plain_loss"])
def test_the_rule(device, mesh, spatial, settings, want):
    s = dataclasses.replace(PLAIN, **settings)
    assert takes_step_graph(device, s, mesh, spatial) is want


def test_the_rule_reads_the_configs_settings():
    """``StepSettings.from_config`` drops ``virtual_input`` where the canvas
    is shaped or optimised, and then the step graph is taken."""
    kw = dict(datadim="3d", inputdepth=4, filters=[4, 8], skip=[4])
    shaped = StepSettings.from_config(Config(**kw, virtual_input=True, lowpass_fs=250,
                                             lowpass_fc=40), (16, 16, 16))
    raw = StepSettings.from_config(Config(**kw, virtual_input=True), (16, 16, 16))
    assert takes_step_graph(CUDA0, shaped) and not takes_step_graph(CUDA0, raw)


def _problem(seed, shape=(8, 16, 16)):
    rng = np.random.RandomState(seed)
    img = rng.randn(*shape, 1).astype(np.float32)
    mask = (rng.rand(*shape, 1) > 0.4).astype(np.float32)
    return img, mask


def _cfg(**kw) -> Config:
    return Config(**{**dict(datadim="3d", inputdepth=4, filters=[4, 8], skip=[4],
                            upsample="linear", epochs=4, scan_chunk=2), **kw})


@pytest.mark.parametrize("entry", ["solve", "batched"])
def test_a_cpu_solve_steps_eagerly(entry):
    """No graph off the card: every step counts as eager, carries the route
    on its span, and keeps the forward and backward spans; no step replays."""
    cfg = _cfg()
    before = dict(S.graph_routes)
    spans.enable()
    try:
        if entry == "solve":
            DIPSolver(cfg, device=CPU).solve(*_problem(0), seed=1)
        else:
            patches = [dict(zip(("image", "mask"), _problem(i))) for i in range(2)]
            solve_patches_batched(cfg, DIPSolver(cfg, device=CPU), patches)
    finally:
        spans.disable()
    recs = spans.drain()
    delta = {k: n - before.get(k, 0) for k, n in S.graph_routes.items()
             if n != before.get(k, 0)}
    assert delta == {"eager": 4}
    steps = [r for r in recs if r.name == "step"]
    assert [r.attrs for r in sorted(steps, key=lambda r: r.start_ns)] == \
        [{"it": i, "step_graph": "eager"} for i in range(4)]
    assert not any(r.name == "step.replay" for r in recs)
    for step in steps:
        kids = sorted((r for r in recs if r.parent == step.id), key=lambda r: r.start_ns)
        assert [r.name for r in kids] == ["step.forward", "step.backward", "step.adam",
                                          "step.track"]


def test_no_step_graph_off_the_card():
    assert S._step_graph([], CPU, StepSettings()) is None


def test_the_span_counters_a_replay_carries():
    """``_span_counts`` reads the counters that ``step.forward`` and
    ``step.backward`` report: its change over a step's forward and backward
    (what a replay's span carries of the captured step) is the sum of the
    two spans', step by step of a CPU solve."""
    assert set(S._span_counts()) == {"norm_kernel", "norm_plain", "norm_act_fused",
                                     "wgrad_kernel", "wgrad_library"}
    solver = DIPSolver(_cfg(), device=CPU)
    real, changes = solver._forward_backward, []

    def forward_backward(*a, **k):
        before = S._span_counts()
        res = real(*a, **k)
        changes.append({key: n - before[key] for key, n in S._span_counts().items()})
        return res
    solver._forward_backward = forward_backward
    spans.enable()
    try:
        solver.solve(*_problem(0), seed=1)
    finally:
        spans.disable()
    recs = spans.drain()
    steps = sorted((r for r in recs if r.name == "step"), key=lambda r: r.start_ns)
    summed = [{**next(r for r in recs if r.parent == step.id and r.name == "step.forward").attrs,
               **next(r for r in recs if r.parent == step.id and r.name == "step.backward").attrs}
              for step in steps]
    assert changes == summed and len(changes) == 4
    assert all(c["norm_plain"] > 0 and c["norm_kernel"] == 0 for c in changes)


def test_the_outputs_a_first_step_hands_on():
    """``_tensors`` finds every tensor of the step's outputs, in their
    tuples, lists and dicts, so each is marked for the caller's stream."""
    a, b, c, d = (torch.zeros(1) for _ in range(4))
    found = S._tensors(a, 1.0, {"snr": b, "x": None}, None, (c, [d]))
    assert [id(t) for t in found] == [id(a), id(b), id(c), id(d)]
