"""The grid plans of the port's 3D wgrad kernel (ops/wgrad.py ``_plans``): the
blocks and warps (threads for float32) of every candidate launch cover every
(co, ci, tap, D plane, H row) exactly once and fit the card's limits. This
file holds the check and the flagship's full and half resolution (bf16, and
float32 at half resolution); tests/test_torch_wgrad_plan_deep.py the three
deepest levels, tests/test_torch_wgrad_plan_edges.py the edge shapes (each
file at 17 tests or fewer). The kernel itself is held against its plain
version on a card (tests/test_torch_cuda_wgrad.py)."""
import numpy as np
import pytest
import torch

from deep_prior_interpolation_tpu_torch.ops import wgrad as WG

torch.set_num_threads(1)


# the 3x3x3 stride-1 convs of the flagship MulResUnet 3D (filters
# [16, 32, 64, 128, 256], skip [16, 32, 64, 128]): (Ci, Co, spatial)
FLAGSHIP = [(ci, co, sp) for sp, pairs in [
    ((256, 128, 128), [(64, 4), (4, 8), (8, 13), (25, 16), (67, 4), (25, 1)]),
    ((128, 64, 64), [(25, 8), (8, 17), (17, 26), (51, 32), (137, 8)]),
    ((64, 32, 32), [(51, 17), (17, 35), (35, 53), (105, 64), (276, 17)]),
    ((32, 16, 16), [(105, 35), (35, 71), (71, 106), (212, 128), (554, 35)]),
    ((16, 8, 8), [(212, 71), (71, 142), (142, 213)]),
] for ci, co in pairs]


def check_plan(ci, co, sp, k, bf16):
    """Every candidate grid the wrapper may time (float32: the first two,
    whose per-thread tiles are slow to list)."""
    pls = WG._plans(ci, co, *sp, k, bf16)
    for pl in pls if bf16 else pls[:2]:
        _check_one(pl, sp, k)


def _check_one(pl, sp, k):
    d, h, w = sp
    taps = k ** 3
    assert pl.smem <= 227 * 1024 and pl.threads <= WG._MAX_THREADS[pl.mt]
    # bands are odd, or even with S staged flat
    assert (pl.hb % 2 == 1 or pl.scs != pl.hb * pl.rsw) and pl.rsw >= w
    assert pl.splits == pl.bands * pl.dranges
    flat, region = [], {}
    for t in WG.plan_tiles(pl):
        key = (t.planes, t.rows)
        assert region.setdefault(t.split, key) == key   # one region a split
        if t.s_ch and t.r_ch:
            idx = ((t.split * pl.sc + np.array(t.s_ch)[:, None, None]) * pl.rc
                   + np.array(t.r_ch)[None, :, None]) * taps + np.array(t.taps)
            flat.append(idx.ravel())
    counts = np.bincount(np.concatenate(flat),
                         minlength=pl.splits * pl.sc * pl.rc * taps)
    assert counts.min() == 1 and counts.max() == 1
    cover = np.zeros((d, h), np.int32)
    for planes, rows in region.values():
        cover[planes.start:planes.stop, rows.start:rows.stop] += 1
    assert len(region) == pl.splits and cover.min() == 1 and cover.max() == 1


@pytest.mark.parametrize("ci,co,sp", FLAGSHIP[:11])
def test_plan_covers_each_output_and_position_once(ci, co, sp):
    check_plan(ci, co, sp, 3, True)
    if sp[0] < 256:
        check_plan(ci, co, sp, 3, False)
