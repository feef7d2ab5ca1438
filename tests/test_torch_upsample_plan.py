"""The upsample backward's launch planner (``ops/upsample.py`` ``plan``):
pure Python, no card. For every shape the port launches, the plan is one a
card takes (TMA's 16-byte rules, box dims, shared memory, grid limits, a D
range no shorter than the planner allows), the TMA kernel is taken exactly
where TMA can read the gradient, and a TMA grid covers every input sample
once."""
import itertools

import pytest

from deep_prior_interpolation_tpu_torch.ops import upsample as U

_L = [(128, 64, 64), (64, 32, 32), (32, 16, 16), (16, 8, 8), (8, 4, 4)]
# (planes, input spatial) of each path's linear upsamples
SHAPES = {
    # the flagship MulResUnet (256, 128, 128): one backward an upsample an iteration
    "main": [(426, _L[3]), (212, _L[2]), (105, _L[1]), (51, _L[0])],
    # the phase-space flagship keeps the two coarsest upsamples plain
    "phase": [(426, _L[3]), (212, _L[2])],
    # 8 lanes of (128, 64, 64) patches, folded into the planes
    "lanes": [(8 * 426, _L[4]), (8 * 212, _L[3]), (8 * 105, _L[2]), (8 * 51, _L[1])],
    # the lines gather (170, 100) through the 2D MulResUnet with bilinear
    # upsampling, at B = 1, 32 and 64 lanes
    "lines": [(b * c, hw) for b in (1, 32, 64)
              for c, hw in ((426, (11, 7)), (212, (22, 14)), (105, (44, 28)), (51, (88, 56)))],
    # the zoo at the flagship volume: skip and unet (3D), attmultiunet on the lines (2D)
    "zoo": [(256, (8, 4, 4)), (256, (16, 8, 8)), (128, (32, 16, 16)), (64, (64, 32, 32)),
            (32, (128, 64, 64))] + [(1, (s, s)) for s in (1, 2, 4, 8)]
           + [(1, hw) for hw in ((11, 7), (22, 14), (44, 28), (88, 56))],
}
MAX_GRID_X = 2 ** 31 - 1


def _dhw(sp):
    return (1,) + tuple(sp) if len(sp) == 2 else tuple(sp)


def _check(p, planes, sp, esz):
    d, h, w = _dhw(sp)
    has_d = len(sp) == 3
    assert 1 <= p.blocks <= MAX_GRID_X and 1 <= p.threads <= 1024
    if p.kernel == "direct":
        assert p.smem <= 48 * 1024 and p.cfg == -1 and p.box == ()
        assert (_ceil(d, p.span) if has_d else 1) <= 65535
        return
    tw, th, k, pl = U.TMA_CONFIGS[p.cfg]
    assert (p.tw, p.th) == (tw, th) and p.threads % 32 == 0
    # the box: inner extent a multiple of 16 bytes, every dim at most 256,
    # reaching from 16 bytes left of the tile to past its one-sample halo
    assert (p.box[0] * esz) % 16 == 0 and max(p.box) <= 256
    assert p.box[0] * esz >= 2 * tw * esz + 16 + esz and p.box[1] == 2 * th + 2
    assert p.box[-1] == pl and (p.box[2] == 2 if has_d else True)
    assert U._BAR_BYTES + p.stages * 128 <= p.smem <= U._SMEM_BLOCK
    units = d if has_d else _ceil(planes, pl)
    assert 1 <= p.stages <= U._MAX_STAGES and p.stages <= min(p.span, units) + has_d
    assert min(units, U._MIN_SPAN) <= p.span <= units


def _ceil(a, b):
    return -(-a // b)


@pytest.mark.parametrize("path", sorted(SHAPES))
def test_every_launched_shape_has_a_valid_plan(path):
    for (planes, sp), esz in itertools.product(SHAPES[path], (2, 4)):
        d, h, w = _dhw(sp)
        p = U.plan(planes, d, h, w, len(sp) == 3, esz)
        _check(p, planes, sp, esz)
        # TMA exactly where TMA can read the gradient
        assert (p.kernel == "tma") == ((2 * w * esz) % 16 == 0), (path, planes, sp, esz)


@pytest.mark.parametrize("path", ["main", "lanes"])
def test_the_main_and_lane_shapes_take_the_tma_kernel(path):
    for (planes, sp), esz in itertools.product(SHAPES[path], (2, 4)):
        assert U.plan(planes, *sp, True, esz).kernel == "tma"


def test_tma_only_where_the_rows_are_a_multiple_of_16_bytes():
    # 2 W x elem bytes: 16, 28, 56, 112 (bf16); 16, 56 (float32)
    for w, esz, tma in ((4, 2, True), (7, 2, False), (14, 2, False), (28, 2, True),
                        (2, 4, True), (7, 4, False)):
        assert U.tma_readable(w, esz) == tma
        p = U.plan(6, 3, 5, w, True, esz)
        assert p.kernel == ("tma" if tma else "direct")
        _check(p, 6, (3, 5, w), esz)


def test_an_unaligned_base_takes_the_direct_kernel():
    assert not U.tma_readable(64, 2, ptr=0x1002)
    p = U.plan(51, 128, 64, 64, True, 2, aligned=False)
    assert p.kernel == "direct"
    _check(p, 51, (128, 64, 64), 2)


@pytest.mark.parametrize("planes, sp", [(3, (5, 9, 16)), (17, (1, 20, 36)), (40, (5, 4)),
                                        (5, (2, 33, 64))])
def test_a_tma_grid_covers_every_input_sample_once(planes, sp):
    d, h, w = _dhw(sp)
    has_d = len(sp) == 3
    for esz in (2, 4):
        p = U.plan(planes, d, h, w, has_d, esz)
        assert p.kernel == "tma"
        tw, th, _, pl = U.TMA_CONFIGS[p.cfg]
        tiles_w, tiles = _ceil(w, tw), _ceil(w, tw) * _ceil(h, th)
        groups = _ceil(planes, pl) if has_d else 1
        units = d if has_d else _ceil(planes, pl)
        seen = []
        # the kernel's own decomposition of blockIdx.x (csrc/upsample.cu)
        for b in range(p.blocks):
            tile, rest = b % tiles, b // tiles
            grp, first = rest % groups, (rest // groups) * p.span
            w0, h0 = (tile % tiles_w) * tw, (tile // tiles_w) * th
            for k in range(min(p.span, units - first)):
                for q in range(pl):
                    plane, i = ((grp * pl + q, first + k) if has_d
                                else ((first + k) * pl + q, 0))
                    if plane >= planes:
                        continue
                    seen += [(plane, i, y, x) for y in range(h0, min(h0 + th, h))
                             for x in range(w0, min(w0 + tw, w))]
        assert sorted(seen) == sorted(itertools.product(range(planes), range(d), range(h),
                                                        range(w)))


def test_a_d_range_shorter_than_the_ring():
    # D = 1 (one D plane, two loads) and D = 2 in 3D: the ring holds no more
    # boxes than a block loads
    for d in (1, 2):
        p = U.plan(4, d, 16, 64, True, 2)
        assert p.kernel == "tma" and p.span == d and p.stages <= d + 1
    # forced: a ring deeper than the range is cut to the loads only if not given
    assert U.tma_plan(4, 1, 16, 64, True, 2, 0).stages == 2


def test_the_plan_depends_on_the_shape_alone():
    a = U.plan(51, 128, 64, 64, True, 2)
    U.plan.cache_clear()
    assert U.plan(51, 128, 64, 64, True, 2) == a == U.tma_plan(51, 128, 64, 64, True, 2, 0)
