"""3D conv weight gradient: a CUDA kernel for sm_90a and its plain version.

Replaces the Pallas TPU kernel ``deep_prior_interpolation_tpu/ops/pallas_wgrad.py``
(``_make_kernel`` via ``_pallas_wgrad_unpadded``, entry ``pallas_wgrad_s1``).
The kernel source, with its design and what bounds it on an H100, is
``csrc/wgrad3d.cu``; ``ops/_build.py`` compiles it with ``nvcc`` at first use.

Layout is the port's: ``x`` (1, Ci, D, H, W) and ``dy`` (1, Co, D, H, W), both
bfloat16 or both float32, give dW (Co, Ci, k, k, k) in float32, for a same-pad
stride-1 conv with an odd cubic kernel ``k``:

    dW[co, ci, t] = sum_s dy[co, s] * x[ci, s + t - p],   p = (k - 1) // 2

The kernel streams one operand (S) through shared memory once, plane by
plane along D, and keeps the other (R) in a ring of planes, shifted by the
tap; all k^3 taps of a block accumulate in registers. When S is x the sum
is rewritten as ``dW[co, ci, t] = sum_s x[ci, s] * dy[co, s + t' - p]`` with
the tap flipped (``t' = k - 1 - t`` on each axis). ``_plans`` lays out the
candidate grids in Python: which operand is S, channel tiles, tap blocks,
bands of H rows (odd, or with S staged flat also 2, 4, 8 or 16 rows that
divide H) and ranges of D planes. A launch of one split (band x D range)
writes dW; up to ``_MAX_CLUSTER`` splits add their sums in a thread-block
cluster; more write float32 workspace planes that a second kernel adds in a
fixed order.
``plan_tiles`` lists what every block and warp covers, so a CPU test can
check that each plan covers each (co, ci, tap, plane, position) once.

At a shape's first call on a card the wrapper times the candidate grids
(``_tune``) and keeps the fastest for that shape, so later calls give
bit-identical results. Another process may pick another grid, whose sums
differ in rounding order only; so ``tuned_plans`` lists the kept grids in a
JSON form and ``pin_plans`` hands them to another process (the solver's
checkpoint carries them), which then never times a pinned shape.

``wgrad3d`` takes the plain version for tensors on the CPU and launches the
kernel for CUDA tensors (``wgrad3d.launches`` counts the launches).

``wgrad3d_lanes`` is the same for B lanes at once, the counterpart of the
batching rule of ``pallas_call`` under ``jax.vmap`` (a grid dimension for
the lane): x (B, Ci, D, H, W) and dy (B, Co, D, H, W) give dW (B, Co, Ci, k,
k, k) in one launch (``wgrad3d_lanes.launches``), lane b's from lane b's
inputs alone and bit-identical to a one-lane launch of the same grid. The
planner weighs the lanes as more blocks of the same grid, so the grid it
keeps for B lanes is keyed by the lane shape, and a pinned grid names it.
``wgrad_supported`` is the gate ``conv_vjp.conv_same`` applies before it asks
for the kernel: Hopper's own rules, not the TPU's ``H, W % 8`` and VMEM ones.
"""
from __future__ import annotations

import ctypes
import functools
import warnings
from typing import Any, Dict, Iterator, List, NamedTuple, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["pin_plans", "tuned_plans", "wgrad3d", "wgrad3d_lanes", "wgrad3d_lanes_plain",
           "wgrad3d_plain", "wgrad_supported"]

_MAX_K = 7                  # odd k up to 7
_SMS = 132                  # H100 SXM
_SMEM_MAX = 227 * 1024      # the most a block may have
_MAX_CLUSTER = 8            # splits the kernel sums in a cluster, without a workspace

Padding = Union[int, Sequence[int], Sequence[Tuple[int, int]]]


def _pairs(padding: Padding, nd: int) -> Tuple[Tuple[int, int], ...]:
    if isinstance(padding, int):
        return ((padding, padding),) * nd
    return tuple((p, p) if isinstance(p, int) else tuple(p) for p in padding)


def wgrad_supported(x_shape: Sequence[int], w_shape: Sequence[int], stride: int,
                    padding: Padding) -> bool:
    """Gate: 3D, batch 1, stride 1, odd cubic kernel 1 < k <= 7, symmetric
    same-pad zero padding. Any Ci, Co, D and H; W as long as a band of one
    row and its ring of R planes fit in shared memory (W of a few hundred)."""
    if len(w_shape) != 5 or len(x_shape) != 5 or stride != 1 or x_shape[0] != 1:
        return False
    k = w_shape[2]
    if k % 2 == 0 or not 1 < k <= _MAX_K or w_shape[3] != k or w_shape[4] != k:
        return False
    p = (k - 1) // 2
    if _pairs(padding, 3) != ((p, p),) * 3:
        return False
    try:
        for bf16 in (True, False):
            _plan(x_shape[1], w_shape[0], *x_shape[2:], k, bf16)
    except ValueError:
        return False
    return True


def wgrad3d_plain(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """Per-tap shifted slices and a float32 matmul; independent of cuDNN."""
    _, ci, d, h, w = x.shape
    co = dy.shape[1]
    p = (k - 1) // 2
    xp = F.pad(x[0].float(), (p, p, p, p, p, p))
    dyf = dy[0].float().reshape(co, -1)
    dw = torch.empty((co, ci, k, k, k), dtype=torch.float32, device=x.device)
    for t0 in range(k):
        for t1 in range(k):
            for t2 in range(k):
                xs = xp[:, t0:t0 + d, t1:t1 + h, t2:t2 + w].reshape(ci, -1)
                dw[:, :, t0, t1, t2] = dyf @ xs.T
    return dw


def wgrad3d_lanes_plain(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """dW (B, Co, Ci, k, k, k) float32 of B lanes: per-tap shifted slices and
    one float32 batched matmul a tap; independent of cuDNN."""
    b, ci, d, h, w = x.shape
    co = dy.shape[1]
    p = (k - 1) // 2
    xp = F.pad(x.float(), (p, p, p, p, p, p))
    dyf = dy.float().reshape(b, co, -1)
    dw = torch.empty((b, co, ci, k, k, k), dtype=torch.float32, device=x.device)
    for t0 in range(k):
        for t1 in range(k):
            for t2 in range(k):
                xs = xp[:, :, t0:t0 + d, t1:t1 + h, t2:t2 + w].reshape(b, ci, -1)
                dw[:, :, :, t0, t1, t2] = torch.bmm(dyf, xs.transpose(1, 2))
    return dw


class Plan(NamedTuple):
    """The grid of one launch. S: the streamed operand (x when
    ``x_streams``, else dy), R: the shifted one, in a ring of planes.

    bf16: a warp holds ``mt`` m-tiles of 16 S channels x ``rcw`` R channels
    x ``tpw`` taps (n-tiles of 8 columns: ``rcw`` channels x 8 / ``rcw``
    taps); a block ``mg`` x ``nb`` such warp tiles times ``wt`` tap groups. float32: a thread holds 4 S x 4 R channels x k taps
    (the t2 row); a block ``cs4`` x ``cr4`` such threads times ``wt`` (t0, t1)
    pairs. Either way the block holds ``cs`` S and ``cr`` R channels, ``t0b``
    planes of taps (t0), a band of ``hb`` rows and ``planes`` D planes."""
    bf16: bool
    x_streams: bool
    sc: int          # S channels
    rc: int          # R channels
    d: int
    h: int
    w: int
    k: int
    mt: int          # bf16: m-tiles a warp
    mg: int          # bf16: warp m-groups a block; float32: 4-channel S groups (cs4)
    nb: int          # bf16: R groups of rcw channels a block; float32: 4-channel R groups (cr4)
    rcw: int         # bf16: R channels an n-tile's 8 columns hold (8, 4, 2, 1; the rest taps)
    wt: int          # tap groups a block: warps (bf16) or thread groups (float32)
    t0b: int         # t0 values a block (k for k = 3, else 1)
    hb: int          # rows a band (odd)
    rsw: int         # S positions a row in smem: W, or padded to odd 16-byte units
    rsr: int         # R row stride in smem, elements
    scs: int         # S channel stride in smem, elements: hb x rsw, or with rsw = W
                     # and bf16 hb x W rounded up to odd 16-byte units ("flat" S)
    planes: int      # D planes a block walks
    sgroups: int
    ngroups: int
    bands: int
    dranges: int
    stages: int      # TMA steps in flight
    threads: int
    smem: int

    @property
    def cs(self) -> int:
        return 16 * self.mt * self.mg if self.bf16 else 4 * self.mg

    @property
    def cr(self) -> int:
        return self.rcw * self.nb if self.bf16 else 4 * self.nb

    @property
    def tapblocks(self) -> int:
        return self.k // self.t0b

    @property
    def tpw(self) -> int:
        """Taps of one warp (bf16) or thread (float32)."""
        return self.k * self.k * self.t0b // self.wt

    @property
    def splits(self) -> int:
        return self.bands * self.dranges

    def to_json(self) -> Dict[str, Any]:
        return self._asdict()

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Plan":
        return cls(**d)


def _odd_units(n: int, per: int) -> int:
    """Elements in the least odd number of ``per``-element units >= n."""
    u = -(-n // per)
    return (u + 1 - u % 2) * per


def _r128(n: int) -> int:
    return -(-n // 128) * 128


def _smem(bf16: bool, k: int, t0b: int, cs: int, cr: int, hb: int, scs: int,
          rsr: int, stages: int) -> int:
    """Bytes of shared memory: barriers and a zero chunk, then the S stages
    and the ring of R planes, which the block's float32 sums reuse at the
    end (cs x cr x its t0b k^2 taps, each co's row padded by a float)."""
    esz = 2 if bf16 else 4
    return 256 + max(stages * _r128(cs * scs * esz)
                     + (t0b + stages - 1) * _r128(cr * ((hb + k - 1) | 1) * rsr * esz),
                     (cs * cr * t0b * k * k + max(cs, cr)) * 4)


# threads a block of the bf16 kernel may have by m-tiles a warp (its launch
# bounds), and so registers a thread may take: 65536 / threads
_MAX_THREADS = {1: 512, 2: 512, 3: 384}


def _per_sm(smem: int, threads: int, regs: int = 128) -> int:
    """Blocks an SM holds: shared memory (1 KB reserved a block), threads,
    and registers (``regs`` a thread, the most the launch bounds allow)."""
    return min((228 * 1024) // (smem + 1024), 2048 // threads, 65536 // (regs * threads))


# a rough H100 cost model for _plan, in SM clock cycles: an SM's tensor cores
# retire about one m16n8k16 mma a cycle once 8 warps feed them, its CUDA
# cores 128 FMAs; an SM copies about 64 bytes a cycle from L2 to shared
# memory, and the card moves about 1,800 bytes of device memory a cycle; a
# step of a block costs some cycles of synchronisation besides
_MMA_WARPS = 8
_FMA_RATE = 128
_COPY_RATE = 64
_BYTES_RATE = 1800
_STEP_CYCLES = 600   # a step's barrier wait, block barrier and copy issue
_CANDIDATES = 10     # grids the wrapper times on a card at a shape's first call
# positions (hb x W x planes) a block of a lane launch sums into one float32
# accumulator: lanes fill the card with few D ranges, and a block that walked
# a lane's whole (128, 64, 64) volume in 4-8 bands summed 74-139 k positions,
# whose rounding reached 1-1.8e-4 of max |dW| (H100, bf16); at 2^15 it stays
# near 0.4e-4. One-lane grids keep the planner they had (their grids are
# pinned in checkpoints).
_LANE_RUN = 1 << 15


def _role_plans(ci: int, co: int, d: int, h: int, w: int, k: int, bf16: bool,
                x_streams: bool, lanes: int = 1) -> list:
    """(cost, grid) of each tile shape with S = x (``x_streams``) or dy: the
    least costly, and the least costly of at most ``_MAX_CLUSTER`` splits.
    ``lanes`` launches the grid once a lane, in one launch."""
    role = []
    p = (k - 1) // 2
    sc, rc = (ci, co) if x_streams else (co, ci)
    t0b = k if k == 3 else 1
    taps = k ** 3
    esz = 2 if bf16 else 4
    if bf16:
        wt = k                                  # warp = t0 (k = 3) or t1
        u = -(-w // 8)
        # rows padded to an odd number of 16-byte units, or twice an odd
        # number (two-way conflicts on A), where S cannot be flat
        rsw_pad = 8 * (u if u % 2 or u % 4 == 2 else u + 1)
        # k = 3 and R of at most 4 channels: taps may share an n-tile's columns
        least = next(c for c in (1, 2, 4, 8) if rc <= c or c == 8) if k == 3 else 8
        mtiles = -(-sc // 16)
        tiles = []                              # (mt, mg, nb, rcw, sgroups, ngroups)
        for rcw in sorted({least, 8}):
            rtiles = -(-rc // rcw)
            for mt in range(1, (min(3, mtiles) if k == 3 else 1) + 1):
                for nb in range(1, min(2, rtiles) + 1):
                    most = _MAX_THREADS[mt] // 32 // (nb * wt)
                    for mg in range(1, min(most, -(-mtiles // mt)) + 1):
                        tiles.append((mt, mg, nb, rcw, -(-mtiles // (mt * mg)),
                                      -(-rtiles // nb)))
    else:
        wt = k * t0b                            # thread group = (t0, t1)
        rsw = _odd_units(w, 4)
        rsr = _odd_units(rsw + 4 + p, 4)        # columns from w = -4
        c4s, c4r = -(-sc // 4), -(-rc // 4)
        # blocks of at least 4 warps where the channels allow
        least = min(128, c4s * min(4, c4r) * wt)
        tiles = [(1, mg, nb, 4, -(-c4s // mg), -(-c4r // nb))
                 for nb in range(1, min(4, c4r) + 1)
                 for mg in range(1, min(c4s, 512 // (nb * wt)) + 1)
                 if mg * nb * wt >= least]
    hmax = min(h + 1 - h % 2, 255 - 2 * p)
    hbs = {hmax} | set(range(1, min(hmax, 17) + 1, 2))
    if bf16 and w % 8 == 0:   # flat S takes even bands too: those that divide H
        hbs |= {b for b in (2, 4, 8, 16) if h % b == 0}
    hbs = sorted(hbs)
    in_cycles = lanes * (sc + rc) * d * h * w * esz / _BYTES_RATE
    for mt, mg, nb, rcw, sgroups, ngroups in tiles:
        if bf16:
            threads = 32 * mg * nb * wt
            cs, cr = 16 * mt * mg, rcw * nb
        else:
            threads = -(-mg * nb * wt // 32) * 32
            cs, cr = 4 * mg, 4 * nb
        for hb in hbs:
            best, few = None, None
            bands = -(-h // hb)
            if bf16:   # flat S where W % 8 == 0 and a channel fits one TMA box
                flat = w % 8 == 0 and _odd_units(hb * w, 8) <= 256
                if hb % 2 == 0 and not flat:
                    continue
                rsw = w if flat else rsw_pad
                scs = _odd_units(hb * w, 8) if flat else hb * rsw
                rsr = _odd_units(rsw + 8 + p, 8)    # columns from w = -8
                # mma a block-step: a warp's k-step issues mt A loads, its B
                # loads and permutes (10 a row of 3 taps; 6 an n-tile for
                # rcw < 8), its mma and about 8 other instructions
                tpw = taps // k // (k // t0b)
                nt = tpw if rcw == 8 else -(-tpw * rcw // 8)
                b_ins = 10 * tpw // 3 if rcw == 8 else 6 * nt
                work = ((threads // 32) * -(-hb * rsw // 16)
                        * max(nt * mt, (mt + b_ins + nt * mt + 8) / 4))
            else:      # FMAs and loads a block-step, in FMA cycles of an SM
                scs = hb * rsw
                work = mg * nb * wt * hb * rsw // 4 * (64 * k + 24) / _FMA_RATE
            for stages in (2, 3, 4):
                smem = _smem(bf16, k, t0b, cs, cr, hb, scs, rsr, stages)
                if smem > _SMEM_MAX:
                    continue
                per_sm = _per_sm(smem, threads, 65536 // _MAX_THREADS[mt])
                cap = _SMS * per_sm
                warps = per_sm * threads // 32
                rate = min(1.0, warps / _MMA_WARPS) if bf16 else min(1.0, warps / 16)
                # a step's copies (S plane, one R plane) overlap its compute
                copy = (cs * scs + cr * ((hb + 2 * p) | 1) * rsr) * esz / _COPY_RATE
                # one block an SM leaves its barriers' bubbles unfilled
                step = (per_sm * (max(work / rate, copy) + _STEP_CYCLES)
                        * (1.0 if stages * per_sm >= 4 else 1.5) * (1.0 if per_sm > 1 else 1.3))
                per_range = sgroups * ngroups * (k // t0b) * bands
                for n in range(1, min(d, 64) + 1):
                    planes = -(-d // n)
                    if lanes > 1 and hb * w * planes > _LANE_RUN:
                        continue
                    dranges = -(-d // planes)
                    waves = -(-per_range * dranges * lanes // cap)
                    # dW, and past _MAX_CLUSTER splits a workspace plane each,
                    # written and read
                    splits = bands * dranges
                    ws = (lanes * (2 * splits + 1 if splits > _MAX_CLUSTER else 1)
                          * sc * rc * taps * 4 / _BYTES_RATE)
                    t = max(waves * (planes + 2) * step, in_cycles) + ws
                    key = (t, splits, -stages)
                    better = best is None or key < best[0]
                    fewer = splits <= _MAX_CLUSTER and (few is None or key < few[0])
                    if better or fewer:
                        pl = Plan(bf16, x_streams, sc, rc, d, h, w, k, mt, mg, nb, rcw, wt,
                                  t0b, hb, rsw, rsr, scs, planes, sgroups, ngroups, bands,
                                  dranges, stages, threads, smem)
                        best = (key, pl) if better else best
                        few = (key, pl) if fewer else few
            if best is not None:
                role.append(best)
            if few is not None and few != best:
                role.append(few)
    return role


@functools.lru_cache(maxsize=None)
def _plans(ci: int, co: int, d: int, h: int, w: int, k: int, bf16: bool,
           lanes: int = 1) -> Tuple[Plan, ...]:
    """The least costly grids under the cost model above, best first, one for
    each tile shape (channel tiles and band height; its TMA stages and D
    planes a block searched) for each role of the operands (S = x or dy):
    ``_CANDIDATES`` of any split count and half as many more of at most
    ``_MAX_CLUSTER`` splits, which need no workspace. ``lanes``: the grids of
    a launch of that many lanes, whose blocks sum at most ``_LANE_RUN``
    positions each."""
    found = []
    for x_streams in (co <= ci, co > ci):
        role = sorted(_role_plans(ci, co, d, h, w, k, bf16, x_streams, lanes),
                      key=lambda r: r[0])
        some = role[:_CANDIDATES]
        found += some + [r for r in role if r[1].splits <= _MAX_CLUSTER
                         and r not in some][:_CANDIDATES // 2]
    if not found:
        raise ValueError(f"wgrad3d: a row of W={w} with k={k} does not fit in "
                         f"shared memory")
    return tuple(pl for _, pl in sorted(found, key=lambda r: r[0]))


def _plan(ci: int, co: int, d: int, h: int, w: int, k: int, bf16: bool) -> Plan:
    """The cost model's best grid (the first of ``_plans``)."""
    return _plans(ci, co, d, h, w, k, bf16)[0]


class Tile(NamedTuple):
    """What one warp (bf16) or thread (float32) of one block sums: S and R
    channels, kernel taps u (R read at s + u - p), the D planes and H rows of
    S, and the partial-sum split it writes."""
    s_ch: Tuple[int, ...]
    r_ch: Tuple[int, ...]
    taps: Tuple[int, ...]
    planes: range
    rows: range
    split: int


def plan_tiles(pl: Plan) -> Iterator[Tile]:
    """Every tile of the launch, in the kernel's own index arithmetic."""
    k, kk = pl.k, pl.k * pl.k
    for bz in range(pl.dranges):
        for by in range(pl.bands):
            for bx in range(pl.sgroups * pl.ngroups * pl.tapblocks):
                ng, rest = bx % pl.ngroups, bx // pl.ngroups
                tb, sg = rest % pl.tapblocks, rest // pl.tapblocks
                planes = range(bz * pl.planes, min(pl.d, (bz + 1) * pl.planes))
                rows = range(by * pl.hb, min(pl.h, (by + 1) * pl.hb))
                split = by * pl.dranges + bz
                s0, r0 = sg * pl.cs, ng * pl.cr
                units = (pl.mg * pl.nb * pl.wt if pl.bf16 else pl.threads)
                for unit in range(units):
                    if pl.bf16:       # warp = (mg, nb, wt), wt fastest
                        wt, rest = unit % pl.wt, unit // pl.wt
                        nb, mg = rest % pl.nb, rest // pl.nb
                        s_ch = tuple(s0 + (mg * pl.mt) * 16 + i
                                     for i in range(16 * pl.mt))
                        r_ch = tuple(r0 + nb * pl.rcw + i for i in range(pl.rcw))
                        if k == 3:
                            taps = tuple(wt * kk + j for j in range(kk))
                        else:
                            taps = tuple(tb * kk + wt * k + j for j in range(k))
                    else:             # thread = (wt, r4, s4), s4 fastest
                        s4, rest = unit % pl.mg, unit // pl.mg
                        r4, wt = rest % pl.nb, rest // pl.nb
                        if wt >= pl.wt:
                            continue  # idle lanes of the last warp
                        s_ch = tuple(s0 + s4 + a * pl.mg for a in range(4))
                        r_ch = tuple(r0 + r4 + b * pl.nb for b in range(4))
                        u0 = wt // k if k == 3 else tb
                        u1 = wt % k if k == 3 else wt
                        taps = tuple(u0 * kk + u1 * k + j for j in range(k))
                    yield Tile(tuple(c for c in s_ch if c < pl.sc),
                               tuple(c for c in r_ch if c < pl.rc),
                               taps, planes, rows, split)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load_library("wgrad3d")
    fn = lib.dpi_wgrad3d
    # without argtypes ctypes would pass each pointer as a 32-bit int
    fn.argtypes = [ctypes.c_void_p] * 6
    fn.restype = ctypes.c_int
    return lib


def _args(pl: Plan, aligned: bool, lanes: int = 1) -> ctypes.Array:
    """The kernel's int arguments for plan ``pl`` on inputs whose bases are
    16-byte aligned or not: is_bf16, tma, x_streams, then the plan from
    ``sc`` on, then the lanes. TMA needs 16-byte aligned bases, row strides
    and first columns, and boxes of <= 256."""
    tma = ((pl.w * (2 if pl.bf16 else 4)) % 16 == 0 and aligned
           and max(pl.rsr, pl.cs, pl.cr, (pl.hb + pl.k - 1) | 1) <= 256)
    return (ctypes.c_int * 28)(int(pl.bf16), int(tma), int(pl.x_streams),
                               *pl[Plan._fields.index("sc"):], lanes)


def _launch(pl: Plan, x: torch.Tensor, dy: torch.Tensor,
            args: ctypes.Array = None, lanes: bool = False) -> torch.Tensor:
    """One launch of the kernel (and its sum of the splits) on plan ``pl``
    and the current stream of x's device, the current one, over the B lanes
    of x (B, Ci, ...) and dy (B, Co, ...); raises if the launch fails.
    Returns dW (B, Co, Ci, k, k, k) with ``lanes``, else (Co, Ci, k, k, k)
    of a one-lane launch."""
    b = x.shape[0]
    if args is None:
        args = _args(pl, _aligned(x, dy), b)
    s, r = (x, dy) if pl.x_streams else (dy, x)
    out = torch.empty((b, dy.shape[1], x.shape[1], pl.k, pl.k, pl.k), dtype=torch.float32,
                      device=x.device)
    # up to _MAX_CLUSTER splits write dW themselves; more a workspace plane each
    ws = (torch.empty((b, pl.splits, out[0].numel()), dtype=torch.float32, device=x.device)
          if pl.splits > _MAX_CLUSTER else None)
    rc = _library().dpi_wgrad3d(
        s.data_ptr(), r.data_ptr(), None if ws is None else ws.data_ptr(), out.data_ptr(),
        args, torch._C._cuda_getCurrentRawStream(x.device.index))
    if rc != 0:
        raise RuntimeError(f"wgrad3d kernel launch failed: CUDA error {rc} "
                           f"(x {tuple(x.shape)}, dy {tuple(dy.shape)}, k {pl.k})")
    return out if lanes else out[0]


# (shapes, k, dtypes, 16-byte aligned bases) -> (plan, its arguments); no
# device in the key, so a plan holds on every card of a process and pins in
# another process
_tuned: Dict[tuple, Tuple[Plan, ctypes.Array]] = {}
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _aligned(x: torch.Tensor, dy: torch.Tensor) -> bool:
    return x.data_ptr() % 16 == 0 and dy.data_ptr() % 16 == 0


def tuned_plans() -> List[Dict[str, Any]]:
    """Every grid the wrapper has kept in this process, in a JSON form:
    ``[{"key": [x shape, dy shape, k, x dtype, dy dtype, aligned], "plan":
    {...}}, ...]``, dtypes by name."""
    name = {v: k for k, v in _DTYPES.items()}
    return [{"key": [list(xs), list(ds), k, name[xt], name[dt], al], "plan": pl.to_json()}
            for (xs, ds, k, xt, dt, al), (pl, _) in _tuned.items()]


def pin_plans(entries: Sequence[Dict[str, Any]]) -> int:
    """Keep the grids of ``entries`` (``tuned_plans``'s form, from another
    process) for their shapes, over any grid timed here, so this process
    sums as that one did. A grid that this version's planner does not list
    for its shape is not pinned (a warning says so). Returns the number
    pinned."""
    pinned = 0
    for e in entries:
        xs, ds, k, xt, dt, al = e["key"]
        pl = Plan.from_json(e["plan"])
        if pl not in _plans(xs[1], ds[1], *xs[2:], k, xt == "bfloat16", xs[0]):
            warnings.warn(f"wgrad3d: the pinned grid for x {xs}, dy {ds} is not one "
                          f"of this planner's; the shape will be timed again")
            continue
        _tuned[(tuple(xs), tuple(ds), k, _DTYPES[xt], _DTYPES[dt], bool(al))] = \
            (pl, _args(pl, bool(al), xs[0]))
        pinned += 1
    return pinned


def _events_ms(pl: Plan, args: ctypes.Array, x: torch.Tensor, dy: torch.Tensor,
               n: int) -> float:
    """Milliseconds a launch over ``n`` back-to-back launches (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        _launch(pl, x, dy, args, lanes=True)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _tune(x: torch.Tensor, dy: torch.Tensor, k: int) -> Tuple[Plan, ctypes.Array]:
    """The fastest of the planner's candidate grids for this shape on this
    card: each timed over 3 launches after one, the best three again over
    two windows of 10. All candidates compute the same sums; the choice is
    kept, so repeated calls give bit-identical results."""
    cands = [(pl, _args(pl, _aligned(x, dy), x.shape[0]))
             for pl in _plans(x.shape[1], dy.shape[1], *x.shape[2:], k,
                              x.dtype == torch.bfloat16, x.shape[0])]
    if len(cands) == 1:
        return cands[0]
    first = []
    for i, (pl, args) in enumerate(cands):
        _launch(pl, x, dy, args, lanes=True)
        first.append((_events_ms(pl, args, x, dy, 3), i))
    finalists = [cands[i] for _, i in sorted(first)[:3]]
    return min(finalists, key=lambda c: min(_events_ms(*c, x, dy, 10) for _ in range(2)))


def _validate(x: torch.Tensor, dy: torch.Tensor, k: int, lanes: bool = False) -> None:
    if x.dim() != 5 or dy.dim() != 5 or x.shape[0] != dy.shape[0] or x.shape[0] < 1 \
            or (not lanes and x.shape[0] != 1):
        raise ValueError(f"wgrad3d{'_lanes' if lanes else ''} takes "
                         f"({'B' if lanes else '1'}, C, D, H, W) tensors, got "
                         f"{tuple(x.shape)} and {tuple(dy.shape)}")
    if x.shape[2:] != dy.shape[2:]:
        raise ValueError(f"spatial mismatch: {tuple(x.shape)} vs {tuple(dy.shape)}")
    if k % 2 == 0 or k < 1:
        raise ValueError(f"wgrad3d needs an odd kernel size, got {k}")


def _run(x: torch.Tensor, dy: torch.Tensor, k: int, lanes: bool) -> torch.Tensor:
    """One launch on CUDA tensors: the tuned grid for this shape, picked at
    the shape's first call (which checks the inputs)."""
    x, dy = x.contiguous(), dy.contiguous()
    if not (x.is_cuda and dy.device == x.device):
        raise ValueError(f"wgrad3d needs both inputs on one CUDA device, got "
                         f"{x.device} and {dy.device}")
    key = (tuple(x.shape), tuple(dy.shape), k, x.dtype, dy.dtype, _aligned(x, dy))
    tuned = _tuned.get(key)
    if tuned is None:
        _validate(x, dy, k, lanes)
        if x.dtype != dy.dtype or x.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"wgrad3d takes two bfloat16 or two float32 tensors, "
                            f"got {x.dtype} and {dy.dtype}")
        if not 1 < k <= _MAX_K:
            raise ValueError(f"the wgrad3d kernel takes 1 < k <= {_MAX_K}, got {k}")
        with torch.cuda.device(x.device):
            tuned = _tuned[key] = _tune(x, dy, k)
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return _launch(tuned[0], x, dy, tuned[1], lanes)
    return _launch(tuned[0], x, dy, tuned[1], lanes)


def wgrad3d(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """dW (Co, Ci, k, k, k) float32 of a same-pad stride-1 k^3 conv. The
    first call at a shape checks the inputs and picks the grid; later calls
    at that shape only launch."""
    if x.device.type == "cpu" and dy.device.type == "cpu":
        _validate(x, dy, k)
        return wgrad3d_plain(x, dy, k)
    out = _run(x, dy, k, lanes=False)
    wgrad3d.launches += 1
    return out


wgrad3d.launches = 0


def wgrad3d_lanes(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """dW (B, Co, Ci, k, k, k) float32 of B same-pad stride-1 k^3 convs, x
    (B, Ci, D, H, W) and dy (B, Co, D, H, W): the plain version on the CPU,
    one launch of the kernel with the lane as a grid dimension on CUDA
    tensors."""
    if x.device.type == "cpu" and dy.device.type == "cpu":
        _validate(x, dy, k, lanes=True)
        return wgrad3d_lanes_plain(x, dy, k)
    out = _run(x, dy, k, lanes=True)
    wgrad3d_lanes.launches += 1
    return out


wgrad3d_lanes.launches = 0
