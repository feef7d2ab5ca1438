"""Patch batches on one card or over several (counterpart of ``parallel/mesh.py``).

DIP patches are independent: each owns its net, Adam state and generators,
and no gradient is exchanged. So B same-shaped patches run as B lanes of
one step, as the JAX package's ``jax.vmap`` of its step does:

  * the step is the solver's own (``DIPSolver._step`` with lanes): the net
    under ``torch.func.vmap`` over ``functional_call`` with each lane's
    parameters, whose convs, fused loss and linear upsamples go through
    their vmap rules to lane-batched launches (a grouped cuDNN conv with
    ``vmap_conv_mode="grouped"``, one batched product a tap with "tapmm";
    one launch of the wgrad kernel and of each fused-loss kernel for all
    lanes; the upsample's backward over all lanes' planes);
  * every random draw is made lane by lane from that lane's generators,
    seeded as a solo solve with seed ``cfg.seed + i`` seeds them, so lane i
    computes what that solve computes, but for the rounding of the batched
    ops;
  * on one CUDA device the step's forward and backward run from one CUDA
    graph a solve, as a solo solve's do (``engine/solver.py``
    ``takes_step_graph``);
  * a mesh of M devices takes B / M lanes each (the batch is padded to a
    multiple of M by repeating its last patch); the host dispatches each
    device's chunk in turn from one thread, so the devices run at once, and
    reads each device once a chunk. No collective runs in the loop: the one
    cross-device step is the assembly, :func:`overlap_add_sharded`.

``make_mesh`` takes the devices that exist where fewer exist than asked,
as the JAX package does, and warns naming the cut.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import warnings
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.patcher import _grid_starts, add_tiles
from ..engine.history import History, HistoryPOCS
from ..engine.solver import (DIPSolver, SolveResult, StepSettings, _generators,
                             _to_channels_first, _to_channels_last, _FlatParams,
                             _crop_center, _step_graph, build_base_input, build_data,
                             build_hyper, check_net_output, host_bytes, pad_multiple_for,
                             padded_spatial)
from ..models import set_dropout_generator
from ..ops.conv_vjp import conv_impl
from ..ops.pocs import fk_projection
from ..utils import spans

Mesh = List[torch.device]


def make_mesh(n_devices: int = 0,
              devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """The devices of a 1-D patch mesh: the first ``n_devices`` CUDA devices
    (all of them for 0), or the first ``n_devices`` of ``devices``, which
    may repeat one device. Where fewer exist than asked it takes those that
    exist, as the JAX package's ``devs[:n]`` does, and warns naming the
    cut; with no CUDA device (and no ``devices``) it raises
    ``RuntimeError``: a CPU mesh is asked for by passing CPU devices."""
    if devices is not None:
        devs, what = [torch.device(d) for d in devices], "given"
    else:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devs, what = [torch.device("cuda", i) for i in range(count)], "exist"
    if not devs:
        raise RuntimeError("a mesh needs at least one device" + (
            ": no CUDA device exists" if devices is None else ""))
    if n_devices and n_devices > len(devs):
        warnings.warn(f"{n_devices} devices asked for, {len(devs)} {what}: the mesh takes "
                      f"{len(devs)}", RuntimeWarning, stacklevel=2)
    return devs[:n_devices] if n_devices and n_devices > 0 else devs


def overlap_add_sharded(patches, image_shape: Sequence[int], dim: Sequence[int],
                        stride: Sequence[int], mesh: Mesh,
                        normalize: bool = True) -> torch.Tensor:
    """Overlap-add assembly of a patch batch laid over the mesh.

    ``patches``: (P, *dim) in the tiling's grid order, P a multiple of the
    mesh size; a batch padded beyond the tiling's own count with zero
    patches is accepted (non-zero padding raises). Each device adds its
    shard of patches into a device-local volume (``data.patcher.add_tiles``:
    tile order, no atomics), the device volumes are summed in device order on the first
    device, and with ``normalize`` divided by the overlap counts of the
    real tiling (cells no tile covers keep 0). Returns the ``image_shape``
    volume on the mesh's first device.
    """
    n_dev = len(mesh)
    patches = torch.as_tensor(patches)
    n_patches = patches.shape[0]
    assert n_patches % n_dev == 0, \
        f"patch count {n_patches} must be a multiple of mesh size {n_dev}"
    starts = _grid_starts(tuple(image_shape), tuple(dim), tuple(stride))
    n_real = starts.shape[0]
    assert n_real <= n_patches, f"tiling implies {n_real} patches, got only {n_patches}"
    if n_real < n_patches:
        assert not bool(patches[n_real:].any()), \
            f"patches beyond the tiling's {n_real} must be zero padding"
    per = n_patches // n_dev
    total = None
    for m, dev in enumerate(mesh):
        lo, hi = m * per, min((m + 1) * per, n_real)   # zero lanes add nothing
        vol = add_tiles(torch.zeros(tuple(image_shape), dtype=patches.dtype, device=dev),
                        patches[lo:hi].to(dev), starts[lo:hi], dim)
        total = vol.to(mesh[0]) if total is None else total + vol.to(mesh[0])
    if normalize:
        counts = add_tiles(torch.zeros(tuple(image_shape), dtype=total.dtype, device=mesh[0]),
                           1.0, starts, dim)
        total = total / counts.clamp_min(1.0)
    return total


def _on(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def setup_patch_batch(cfg: Config, solver: DIPSolver, s: StepSettings,
                      imgs: np.ndarray, masks: np.ndarray, padded: Tuple[int, ...],
                      input_shape: Tuple[int, ...], seeds: Optional[np.ndarray] = None,
                      init_params: Optional[Sequence[Optional[Mapping[str, Any]]]] = None,
                      noises: Optional[Sequence[np.ndarray]] = None,
                      device: Optional[torch.device] = None
                      ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """The lane state and data of B patches (``imgs``, ``masks``: (B,
    *spatial, C)) on ``device`` (the solver's by default): lane i's
    generators, canvas, data, parameters and Adam state as a solo solve
    with seed ``seeds[i]`` (default ``cfg.seed + i``) makes them, every
    tracker a (B,) tensor. ``init_params`` (a state dict a lane, or None)
    and ``noises`` (a canvas a lane, (*padded, inputdepth)) take the place
    of the drawn parameters and canvases, as ``solve``'s ``init_params`` and
    ``noise`` do. Returns ``(state, data)``; ``state["gens"]`` holds each
    lane's generators and ``state["regenerate"]`` draws the lanes' raw
    canvases again (``virtual_input``)."""
    n = imgs.shape[0]
    dev = torch.device(device) if device is not None else solver.device
    seeds = cfg.seed + np.arange(n) if seeds is None else np.asarray(seeds)
    init_params = init_params if init_params is not None else [None] * n
    if noises is not None and s.virtual_input:
        raise ValueError("given canvases are stored: pass StepSettings with "
                         "virtual_input=False")
    act = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    gens, starts, canvases, datas, rows = [], [], [], [], []
    for i in range(n):
        g = _generators(int(seeds[i]), dev)
        gens.append(g)
        starts.append(g["canvas"].get_state())
        if noises is not None:
            if tuple(noises[i].shape) != tuple(padded) + (cfg.inputdepth,):
                raise ValueError(f"noise must be {tuple(padded) + (cfg.inputdepth,)}, "
                                 f"got {tuple(noises[i].shape)}")
            canvas = _to_channels_first(noises[i], dev, act)
        elif s.virtual_input:
            canvas = None
        else:
            canvas = build_base_input(cfg, g["canvas"], padded, dev)
        canvases.append(canvas)
        datas.append(build_data(imgs[i], masks[i], canvas, dev,
                                pocs_alpha=cfg.pocs_alpha if s.pocs else None,
                                forget_factor=s.forget_factor,
                                net_mask_shape=input_shape if s.takes_mask else None))
        model = solver._init_model(int(seeds[i]), init_params[i])
        rows.append(torch.cat([p.detach().reshape(-1) for p in model.parameters()]).to(dev))

    data: Dict[str, Any] = {}
    for k, v in datas[0].items():
        if v is None:
            data[k] = None
        elif k == "forget_w":   # the ramp: the same for every lane
            data[k] = v
        else:
            data[k] = torch.stack([d[k] for d in datas])

    def regenerate() -> torch.Tensor:
        """Each lane's raw canvas again, from its generator's first state."""
        out = []
        for g, st in zip(gens, starts):
            g["canvas"].set_state(st)
            out.append(build_base_input(cfg, g["canvas"], padded, dev))
        return torch.stack(out)

    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    out_shape = (n, 1, solver.outchannel) + tuple(imgs.shape[1:-1])
    state: Dict[str, Any] = {
        "flat": _FlatParams(solver.model, data["base_input"] if s.opt_input else None, rows),
        "lr": torch.full((n,), cfg.lr, **f32),
        "loss_min": torch.full((n,), math.inf, **f32),
        "out_best": torch.zeros(out_shape, dtype=act, device=dev),
        "plateau_best": torch.full((n,), math.inf, **f32),
        "plateau_bad": torch.zeros((n,), **i32),
        "es_best": torch.zeros((n,), **f32),
        "es_bad": torch.zeros((n,), **i32),
        "done": torch.zeros((n,), dtype=torch.bool, device=dev),
        "gens": gens, "regenerate": regenerate,
    }
    if s.opt_input:   # the optimised leaf replaces the stored canvas
        data["base_input"] = None
    if s.track_last:
        state["out_last"] = torch.zeros(out_shape, dtype=act, device=dev)
    return state, data


def _lane_params(solver: DIPSolver, st: Dict[str, Any], j: int) -> Dict[str, torch.Tensor]:
    """Lane j's parameters as a state dict of the net, on the CPU."""
    flat = st["flat"]
    by_name = dict(zip(flat.names, flat.params))
    return {k: (by_name[k][j] if k in by_name else v).detach().cpu().clone()
            for k, v in solver.model.state_dict().items()}


def _lane_noise(s: StepSettings, st: Dict[str, Any], data, j: int,
                spatial: Tuple[int, ...]) -> np.ndarray:
    """Lane j's canvas as the bundle's 'noise' (``extract_noise_canvas``)."""
    if s.opt_input:
        canvas = st["flat"].canvas[j]
    elif s.virtual_input:
        canvas = st["regenerate"]()[j]
    else:
        canvas = data["base_input"][j]
    return _to_channels_last(_crop_center(canvas.detach().float(), spatial))


def solve_patches_batched(cfg: Config, solver: DIPSolver, patches: List[dict],
                          mesh: Optional[Mesh] = None,
                          init_params: Optional[Sequence[Optional[Mapping[str, Any]]]] = None,
                          noises: Optional[Sequence[np.ndarray]] = None) -> List[SolveResult]:
    """Solve a group of same-shaped patches at once.

    The lanes run on the solver's device; with ``cfg.mesh_shape > 1`` (or
    an explicit ``mesh``) they are laid over the mesh's devices (over the
    first ``mesh_shape`` CUDA devices, or as many as exist, or for a CPU
    solver over as many shards on the CPU), the batch
    padded to a multiple of its size by repeating the last patch. Lane i
    is seeded ``cfg.seed + i``; ``init_params`` and ``noises`` (one a
    patch) are handed to :func:`setup_patch_batch`. Returns a ``SolveResult`` for each real
    patch: its history, ``iters_run``, ``stopped_early``, snapshots, best
    output, parameters, canvas, POCS projection and ``elapsed`` (the wall
    time until the chunk in which it stopped)."""
    with spans.span("solve", "lanes", len(patches)):
        spans.attr("entry", "batched")
        return _solve_batched(cfg, solver, patches, mesh, init_params, noises)


def _solve_batched(cfg: Config, solver: DIPSolver, patches: List[dict], mesh: Optional[Mesh],
                   init_params: Optional[Sequence[Optional[Mapping[str, Any]]]],
                   noises: Optional[Sequence[np.ndarray]]) -> List[SolveResult]:
    with spans.span("solve.prepare"):
        assert patches, "empty patch group"
        spatial = tuple(patches[0]["image"].shape[:-1])
        for p in patches:
            assert tuple(p["image"].shape[:-1]) == spatial, \
                "batched patches must share a shape; group by shape upstream"
        if mesh is None and cfg.mesh_shape and cfg.mesh_shape > 1:
            # a CPU solver's shards run on the CPU, one after another; a CUDA
            # solver's over the cards that exist (all lanes on one card where
            # there is one)
            cpu = solver.device.type == "cpu"
            mesh = make_mesh(cfg.mesh_shape, [solver.device] * cfg.mesh_shape if cpu else None)
        devices = list(mesh) if mesh is not None else [solver.device]
        n_real = len(patches)
        extra = [init_params, noises]
        while len(patches) % len(devices):
            patches = patches + [patches[-1]]
            extra = [None if e is None else list(e) + [e[-1]] for e in extra]
        n = len(patches)
        per = n // len(devices)

        padded = padded_spatial(spatial, pad_multiple_for(cfg))
        input_shape = (1, cfg.inputdepth) + padded
        s = StepSettings.from_config(cfg, spatial,
                                     takes_mask=getattr(solver.model, "takes_mask", False),
                                     input_shape=input_shape)
        if noises is not None:
            s = dataclasses.replace(s, virtual_input=False)
        check_net_output(solver.model, input_shape, (1, solver.outchannel) + padded, s.takes_mask)
        if s.opt_input and cfg.dtype == "bfloat16":
            raise TypeError("opt_over with 'input' under dtype='bfloat16': the update "
                            "p - lr * d of the bfloat16 canvas is float32, and the JAX "
                            "package's scan refuses a carry whose dtype changes")
        imgs = np.stack([np.asarray(p["image"], np.float32) for p in patches])
        masks = np.stack([np.asarray(p["mask"], np.float32) for p in patches])
        seeds = cfg.seed + np.arange(n)
        groups = []
        for m, dev in enumerate(devices):
            lanes = slice(m * per, (m + 1) * per)
            with _on(dev):
                st, data = setup_patch_batch(
                    cfg, solver, s, imgs[lanes], masks[lanes], padded, input_shape,
                    seeds=seeds[lanes], device=dev,
                    init_params=None if extra[0] is None else extra[0][lanes],
                    noises=None if extra[1] is None else extra[1][lanes])
                groups.append((dev, st, data, build_hyper(cfg, dev)))
        groups[0][1]["graph"] = _step_graph(groups[0][1]["gens"], devices[0], s, mesh=devices)

        chunk = max(1, min(cfg.scan_chunk, cfg.epochs))
        if cfg.save_every:
            chunk = math.gcd(chunk, int(cfg.save_every)) or 1
        n_chunks = math.ceil(cfg.epochs / chunk)
        fields = ("loss", "snr", "pcorr", "lr", "recorded")
        if s.pocs:
            fields += ("df", "reg", "eps", "th")
        hists = [HistoryPOCS(cfg.epochs) if s.pocs else History(cfg.epochs) for _ in range(n)]
        iters_run = [0] * n
        snapshots: List[Dict[int, np.ndarray]] = [{} for _ in range(n)]
        lane_elapsed: List[Optional[float]] = [None] * n
        chunk_seconds: List[float] = []

        def dispatch(group, c: int) -> List[Dict[str, torch.Tensor]]:
            dev, st, data, hyper = group
            with conv_impl(s.conv_mode), _on(dev):
                set_dropout_generator(solver.model, [g["dropout"] for g in st["gens"]])
                return [solver._step(it, st, data, hyper, s, st["gens"], st["regenerate"])
                        for it in range(c * chunk, (c + 1) * chunk)]

        def packed(group, ys: List[Dict[str, torch.Tensor]]) -> torch.Tensor:
            dev, st = group[:2]
            with _on(dev):
                return torch.stack([torch.stack([y[f] for y in ys]) for f in fields]
                                   + [st["done"].float().expand(len(ys), -1)])

        start = time.time()
    for c in range(n_chunks):
        with spans.timed("chunk", "c", c) as timer:
            # every device's chunk is queued before the first is read
            ys = [dispatch(g, c) for g in groups]
            with spans.span("chunk.read"):
                pending = [packed(g, y) for g, y in zip(groups, ys)]
                # (F+1, K, B)
                host = np.concatenate([p.cpu().numpy() for p in pending], axis=2)
        chunk_seconds.append(timer.seconds)
        now = time.time() - start
        for b in range(n):
            lane = dict(zip(fields + ("done",), host[:, :, b]))
            n_rec = min(int(lane["recorded"].sum()), cfg.epochs - iters_run[b])
            hists[b].extend(lane, n_rec)
            iters_run[b] += n_rec
            if lane_elapsed[b] is None and lane["done"][-1]:
                lane_elapsed[b] = now
        end_iter = (c + 1) * chunk
        if cfg.save_every and end_iter % cfg.save_every == 0 and end_iter < cfg.epochs:
            for m, (_, st, _, _) in enumerate(groups):
                for j in range(per):
                    snapshots[m * per + j][end_iter] = _to_channels_last(st["out_last"][j])
        if all(e is not None for e in lane_elapsed):
            break
    with spans.span("solve.results"):
        elapsed = time.time() - start

        results = []
        for b in range(n_real):
            m, j = divmod(b, per)
            dev, st, data, hyper = groups[m]
            pocs = None
            if s.pocs:
                with torch.no_grad(), _on(dev):
                    pocs = _to_channels_last(fk_projection(
                        st["out_best"][j].float(), data["pocs_wdata"][j], data["pocs_wmask"][j],
                        hyper["pocs_thresh"]))
            results.append(SolveResult(
                out_best=_to_channels_last(st["out_best"][j]), history=hists[b],
                params=_lane_params(solver, st, j),
                elapsed=lane_elapsed[b] if lane_elapsed[b] is not None else elapsed,
                iters_run=iters_run[b], stopped_early=iters_run[b] < cfg.epochs,
                noise=_lane_noise(s, st, data, j, spatial), chunk_seconds=list(chunk_seconds),
                snapshots=snapshots[b], pocs=pocs))
        if spans.on:
            spans.attr("host_bytes", host_bytes(results))
    return results
