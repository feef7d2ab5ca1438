"""Command-line entry point of the PyTorch port (counterpart of ``cli.py``).

    python -m deep_prior_interpolation_tpu_torch.cli --imgdir DIR \\
        --imgname original.npy --maskname corrupted.npy --outdir NAME [flags]

The flags are the JAX package's (``config.build_parser``); ``--pocs``
switches on the DIP+POCS loss. A run:

  args.txt manifest in results/<outdir, or a random id> -> extract the
  patches -> per patch: skip it when its bundle exists (a crashed run
  resumes where it stopped); an all-corrupted patch (std ~ 0) gets a bundle
  of ``img * mask`` without a solve; else load the net (``--netdir``,
  through ``load_checked``) or start from the previous patch's
  (``--start_from_prev``), solve, and write ``<name>_run.npz``, the
  snapshots ``<name>_output<it>.npy`` (``--save_every``) and, with
  ``--savemodel``, ``<name>_model.msgpack`` (the JAX package's weights
  file, which its ``--net load --netdir`` reads).

It runs on ``cuda:{gpu}`` (``cuda`` without ``--gpu``; an index past the
cards warns and takes ``cuda:0``). Only ``run(..., device="cpu")`` runs it on
the CPU; with no CUDA and no device it raises.

``--batch_patches N`` (N > 1) solves the patches not done yet N at a time
(``parallel.solve_patches_batched``: one lane a patch, seeded ``seed + i``
within its group) and writes each patch's bundle, snapshots and model as
the sequential run does; ``--mesh_shape M`` lays each group's lanes over M
CUDA devices (those that exist where fewer do: on one card every lane is
on it). As in the JAX package, a batch solves every patch of its
group (an all-corrupted one too) and takes no ``--netdir``; with
``--start_from_prev`` the patches are solved one after another whatever
``--batch_patches`` says. ``--spatial_shards N`` (N > 1) splits each
patch's volume along ``--spatial_axis`` over N shards
(``parallel.make_spatial_mesh``: the first N cards, those that exist
where fewer do, or N shards on the CPU for ``device="cpu"``). ``--netdir``
takes a ``<name>_model.msgpack`` of either package, or a ``.pt`` state
dict.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .config import Config, parse_arguments, write_args
from .data import extract_patches
from .engine import DIPSolver, History
from .io import completed_patches, load_checked, save_params, save_run
from .utils.generic import random_code, sec2time


def _log(msg: str) -> None:
    print(msg, flush=True)


def run_device(cfg: Config, device: Union[str, torch.device, None] = None) -> torch.device:
    """The run's device: ``device`` when given, else the card ``cfg.gpu``
    (``cuda:0`` with a warning when there is no such card). Without CUDA and
    without ``device`` it raises: the run never falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("the run needs a CUDA device and none is available; "
                           "pass device='cpu' to run on the CPU")
    if cfg.gpu is None:
        return torch.device("cuda")
    n = torch.cuda.device_count()
    if 0 <= cfg.gpu < n:
        return torch.device(f"cuda:{cfg.gpu}")
    _log(f"warning: --gpu {cfg.gpu} out of range ({n} devices); using cuda:0")
    return torch.device("cuda:0")


def run(cfg: Config, results_root: str = "./results",
        original: Optional[np.ndarray] = None,
        corrupted: Optional[np.ndarray] = None,
        device: Union[str, torch.device, None] = None) -> str:
    """Execute a full interpolation run; returns the output directory."""
    sharded = bool(cfg.spatial_shards and cfg.spatial_shards > 1)
    dev = run_device(cfg, device)
    outpath = os.path.join(results_root,
                           cfg.outdir if cfg.outdir is not None else random_code())
    os.makedirs(outpath, exist_ok=True)
    _log(f"Saving to {outpath}")
    write_args(os.path.join(outpath, "args.txt"), cfg)

    patches = extract_patches(cfg, original=original, corrupted=corrupted)
    _log(f"Processing {len(patches)} patches")
    done = set(completed_patches(outpath))

    outchannel = cfg.imgchannel or patches[0]["image"].shape[-1]
    solver = DIPSolver(cfg, outchannel=outchannel, device=dev)

    if cfg.batch_patches and cfg.batch_patches > 1 and not cfg.start_from_prev:
        _run_batched(cfg, solver, patches, outpath, done, dev)
        _log(f"Interpolation done! Saved to {outpath}")
        return outpath

    spatial_mesh = None
    if sharded:
        from .parallel import make_spatial_mesh
        n = cfg.spatial_shards
        # a CPU run's shards on the CPU; a card run's over the cards that
        # exist, as many as asked at most
        spatial_mesh = make_spatial_mesh(n, [dev] * n if dev.type == "cpu" else None)
        _log(f"Spatial sharding: each patch over {len(spatial_mesh)} devices along spatial "
             f"axis {cfg.spatial_axis}")

    prev_params = None
    for i, patch in enumerate(patches):
        name = patch["name"]
        if name in done:
            _log(f"Patch {name} already done, skipping (resume)")
            continue
        img, mask = patch["image"], patch["mask"]
        _log(f"The data shape is {img.shape}")
        std = float(np.std(img * mask))
        _log(f"the std of coarse data is {std:.2e}")

        if np.isclose(std, 0.0, atol=1e-12):  # all traces corrupted
            _log("skipping...")
            save_run(outpath, name, History(cfg.epochs), mask, img, img * mask,
                     elapsed=0.0, device=dev)
            continue

        init_params = None
        if len(cfg.netdir) != 0:
            netpath = cfg.netdir[min(i, len(cfg.netdir) - 1)]
            init_params = load_checked(netpath, cfg, solver.model.state_dict(),
                                       results_root)
            _log(f"Network loaded from {netpath}")
        elif cfg.start_from_prev and prev_params is not None:
            init_params = prev_params

        res = solver.solve(
            img, mask, seed=cfg.seed + i, init_params=init_params, verbose=True,
            profile_dir=os.path.join(outpath, "profile") if cfg.profile else None,
            spatial_mesh=spatial_mesh, spatial_axis=cfg.spatial_axis)
        prev_params = res.params
        _log("\n" + sec2time(res.elapsed))

        save_run(outpath, name, res.history, mask, img, res.out_best,
                 elapsed=res.elapsed, noise=res.noise, pocs=res.pocs, device=dev)
        for it, snap in res.snapshots.items():
            np.save(os.path.join(
                outpath, f"{name}_output{str(it).zfill(res.history.zfill)}.npy"), snap)
        if cfg.savemodel:
            save_params(os.path.join(outpath, f"{name}_model.msgpack"), res.params)
        _log(f"Finished patch {name}")

    _log(f"Interpolation done! Saved to {outpath}")
    return outpath


def _run_batched(cfg: Config, solver: DIPSolver, patches: List[dict], outpath: str,
                 done: set, dev: torch.device) -> None:
    """The patches not done yet, ``--batch_patches`` at a time, each group
    through ``solve_patches_batched``; the files of each patch as the
    sequential run writes them."""
    from .parallel import make_mesh, solve_patches_batched

    mesh = None
    if cfg.mesh_shape and cfg.mesh_shape > 1:
        # a CPU run's lanes on CPU shards; a card run's over the cards that
        # exist, as many as asked at most
        n = cfg.mesh_shape
        mesh = make_mesh(n, [dev] * n if dev.type == "cpu" else None)
        _log(f"Patch mesh: each group's lanes over {len(mesh)} devices")
    todo = [p for p in patches if p["name"] not in done]
    for start in range(0, len(todo), cfg.batch_patches):
        group = todo[start:start + cfg.batch_patches]
        for patch, res in zip(group, solve_patches_batched(cfg, solver, group, mesh=mesh)):
            name = patch["name"]
            save_run(outpath, name, res.history, patch["mask"], patch["image"], res.out_best,
                     elapsed=res.elapsed, noise=res.noise, pocs=res.pocs, device=dev)
            for it, snap in res.snapshots.items():
                np.save(os.path.join(
                    outpath, f"{name}_output{str(it).zfill(res.history.zfill)}.npy"), snap)
            if cfg.savemodel:
                save_params(os.path.join(outpath, f"{name}_model.msgpack"), res.params)
            _log(f"Finished patch {name}")


def main(argv: Optional[Sequence[str]] = None) -> None:
    run(parse_arguments(argv))


if __name__ == "__main__":
    main()
