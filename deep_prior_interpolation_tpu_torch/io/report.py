"""Post-run report (counterpart of ``io/report.py``): re-assemble a run's
patches, plot the volume or gather and the metric curves, and report the
reconstruction's SNR and Pearson correlation against the original.

It reads any run directory with an ``args.txt`` and ``<name>_run.npz``
bundles: the port's and the JAX package's have the same keys. matplotlib is
imported only here, when a report is drawn.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path
from random import sample
from typing import Optional

import numpy as np
import torch

from ..config import read_args
from ..data import reconstruct_patches
from ..ops import pcorr, snr
from ..utils.plotting import _pyplot, clim, explode_volume, plot_gather

__all__ = ["show_results"]


def _can_draw() -> bool:
    """Whether matplotlib imports; says so on stderr when it does not."""
    try:
        _pyplot()
    except ImportError:
        print("show_results: matplotlib is not installed, no figure drawn", file=sys.stderr)
        return False
    return True


def show_results(res_dir, opts: Optional[dict] = None, curves: int = 0,
                 savefig: bool = False, original: Optional[np.ndarray] = None):
    """Assemble and report a finished run directory; returns (outputs, a
    summary dict with 'snr', 'pcorr' and 'n_patches'). ``curves`` patches'
    loss, SNR, Pearson and learning-rate curves are drawn (``curves.png``
    with ``savefig``), beside the volume (``output.png``). Where matplotlib
    is not installed (a card's machine may lack it), no figure is drawn and
    the outputs and summary are returned all the same."""
    res_dir = Path(res_dir)
    cfg = read_args(str(res_dir / "args.txt"))

    if original is None:
        original = np.load(os.path.join(cfg.imgdir, cfg.imgname), allow_pickle=True)
    inputs = np.asarray(original, np.float32)

    opts = dict(opts or {})
    opts.setdefault("clipval", clim(inputs, 98))
    save_opts = opts.pop("save_opts", {"format": "png", "dpi": 150, "bbox_inches": "tight"})

    outputs, hist = reconstruct_patches(cfg, results_dir=str(res_dir), return_history=True,
                                        original=inputs)
    if outputs.shape != inputs.shape:  # a stride-cropped extent
        inputs = inputs[tuple(slice(0, s) for s in outputs.shape)]

    draw = _can_draw()
    if draw and outputs.ndim == 3:
        explode_volume(outputs, filename=str(res_dir / "output") if savefig else None,
                       save_opts=save_opts if savefig else None, **opts)
    elif draw:
        plot_gather(outputs, filename=str(res_dir / "output.png") if savefig else None,
                    **{k: v for k, v in opts.items()
                       if k in ("figsize", "cmap", "clipval", "p", "tlim", "xlim", "labels")})

    out_t, in_t = torch.from_numpy(np.asarray(outputs)), torch.from_numpy(inputs)
    summary = {"snr": float(snr(out_t, in_t)), "pcorr": float(pcorr(out_t, in_t)),
               "n_patches": len(hist)}

    if draw and curves > 0 and hist:
        plt = _pyplot()
        idx = sorted(sample(range(len(hist)), curves)) if len(hist) > curves \
            else range(len(hist))
        fig, axs = plt.subplots(1, 4, figsize=(18, 4))
        for i in idx:
            h = hist[i]
            axs[0].plot(h["loss"], label=f"patch {i}")
            axs[1].plot(h["snr"], label=f"patch {i}")
            axs[2].plot(h["pcorr"], label=f"patch {i}")
            if "lr" in h:
                axs[3].plot(h["lr"], label=f"patch {i}")
        axs[0].set_title(f"LOSS {cfg.loss}")
        axs[1].set_title("SNR = %.2f dB" % summary["snr"])
        axs[2].set_title("PCORR = %.2f %%" % (summary["pcorr"] * 100))
        axs[3].set_title("Learning Rate")
        for a in axs:
            a.legend()
            a.set_xlim(0, cfg.epochs)
            a.grid()
        axs[0].set_ylim(0)
        axs[2].set_ylim(0, 1)
        axs[3].set_ylim(0, cfg.lr * 10)
        plt.suptitle(str(res_dir))
        plt.tight_layout(pad=0.5)
        if savefig:
            fig.savefig(res_dir / f"curves.{save_opts['format']}", **save_opts)

    return outputs, summary
