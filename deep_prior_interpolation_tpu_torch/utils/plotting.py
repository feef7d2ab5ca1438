"""Host-side plots of seismic gathers and volumes (counterpart of
``utils/plotting.py``).

A percentile colour limit, the orthogonal-slice view of a volume, the image
of a gather, a GIF of a volume's slices and a wiggle display. Everything is
drawn from one primitive, :func:`_section`: a 2-D slice with physical
extents and optional crosshairs on an axis. Figures are returned, never
shown. matplotlib (on the Agg backend) and imageio are imported inside the
functions that draw: the port imports without them.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np


@functools.cache
def _pyplot():
    """matplotlib's pyplot on the headless Agg backend."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def clim(x: np.ndarray, ratio: float = 95) -> Tuple[float, float]:
    """Symmetric color limits at the given percentile of ``|x|``."""
    c = float(np.percentile(np.abs(np.asarray(x)), ratio))
    return -c, c


def _span(lim: Optional[tuple], n: int, unit: str) -> Tuple[float, float, str]:
    """Physical (lo, hi, axis-label) for an axis of ``n`` samples.

    Without explicit limits the axis is labelled in sample indices.
    """
    if lim is None:
        return 0.0, float(n), "samples"
    return float(lim[0]), float(lim[1]), unit


def _phys(idx: int, lo: float, hi: float, n: int) -> float:
    """Map a sample index to its physical coordinate on a span."""
    return lo + (hi - lo) * idx / n


def _section(ax, data: np.ndarray, hspan: Tuple[float, float],
             vspan: Tuple[float, float], img_opts: dict,
             marks: Optional[Tuple[float, float]] = None,
             mark_style: Optional[dict] = None,
             v_down: bool = True) -> None:
    """Draw one 2-D section: image in physical coordinates + crosshairs.

    ``data`` rows map to the vertical span (downward-increasing when
    ``v_down``, the seismic time convention), columns to the horizontal span.
    ``marks`` are physical (h, v) crosshair coordinates.
    """
    bottom, top = (vspan[1], vspan[0]) if v_down else vspan
    ax.imshow(data, extent=(hspan[0], hspan[1], bottom, top), **img_opts)
    if marks is not None:
        ax.axvline(marks[0], **mark_style)
        ax.axhline(marks[1], **mark_style)


def explode_volume(volume: np.ndarray, t: Optional[int] = None,
                   x: Optional[int] = None, y: Optional[int] = None,
                   figsize: tuple = (8, 8), cmap: str = "bone",
                   clipval: Optional[tuple] = None, p: int = 98,
                   tlim: Optional[tuple] = None, xlim: Optional[tuple] = None,
                   ylim: Optional[tuple] = None,
                   labels: Sequence[str] = ("[s]", "[km]", "[km]"),
                   ratio: Optional[tuple] = None,
                   linespec: Optional[dict] = None,
                   filename: Optional[str] = None,
                   save_opts: Optional[dict] = None):
    """Orthogonal-slice view of a (t, x, y) volume.

    Front (x–t), top (x–y) and side (y–t) sections through the cut point
    ``(t, x, y)`` (defaults: volume centre), arranged in an L-shaped mosaic
    with shared axes and crosshairs marking the cut planes.
    """
    vol = np.asarray(volume)
    nt, nx, ny = vol.shape
    ct = nt // 2 if t is None else t
    cx = nx // 2 if x is None else x
    cy = ny // 2 if y is None else y

    t0, t1, t_unit = _span(tlim, nt, labels[0])
    x0, x1, x_unit = _span(xlim, nx, labels[1])
    y0, y1, y_unit = _span(ylim, ny, labels[2])
    pt, px, py = (_phys(ct, t0, t1, nt), _phys(cx, x0, x1, nx),
                  _phys(cy, y0, y1, ny))

    style = linespec if linespec is not None else dict(ls="-", lw=1,
                                                       color="orange")
    img_opts = dict(
        cmap=cmap, aspect="auto",
        clim=clipval if clipval is not None else clim(vol, p))
    wr, hr = ((nx, ny), (ny, nx)) if ratio is None else (tuple(ratio[0]),
                                                         tuple(ratio[1]))

    fig, axd = _pyplot().subplot_mosaic(
        [["top", "."], ["front", "side"]], figsize=figsize,
        width_ratios=wr, height_ratios=hr,
        gridspec_kw=dict(wspace=0.0, hspace=0.0))
    axd["top"].sharex(axd["front"])
    axd["side"].sharey(axd["front"])

    # panel spec: (axis key, section array, hspan, vspan, crosshair, v_down)
    panels = [
        ("front", vol[:, :, cy], (x0, x1), (t0, t1), (px, pt), True),
        ("top", vol[ct].T, (x0, x1), (y0, y1), (px, py), False),
        ("side", vol[:, cx], (y0, y1), (t0, t1), (py, pt), True),
    ]
    for key, section, hspan, vspan, marks, v_down in panels:
        _section(axd[key], section, hspan, vspan, img_opts,
                 marks=marks, mark_style=style, v_down=v_down)

    axd["top"].tick_params(axis="x", labelbottom=False)
    axd["side"].tick_params(axis="y", labelleft=False)
    axd["front"].set_xlabel(f"x {x_unit}")
    axd["front"].set_ylabel(f"t {t_unit}")
    axd["top"].set_ylabel(f"y {y_unit}")
    axd["side"].set_xlabel(f"y {y_unit}")

    if filename is not None:
        opts = dict(format="png", dpi=150, bbox_inches="tight")
        if save_opts:
            opts.update(save_opts)
        fig.savefig(f"{filename}.{opts['format']}", **opts)
    return fig


def plot_gather(gather: np.ndarray, figsize: tuple = (8, 8),
                cmap: str = "bone", clipval: Optional[tuple] = None,
                p: int = 98, tlim: Optional[tuple] = None,
                xlim: Optional[tuple] = None,
                labels: Sequence[str] = ("[s]", "[km]"),
                filename: Optional[str] = None):
    """Image view of a single (t, x) gather — one :func:`_section`."""
    g = np.asarray(gather)
    t0, t1, t_unit = _span(tlim, g.shape[0], labels[0])
    x0, x1, x_unit = _span(xlim, g.shape[1], labels[1])

    fig, ax = _pyplot().subplots(figsize=figsize)
    _section(ax, g, (x0, x1), (t0, t1),
             dict(cmap=cmap, aspect="auto",
                  clim=clipval if clipval is not None else clim(g, p)))
    ax.set_xlabel(f"x {x_unit}")
    ax.set_ylabel(f"t {t_unit}")
    if filename is not None:
        fig.savefig(filename, bbox_inches="tight", dpi=150)
    return fig


def gif_from_array(x: np.ndarray, filename: str,
                   clipval: Optional[tuple] = None, p: int = 98,
                   axis: int = 0, **kwargs) -> None:
    """Animate the slices of a volume along ``axis`` into a GIF file."""
    from imageio import mimsave

    arr = np.asarray(x)
    if not -arr.ndim <= axis < arr.ndim:
        raise ValueError("Provided dir has to be an array dimension")
    arr = np.moveaxis(arr, axis, 0)
    lo, hi = clipval if clipval is not None else clim(arr, p)
    u8 = (np.clip((arr - lo) / (hi - lo), 0.0, 1.0) * 255).astype(np.uint8)
    mimsave(filename, list(u8.transpose(0, 2, 1)), format="GIF", **kwargs)


def seismograms(x: np.ndarray, ax, tlim: Optional[tuple] = None,
                xlim: Optional[tuple] = None, gain: float = 1.0,
                color: Union[str, Tuple[str, str]] = "black") -> None:
    """Variable-area wiggle display of a (t, x) gather on an existing axis.

    Each trace is scaled by ``gain``, offset to its receiver coordinate, and
    its positive/negative lobes filled with ``color`` (a single color or a
    ``(positive, negative)`` pair).
    """
    if isinstance(color, str):
        pos_c = neg_c = color
    else:
        try:
            pos_c, neg_c = color
        except (TypeError, ValueError):
            raise ValueError("color has to be a tuple of 2 elements")

    g = np.asarray(x)
    nt, ntr = g.shape
    t0, t1, _ = _span(tlim, nt, "")
    x0, x1, _ = _span(xlim if xlim is not None else (1, ntr), ntr, "")
    t_coords = np.linspace(t0, t1, nt)
    offsets = np.linspace(x0, x1, ntr)
    wiggles = g * gain + offsets  # (nt, ntr), one offset trace per column

    for off, w in zip(offsets, wiggles.T):
        ax.fill_betweenx(t_coords, w, off, where=w >= off, facecolor=pos_c)
        ax.fill_betweenx(t_coords, w, off, where=w <= off, facecolor=neg_c)

    ax.set_ylim(t0, t1)
    ax.invert_yaxis()
    ax.set_xticks(offsets)
    ax.tick_params(axis="x", size=2, width=1)
    ax.xaxis.set_label_position("top")
    ax.xaxis.set_ticks_position("top")
    ax.grid(visible=True, which="major", axis="y")
