"""Configuration system of the PyTorch port.

A copy of ``deep_prior_interpolation_tpu.config``: the same fields,
defaults, argparse flags, post-parse derivations (``resolve``), JSON run
manifest (``write_args``/``read_args``) and transfer-learning check
(``net_args_are_same``), so a manifest written by either package is read by
the other. The port keeps its own copy because it imports nothing of the JAX
package.

Port-specific meaning of two fields:

* ``gpu``: ``DIPSolver`` runs on ``cuda:{gpu}`` when it is set, else on
  ``cuda``.
* ``dtype="float32"`` means float32: ``DIPSolver`` turns TF32 off in cuDNN
  and in matmul (see ``engine/solver.py``).

Fields the port does not serve yet raise ``NotImplementedError`` in the
solver, naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import json
import os
from argparse import ArgumentParser
from dataclasses import dataclass, field
from typing import List, Optional, Sequence


@dataclass
class Config:
    # --- dataset ---
    imgdir: str = "./datasets/"
    outdir: Optional[str] = None
    imgname: Optional[str] = None
    maskname: Optional[str] = None
    gain: float = 2e3
    datadim: str = "2d"  # 2d | 2.5d | 3d
    slice: str = "xy"  # tx | ty | xy (2.5d slicing)
    imgchannel: Optional[int] = None
    adirandel: float = 0.0
    # accepted-but-unused, exactly as in the reference: parameter.py:23
    # defines --padwidth and no code ever reads it
    padwidth: int = 0
    patch_shape: Optional[List[int]] = None
    patch_stride: Optional[List[int]] = None

    # --- network design ---
    net: str = "multiunet"  # multiunet | attmultiunet | part | unet | skip | load
    gpu: Optional[int] = None  # kept for CLI parity; maps to device selection
    activation: str = "LeakyReLU"
    last_activation: Optional[str] = None
    dropout: float = 0.0
    filters: List[int] = field(default_factory=lambda: [16, 32, 64, 128, 256])
    skip: List[int] = field(default_factory=lambda: [16, 32, 64, 128])
    inputdepth: int = 64
    upsample: str = "nearest"  # nearest | linear (-> bilinear/trilinear)
    inittype: str = "xavier"
    initgain: float = 0.02
    savemodel: bool = False
    netdir: List[str] = field(default_factory=list)

    # --- input noise ---
    param_noise: bool = False  # see module docstring
    reg_noise_std: float = 0.03
    noise_dist: str = "n"  # n | u | c
    noise_std: float = 0.1
    data_forgetting_factor: int = 0
    filter_noise_with_wavelet: bool = False
    lowpass_fs: Optional[float] = None
    lowpass_fc: Optional[float] = None
    lowpass_ntaps: int = 7

    # --- training ---
    loss: str = "mae"  # mae | mse
    epochs: int = 2001
    lr: float = 1e-3
    lr_factor: float = 0.9
    lr_thresh: float = 1e-5
    lr_patience: int = 100
    save_every: Optional[int] = None
    start_from_prev: bool = False
    reduce_lr: bool = False
    earlystop_patience: Optional[int] = None
    earlystop_min_delta: float = 1.0

    # --- POCS ---
    pocs: bool = False
    pocs_alpha: float = 0.1
    pocs_thresh: float = 5.0
    pocs_weight: Optional[float] = None
    # adaptive-eps gradient semantics: 'stop_grad' (the published intent —
    # eps is a constant weight each iteration) or 'attached' (the reference
    # AS EXECUTED: main_pocs.py:190 discards eps.detach(), so eps*reg == main
    # identically and the regulariser adds no gradient direction)
    pocs_eps_mode: str = "stop_grad"

    # --- runtime (the JAX package's knobs; the port serves a subset) ---
    seed: int = 0
    dtype: str = "float32"  # float32 | bfloat16 (compute dtype of the net)
    remat: bool = False  # checkpoint multi-res blocks (large 3D patches)
    remat_levels: int = 0  # 0 -> all levels; N -> only the largest N scales
    virtual_input: bool = False  # regenerate input noise per step (saves HBM)
    profile: bool = False  # capture a profiler trace of one chunk
    # comma list: net,input (utils/torch.py:138-162). The reference's third
    # group, 'down', is intentionally NOT carried over: it requires an
    # external downsampler module that neither reference entry script ever
    # constructs (main.py:200 / main_pocs.py call get_params without one,
    # so 'down' would hit utils/torch.py:154's assert) — dead capability
    # inherited from the original DIP super-resolution code. resolve()
    # rejects it with a pointer here; see also docs/MIGRATION.md.
    opt_over: str = "net"
    pad_multiple: int = 0  # 0 -> auto: 2**(n_scales-1); 1 -> no padding
    scan_chunk: int = 50  # iterations per jitted scan chunk
    fused_loss: bool = False  # Pallas fused masked-loss+metrics kernel
    # phase-space (space-to-depth) execution of the small-channel scales of
    # MulResUnet — exact math, ~8x MXU lane utilisation (ops/phase_space.py)
    phase_space: bool = False
    phase_levels: int = 3  # resolutions 0..N-1 phase-resident; 0 -> none, -1 -> all
    phase_deep_levels: int = 0  # first N phased resolutions at DEPTH 2 (x4^ndim lanes)
    batch_patches: int = 0  # 0 -> sequential; N -> vmap N same-shaped patches
    mesh_shape: int = 0  # 0 -> no mesh; N -> 1-D patch mesh over N devices
    # conv formulation inside the solver step: "grouped" keeps XLA's conv
    # emitters (and its lowering of a vmapped conv); "tapmm" re-expresses
    # each conv as per-tap (batched) matmuls — 6.6x faster per patch than
    # grouped under the patch vmap at 64ch 2D patches (docs/PERF.md r4
    # vmap-conv study). Applies to batched AND single-patch solves; carried
    # by StepSettings.conv_mode so it keys the jit cache.
    vmap_conv_mode: str = "grouped"
    # spatial (model-parallel) sharding of each SINGLE patch's activation
    # volumes over an N-device "space" mesh — for volumes/precisions that
    # exceed one chip's HBM (SURVEY §2.2 TP row; parallel/spatial.py).
    # Mutually exclusive with batch_patches/mesh_shape (patch-parallel).
    spatial_shards: int = 0  # 0/1 -> off; N -> shard over N devices
    spatial_axis: int = 1  # which SPATIAL dim to shard (0 = time)

    # ------------------------------------------------------------------
    def __post_init__(self) -> None:
        self.resolve()

    def resolve(self) -> "Config":
        """Post-parse derivations (parity: parameter.py:113-125)."""
        groups = set(self.opt_over.split(","))
        if not groups <= {"net", "input"}:
            raise ValueError(
                f"opt_over supports 'net' and 'input', got {self.opt_over!r}"
                " (the reference's 'down' group is unreachable dead code "
                "there — see the opt_over field comment)")
        if self.vmap_conv_mode not in ("grouped", "tapmm"):
            # argparse validates CLI use; this catches Python-API typos that
            # would otherwise silently fall back to the 6.6x-slower mode
            raise ValueError(
                f"vmap_conv_mode must be 'grouped' or 'tapmm', "
                f"got {self.vmap_conv_mode!r}")
        if self.spatial_shards and self.spatial_shards > 1:
            if self.batch_patches and self.batch_patches > 1:
                raise ValueError(
                    "spatial_shards (model-parallel within one patch) and "
                    "batch_patches>1 (patch-parallel) are mutually "
                    "exclusive; shard EITHER the volume OR the patch batch")
            ndim = 2 if self.datadim == "2d" else 3
            if not 0 <= self.spatial_axis < ndim:
                raise ValueError(
                    f"spatial_axis must index a {self.datadim} spatial dim "
                    f"(0..{ndim - 1}), got {self.spatial_axis}")
        if self.upsample == "linear":
            self.upsample = "trilinear" if self.datadim == "3d" else "bilinear"
        if self.patch_shape is None:
            self.patch_shape = [-1, -1] if self.datadim == "2d" else [-1, -1, -1]
        if self.patch_stride is None:
            self.patch_stride = list(self.patch_shape)
        if self.earlystop_patience is None:
            self.earlystop_patience = self.epochs
        return self

    @property
    def ndim_model(self) -> int:
        """Spatial rank of the network (2 for 2d/2.5d slices, 3 for 3d)."""
        return 3 if self.datadim == "3d" else 2

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


# ----------------------------------------------------------------------
# argparse front-end (flag-name parity with parameter.py)
# ----------------------------------------------------------------------

def build_parser() -> ArgumentParser:
    p = ArgumentParser(description="Deep-prior seismic interpolation (PyTorch port)")
    d = Config.__dataclass_fields__

    def dflt(name):
        f = d[name]
        return f.default_factory() if f.default_factory is not dataclasses.MISSING else f.default

    # dataset
    p.add_argument("--imgdir", type=str, required=True)
    p.add_argument("--outdir", type=str)
    p.add_argument("--imgname", type=str)
    p.add_argument("--maskname", type=str)
    p.add_argument("--gain", type=float, default=dflt("gain"))
    p.add_argument("--datadim", type=str, default="2d", choices=["2d", "2.5d", "3d"])
    p.add_argument("--slice", type=str, default="xy", choices=["tx", "ty", "xy"])
    p.add_argument("--imgchannel", type=int)
    p.add_argument("--adirandel", type=float, default=0.0)
    p.add_argument("--padwidth", type=int, default=0)
    p.add_argument("--patch_shape", nargs="+", type=int)
    p.add_argument("--patch_stride", nargs="+", type=int)
    # network design
    p.add_argument("--net", type=str, default="multiunet",
                   choices=["multiunet", "attmultiunet", "part", "unet", "skip", "load"])
    p.add_argument("--gpu", type=int)
    p.add_argument("--activation", type=str, default="LeakyReLU",
                   choices=["LeakyReLU", "ReLU", "ELU", "Tanh", "Sigmoid"])
    p.add_argument("--last_activation", type=str,
                   choices=["LeakyReLU", "ReLU", "ELU", "Tanh", "Sigmoid"])
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--filters", nargs="+", type=int, default=dflt("filters"))
    p.add_argument("--skip", nargs="+", type=int, default=dflt("skip"))
    p.add_argument("--inputdepth", type=int, default=64)
    p.add_argument("--upsample", type=str, default="nearest", choices=["nearest", "linear"])
    p.add_argument("--inittype", type=str, default="xavier",
                   choices=["xavier", "normal", "default", "kaiming", "orthogonal"])
    p.add_argument("--initgain", type=float, default=0.02)
    p.add_argument("--savemodel", action="store_true", default=False)
    p.add_argument("--netdir", type=str, nargs="+", default=[])
    # input noise
    p.add_argument("--param_noise", action="store_true", default=False)
    p.add_argument("--reg_noise_std", type=float, default=0.03)
    p.add_argument("--noise_dist", type=str, default="n", choices=["n", "u", "c"])
    p.add_argument("--noise_std", type=float, default=0.1)
    p.add_argument("--data_forgetting_factor", type=int, default=0)
    p.add_argument("--filter_noise_with_wavelet", action="store_true", default=False)
    p.add_argument("--lowpass_fs", type=float)
    p.add_argument("--lowpass_fc", type=float)
    p.add_argument("--lowpass_ntaps", type=int, default=7)
    # training
    p.add_argument("--loss", type=str, default="mae", choices=["mae", "mse"])
    p.add_argument("--epochs", "-e", "--iter", type=int, default=2001)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr_factor", type=float, default=0.9)
    p.add_argument("--lr_thresh", type=float, default=1e-5)
    p.add_argument("--lr_patience", type=int, default=100)
    p.add_argument("--save_every", type=int)
    p.add_argument("--start_from_prev", action="store_true", default=False)
    p.add_argument("--reduce_lr", action="store_true", default=False)
    p.add_argument("--earlystop_patience", type=int)
    p.add_argument("--earlystop_min_delta", type=float, default=1.0)
    # POCS
    p.add_argument("--pocs", action="store_true", default=False)
    p.add_argument("--pocs_alpha", type=float, default=0.1)
    p.add_argument("--pocs_thresh", type=float, default=5.0)
    p.add_argument("--pocs_weight", type=float)
    # runtime
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--remat", action="store_true", default=False)
    p.add_argument("--remat_levels", type=int, default=0)
    p.add_argument("--virtual_input", action="store_true", default=False)
    p.add_argument("--profile", action="store_true", default=False)
    p.add_argument("--opt_over", type=str, default="net")
    p.add_argument("--pad_multiple", type=int, default=0)
    p.add_argument("--scan_chunk", type=int, default=50)
    p.add_argument("--fused_loss", action="store_true", default=False)
    p.add_argument("--phase_space", action="store_true", default=False)
    p.add_argument("--pocs_eps_mode", type=str, default="stop_grad",
                   choices=["stop_grad", "attached"],
                   help="adaptive-eps gradient semantics (attached = the "
                        "reference as executed; see Config docstring)")
    p.add_argument("--phase_levels", type=int, default=3,
                   help="how many of the largest resolutions run phase-blocked"
                        " (0 disables phasing, -1 phases all levels)")
    p.add_argument("--phase_deep_levels", type=int, default=0,
                   help="first N phased resolutions run at phase depth 2 "
                        "(channels x 4^ndim at 1/4 resolution)")
    p.add_argument("--batch_patches", type=int, default=0)
    p.add_argument("--mesh_shape", type=int, default=0)
    p.add_argument("--vmap_conv_mode", type=str, default="grouped",
                   choices=["grouped", "tapmm"],
                   help="conv lowering in the batched patch solver: tapmm "
                        "runs each kernel tap as a batched matmul (faster "
                        "for multi-patch-per-chip batching)")
    p.add_argument("--spatial_shards", type=int, default=0,
                   help="shard each single patch's activations over N "
                        "devices (model-parallel; for volumes/precisions "
                        "exceeding one chip's HBM)")
    p.add_argument("--spatial_axis", type=int, default=1,
                   help="which spatial dim to shard (0 = time; default the "
                        "first trace axis)")
    return p


def parse_arguments(argv: Optional[Sequence[str]] = None) -> Config:
    ns = build_parser().parse_args(argv)
    return Config(**vars(ns))


# ----------------------------------------------------------------------
# JSON run-manifest persistence (parity: utils/generic.py:39-48)
# ----------------------------------------------------------------------

def write_args(path: str, cfg: Config) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(cfg.to_dict(), fh, indent=2, sort_keys=True)


def read_args(path: str) -> Config:
    with open(path) as fh:
        return Config.from_dict(json.load(fh))


# ----------------------------------------------------------------------
# transfer-learning compatibility check (parity: parameter.py:133-173)
# ----------------------------------------------------------------------

KEYS_MUST = ["datadim", "slice", "imgchannel", "patch_shape", "inputdepth",
             "loss", "lr", "lr_factor", "lr_thresh", "lr_patience", "reduce_lr"]
KEYS_MILD = ["net", "activation", "last_activation", "dropout", "filters",
             "skip", "upsample", "inittype", "initgain"]


def net_args_are_same(cfg1: Config, cfg2: Config, verbose: bool = True) -> bool:
    d1, d2 = cfg1.to_dict(), cfg2.to_dict()
    errors = [k for k in KEYS_MUST if d1.get(k) != d2.get(k)]
    warns = [k for k in KEYS_MILD if d1.get(k) != d2.get(k)]
    if errors:
        if verbose:
            print("The following arguments keys have to be the same:\n\t" + ", ".join(errors))
        return False
    if warns and verbose:
        print("The following arguments differ but are overridden by the "
              "network loading:\n\t" + ", ".join(warns))
    return True
