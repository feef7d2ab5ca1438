"""PyTorch/CUDA port of deep_prior_interpolation_tpu for NVIDIA Hopper.

The JAX package beside it is the reference this port is tested against;
the port imports nothing of it, nor JAX. Its main path is the DIP solve of
the MulResUnet (2D and 3D), one patch at a time::

    from deep_prior_interpolation_tpu_torch import Config, DIPSolver
    result = DIPSolver(Config(datadim="3d", dtype="bfloat16")).solve(img, mask)

and the command-line run around it, from a ``.npy`` volume to patches, solves
(with POCS, snapshots, exact checkpoint/resume), per-patch bundles and the
reconstructed volume::

    python -m deep_prior_interpolation_tpu_torch.cli --imgdir DIR \\
        --imgname original.npy --maskname corrupted.npy [flags]

``--batch_patches N`` solves N same-shaped patches at once on the card, each
with its own net and Adam state (``parallel.solve_patches_batched``; lanes
over several cards with ``--mesh_shape``). Three hand-written kernels sit on
that path, all in CUDA C++ for sm_90a:
the fused masked-loss/metrics reduction and its gradient
(``Config.fused_loss``, ``ops/fused_loss.py``) and the 3D conv weight
gradient (``DPI_PALLAS_WGRAD=1``, ``ops/wgrad.py``), each behind the JAX
package's switch, and the linear upsample's backward (``ops/upsample.py``),
whose fixed summation order makes a card solve repeat bit for bit; a patch
batch launches each of them once for all its lanes.
"""
from .config import Config, net_args_are_same, parse_arguments, read_args, write_args
from .engine import DIPSolver, History, HistoryReg, SolveResult
from .models import get_net, init_weights

__version__ = "0.1.0"

__all__ = ["Config", "net_args_are_same", "parse_arguments", "read_args", "write_args",
           "DIPSolver", "History", "HistoryReg", "SolveResult", "get_net", "init_weights",
           "__version__"]
