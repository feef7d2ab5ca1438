"""PyTorch/CUDA port of deep_prior_interpolation_tpu for NVIDIA Hopper.

The JAX package beside it is the reference this port is tested against;
the port imports nothing of it, nor JAX. Its main path is the single-patch
DIP solve of the MulResUnet (2D and 3D)::

    from deep_prior_interpolation_tpu_torch import Config, DIPSolver
    result = DIPSolver(Config(datadim="3d", dtype="bfloat16")).solve(img, mask)

Two hand-written kernels sit on that path, each behind the JAX package's
switch, both in CUDA C++ for sm_90a: the fused masked-loss/metrics
reduction and its gradient (``Config.fused_loss``, ``ops/fused_loss.py``)
and the 3D conv weight gradient (``DPI_PALLAS_WGRAD=1``, ``ops/wgrad.py``).
"""
from .config import Config
from .engine import DIPSolver

__all__ = ["Config", "DIPSolver"]
