"""Patch batches over devices (counterpart of ``parallel/``): B same-shaped
patches solved at once, each with its own net and Adam state, the lanes laid
over one or more devices (``mesh.py``). The JAX package's other half,
``spatial.py`` (one patch's volume over several devices), is not ported yet
(ROADMAP A.13b)."""
from .mesh import make_mesh, overlap_add_sharded, setup_patch_batch, solve_patches_batched

__all__ = ["make_mesh", "overlap_add_sharded", "setup_patch_batch", "solve_patches_batched"]
