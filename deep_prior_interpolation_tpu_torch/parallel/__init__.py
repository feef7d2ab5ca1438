"""The parallel layer (counterpart of ``parallel/``): patch batches over
devices (``mesh.py``: B same-shaped patches solved at once, each with its
own net and Adam state, the lanes laid over one or more devices) and one
patch's volume split along a spatial axis over a mesh of shards
(``spatial.py``)."""
from .mesh import make_mesh, overlap_add_sharded, setup_patch_batch, solve_patches_batched
from .spatial import make_spatial_mesh, shard_solver_state

__all__ = ["make_mesh", "make_spatial_mesh", "overlap_add_sharded", "setup_patch_batch",
           "shard_solver_state", "solve_patches_batched"]
