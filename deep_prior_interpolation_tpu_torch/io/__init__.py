"""IO of the PyTorch port: the parameter bridge to the JAX package's trees,
weights (the port's and the JAX package's msgpack) and solver-state
checkpoints, per-patch run bundles and the post-run report."""
from .bridge import jax_params_to_state_dict, state_dict_to_jax_params
from .checkpoint import (load_checked, load_params, load_solver_state, npz_path,
                         save_params, save_solver_state)
from .results import (completed_patches, create_run_folder, device_name,
                      load_run, run_bundle_path, save_run)
from .report import show_results

__all__ = ["completed_patches", "create_run_folder", "device_name",
           "jax_params_to_state_dict", "load_checked", "load_params",
           "load_run", "load_solver_state", "npz_path", "run_bundle_path",
           "save_params", "save_run", "save_solver_state", "show_results",
           "state_dict_to_jax_params"]
