"""Every name the JAX package exports (its ``__all__``, at the top and in
each subpackage) is exported by the port too, but for the names listed
here: JAX jit machinery, which has no counterpart."""
import importlib

import pytest

import deep_prior_interpolation_tpu_torch

# the scan's carry and its jitted chunk, and XLA's compile cache: jit machinery
JIT_MACHINERY = {"init_carry", "make_run_chunk", "enable_compile_cache"}
# the parallel layer: patch batches over a mesh and spatial sharding
PATCH_BATCHES = {"make_mesh", "overlap_add_sharded", "setup_patch_batch",
                 "solve_patches_batched"}
SPATIAL = {"make_spatial_mesh", "shard_solver_state"}
SUBPACKAGES = ["", ".data", ".engine", ".io", ".models", ".ops", ".parallel", ".utils"]


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_the_port_exports_the_jax_packages_names(sub):
    jax_mod = importlib.import_module("deep_prior_interpolation_tpu" + sub)
    port_mod = importlib.import_module("deep_prior_interpolation_tpu_torch" + sub)
    missing = sorted(set(jax_mod.__all__) - set(port_mod.__all__) - JIT_MACHINERY)
    assert not missing, f"{sub or 'top level'}: not exported by the port: {missing}"
    assert all(hasattr(port_mod, n) for n in port_mod.__all__)


def test_the_parallel_layer_is_all_that_is_left():
    jax_mod = importlib.import_module("deep_prior_interpolation_tpu.parallel")
    assert set(jax_mod.__all__) == PATCH_BATCHES | SPATIAL
    port_mod = importlib.import_module("deep_prior_interpolation_tpu_torch.parallel")
    assert set(port_mod.__all__) == PATCH_BATCHES | SPATIAL
    # the jit names exist only in the JAX package
    assert not JIT_MACHINERY & {n for sub in SUBPACKAGES for n in importlib.import_module(
        "deep_prior_interpolation_tpu_torch" + sub).__all__}
    assert deep_prior_interpolation_tpu_torch.__version__ == importlib.import_module(
        "deep_prior_interpolation_tpu").__version__
