"""IO of the PyTorch port: the parameter bridge to the JAX package's trees."""
from .bridge import jax_params_to_state_dict, state_dict_to_jax_params

__all__ = ["jax_params_to_state_dict", "state_dict_to_jax_params"]
