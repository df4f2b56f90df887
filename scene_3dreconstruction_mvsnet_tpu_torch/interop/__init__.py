from .from_jax import jax_variables_to_state_dict, load_jax_variables

__all__ = ["jax_variables_to_state_dict", "load_jax_variables"]
