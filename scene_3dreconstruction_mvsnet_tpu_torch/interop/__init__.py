from .from_jax import export_block_state_dict, export_torch_state_dict, jax_variables_to_state_dict, load_jax_variables

__all__ = ["export_block_state_dict", "export_torch_state_dict", "jax_variables_to_state_dict", "load_jax_variables"]
