from .jax_bridge import load_torch_checkpoint, variables_to_state_dict

__all__ = ["load_torch_checkpoint", "variables_to_state_dict"]
