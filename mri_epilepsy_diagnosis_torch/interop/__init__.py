from .jax_bridge import (load_torch_checkpoint, quantized_to_torch,
                         variables_to_state_dict)

__all__ = ["load_torch_checkpoint", "quantized_to_torch",
           "variables_to_state_dict"]
