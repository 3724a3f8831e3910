"""Mixed-precision policy (counterpart of the JAX package's
`core/dtypes.py`).

Parameters and reductions stay float32; float32 compute is the parity
policy, bfloat16 compute (`BF16_POLICY`) the performance policy of the
packed paths (`input_dtype=torch.bfloat16`)."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.compute_dtype)

    def cast_to_output(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.output_dtype)


DEFAULT_POLICY = Policy()
BF16_POLICY = Policy(compute_dtype=torch.bfloat16)
