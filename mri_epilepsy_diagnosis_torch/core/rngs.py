"""Deterministic seeding and random streams (counterpart of the JAX
package's `core/rngs.py`).

JAX threads splittable keys; torch has stateful generators.  A stream here
hands out generators (or plain integer seeds) drawn from one root
generator, so a seed alone reproduces a run.  torch cannot replay JAX's
threefry bits: the same seed gives other numbers than JAX (ROADMAP §C).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_SEED_BOUND = 2 ** 62


def seed_everything(seed: int = 0) -> torch.Generator:
    """Seed numpy's legacy global RNG (host-side shuffles that mirror the
    reference's `np.random.seed(0)`) and return a host `torch.Generator`
    seeded with `seed`, the root of a run's streams.  torch's own global
    generators are left as they are."""
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)


@dataclasses.dataclass
class RngStream:
    """A mutable wrapper that hands out independent generators.

    `next()` returns a new host generator seeded from one draw of the root
    generator; `next_seed()` returns the draw itself, for a generator that
    must live on another device (`torch.Generator(device).manual_seed`)."""

    generator: torch.Generator

    @classmethod
    def from_seed(cls, seed: int) -> "RngStream":
        return cls(torch.Generator().manual_seed(seed))

    def next_seed(self) -> int:
        return int(torch.randint(0, _SEED_BOUND, (),
                                 generator=self.generator))

    def next(self) -> torch.Generator:
        return torch.Generator().manual_seed(self.next_seed())

    def next_n(self, n: int):
        return [self.next() for _ in range(n)]
