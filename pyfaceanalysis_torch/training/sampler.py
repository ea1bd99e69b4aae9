"""Random draws of the training data.

The JAX package threads ``jax.random`` keys through its renderer and
dataset builders (split, fold_in). The port cannot reproduce threefry bits
and does not try: every function that draws takes a :class:`Sampler` and
asks it for ``uniform``, ``normal``, ``bernoulli`` and ``randint`` values,
in the order in which the JAX code draws them. A site the JAX code draws
once per face draws once per batch here, with the batch as the leading
axis of the shape.

The values come from a seeded CPU ``torch.Generator`` and are moved to the
sampler's device, so a seed gives the same data on the CPU and on the card.
Tests hand a sampler that replays the JAX package's own draws to the same
functions.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

Shape = Union[int, Tuple[int, ...]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def stream_seed(*key: int) -> int:
    """A generator seed for a stream named by integers (a base seed and
    stream indices), from numpy's SeedSequence: distinct names give
    independent streams."""
    state = np.random.SeedSequence([int(k) & 0xFFFFFFFF for k in key]
                                   ).generate_state(2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


class Sampler:
    """Draws from a seeded CPU generator; returns tensors on ``device``."""

    def __init__(self, seed: Union[int, Sequence[int]] = 0,
                 device: Union[str, torch.device] = "cpu"):
        key = (seed,) if isinstance(seed, int) else tuple(seed)
        self.generator = torch.Generator().manual_seed(stream_seed(*key))
        self.device = torch.device(device)

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device)

    def uniform(self, shape: Shape = (), minval: float = 0.0,
                maxval: float = 1.0) -> torch.Tensor:
        """float32 in [minval, maxval)."""
        u = torch.rand(_shape(shape), generator=self.generator)
        return self._out(u * (maxval - minval) + minval)

    def normal(self, shape: Shape = ()) -> torch.Tensor:
        """float32 standard normal."""
        return self._out(torch.randn(_shape(shape), generator=self.generator))

    def bernoulli(self, shape: Shape = (), p: float = 0.5) -> torch.Tensor:
        """bool, True with probability ``p``."""
        u = torch.rand(_shape(shape), generator=self.generator)
        return self._out(u < p)

    def randint(self, shape: Shape, minval: int, maxval: int
                ) -> torch.Tensor:
        """int64 in [minval, maxval)."""
        return self._out(torch.randint(minval, maxval, _shape(shape),
                                       generator=self.generator))
