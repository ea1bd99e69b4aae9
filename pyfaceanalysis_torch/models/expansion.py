"""Nonlinear feature expansions for SFA layers.

Port of ``pyfaceanalysis_tpu.models.expansion``:

- ``identity``: x
- ``spow``:     [x, sign(x) * |x|^e] with e = 0.8; doubles the dimension.
- ``qt{k}``:    [x, upper-triangular products x_i * x_j for i <= j < k],
                in ``np.triu_indices(k)`` order (row-major, which is also
                ``torch.triu_indices``'s order).

They act on the trailing axis, so the same code serves (B, D) and (B, F, D).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Expansion:
    """A named nonlinear expansion of the trailing feature axis."""

    name: str = "identity"
    exponent: float = 0.8

    def output_dim(self, d: int) -> int:
        if self.name == "identity":
            return d
        if self.name == "spow":
            return 2 * d
        if self.name.startswith("qt"):
            k = min(int(self.name[2:]), d)
            return d + k * (k + 1) // 2
        raise ValueError(f"unknown expansion {self.name!r}")

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "identity":
            return x
        if self.name == "spow":
            # |x|^e evaluated in float64 and rounded once: it matches XLA's
            # float32 pow in all but ~0.06% of inputs, where torch's float32
            # pow differs by one ulp in ~1.6%, and the networks amplify a
            # first-layer ulp a hundredfold by their last layer.
            p = torch.abs(x).double() ** float(np.float32(self.exponent))
            e = torch.sign(x) * p.to(x.dtype)
            return torch.cat([x, e], dim=-1)
        if self.name.startswith("qt"):
            k = min(int(self.name[2:]), x.shape[-1])
            head = x[..., :k]
            iu, ju = torch.triu_indices(k, k, device=x.device)
            return torch.cat([x, head[..., iu] * head[..., ju]], dim=-1)
        raise ValueError(f"unknown expansion {self.name!r}")
