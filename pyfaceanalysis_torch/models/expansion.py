"""Nonlinear feature expansions for SFA layers.

Port of ``pyfaceanalysis_tpu.models.expansion``:

- ``identity``: x
- ``spow``:     [x, sign(x) * |x|^e] with e = 0.8; doubles the dimension.
- ``qt{k}``:    [x, upper-triangular products x_i * x_j for i <= j < k],
                in ``np.triu_indices(k)`` order (row-major, which is also
                ``torch.triu_indices``'s order).

They act on the trailing axis, so the same code serves (B, D) and (B, F, D).
:meth:`Expansion.columns` is the one statement of the column order: the
plain version below and the layer kernel (``ops/cuda_net_layer.py``) both
make their columns from it.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

# How a column of :meth:`Expansion.columns` is made from a field's inputs.
COPY, SPOW, MUL = 0, 1, 2


@functools.lru_cache(maxsize=None)
def _columns(name: str, d: int) -> np.ndarray:
    ident = [(COPY, j, 0) for j in range(d)]
    if name == "identity":
        rows = ident
    elif name == "spow":
        rows = ident + [(SPOW, j, 0) for j in range(d)]
    elif name.startswith("qt"):
        k = min(int(name[2:]), d)
        iu, ju = np.triu_indices(k)
        rows = ident + [(MUL, int(i), int(j)) for i, j in zip(iu, ju)]
    else:
        raise ValueError(f"unknown expansion {name!r}")
    table = np.asarray(rows, np.int32).reshape(-1, 3)
    table.flags.writeable = False
    return table


@dataclasses.dataclass(frozen=True)
class Expansion:
    """A named nonlinear expansion of the trailing feature axis."""

    name: str = "identity"
    exponent: float = 0.8

    def columns(self, d: int) -> np.ndarray:
        """(D, 3) int32 rows ``[op, a, b]``, one for each output column on
        ``d`` inputs, in order: COPY of input ``a``, SPOW (sign(x) |x|^e)
        of input ``a``, or MUL, input ``a`` times input ``b`` (qtK's pairs
        in ``triu_indices`` order); ``b`` is 0 where unused. The first
        ``d`` columns copy the inputs, the rest take one op. Read-only."""
        return _columns(self.name, d)

    def output_dim(self, d: int) -> int:
        return len(self.columns(d))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        d = x.shape[-1]
        extra = self.columns(d)[d:]
        if len(extra) == 0:
            return x
        a = torch.as_tensor(extra[:, 1].astype(np.int64), device=x.device)
        v = x[..., a]
        if extra[0, 0] == SPOW:
            # |x|^e evaluated in float64 and rounded once: it matches XLA's
            # float32 pow in all but ~0.06% of inputs, where torch's float32
            # pow differs by one ulp in ~1.6%, and the networks amplify a
            # first-layer ulp a hundredfold by their last layer.
            p = torch.abs(v).double() ** float(np.float32(self.exponent))
            v = torch.sign(v) * p.to(v.dtype)
        else:
            b = torch.as_tensor(extra[:, 2].astype(np.int64),
                                device=x.device)
            v = v * x[..., b]
        return torch.cat([x, v], dim=-1)
