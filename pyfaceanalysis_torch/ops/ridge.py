"""Linear ridge head: an optional decoder for the pose-refinement stages.

Port of ``pyfaceanalysis_tpu.ops.ridge.RidgeRegressor``. The default
decoder is the Gaussian soft regression (ops.gaussian); a ridge readout of
the same features is the alternative some artifact sets ship for the pose
stages. Outputs are clipped to the training label range, mirroring the
Gaussian head's convex-combination bound so the cascade's discard gates see
the same output envelope. ``regression`` is call-compatible with
``GaussianRegressor.regression`` (``estimate_std`` returns the training
residual std, a constant: ridge has no per-sample posterior).
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch
from torch import nn


class RidgeRegressor(nn.Module):
    """``w`` (D,), ``b`` (), ``clip_lo``/``clip_hi`` () the training label
    range, ``resid_std`` () the training residual std; buffers of ``dtype``
    (float32 unless asked for another)."""

    def __init__(self, w, b, clip_lo, clip_hi, resid_std,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for name, value in (("w", w), ("b", b), ("clip_lo", clip_lo),
                            ("clip_hi", clip_hi), ("resid_std", resid_std)):
            self.register_buffer(name, torch.tensor(np.asarray(value),
                                                    dtype=dtype))

    @property
    def input_dim(self) -> int:
        return self.w.shape[0]

    @property
    def avg_labels(self) -> torch.Tensor:
        """Label-range stand-in ([lo, hi]) for range-reading callers."""
        return torch.stack([self.clip_lo, self.clip_hi])

    @staticmethod
    def fit(x, y, input_dim: int, reg: float = 1e-3,
            dtype: torch.dtype = torch.float32) -> "RidgeRegressor":
        """Least squares with L2 ``reg`` (relative to the mean feature
        scale) on the first ``input_dim`` features, solved in float64
        numpy on the host; ``dtype`` buffers."""
        x = np.asarray(x, np.float64)[:, :input_dim]
        y = np.asarray(y, np.float64)
        xm = x.mean(axis=0)
        ym = y.mean()
        xc = x - xm
        g = xc.T @ xc
        lam = reg * np.trace(g) / max(g.shape[0], 1)
        w = np.linalg.solve(g + lam * np.eye(g.shape[0]), xc.T @ (y - ym))
        pred = xc @ w + ym
        resid = float(np.sqrt(np.mean((pred - y) ** 2)))
        b = float(ym - xm @ w)
        return RidgeRegressor(w, b, float(y.min()), float(y.max()), resid,
                              dtype)

    def regression(self, x: torch.Tensor, estimate_std: bool = False
                   ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        out = torch.clamp(x @ self.w + self.b, self.clip_lo, self.clip_hi)
        if not estimate_std:
            return out
        return out, self.resid_std.expand(out.shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.regression(x)
