"""Trained SFA projections (forward only).

Port of ``pyfaceanalysis_tpu.models.sfa.LinearNode``; the solvers that fit
the nodes belong to the training slice and are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn


class LinearNode(nn.Module):
    """A trained affine projection per receptive field: y = (x - mean) @ W.

    ``mean``: (F, D), ``W``: (F, D, O), both float32 buffers.
    """

    def __init__(self, mean, W):
        super().__init__()
        self.register_buffer("mean", torch.tensor(np.asarray(mean),
                                                  dtype=torch.float32))
        self.register_buffer("W", torch.tensor(np.asarray(W),
                                               dtype=torch.float32))

    @property
    def out_dim(self) -> int:
        return self.W.shape[-1]

    def forward(self, x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """(B, F, D) -> (B, F, O) (or (B, D) -> (B, O) when F == 1).

        ``compute_dtype=torch.bfloat16`` rounds the OPERANDS (the centred
        input and W) to bf16 and multiplies them in float32, which is the
        JAX package's bf16-operand / f32-accumulate product. A bf16 einsum
        is not used: on CUDA it returns bf16 and would round the output
        too. The f32 product relies on ``torch.backends.cuda.matmul.
        allow_tf32`` staying False (PyTorch's default); TF32 would round
        the operands to 10 mantissa bits.
        """
        squeeze = x.dim() == 2
        if squeeze:
            x = x[:, None, :]
        xc = x - self.mean[None]
        W = self.W
        if compute_dtype is not None:
            xc = xc.to(compute_dtype).float()
            W = W.to(compute_dtype).float()
        y = torch.einsum("bfd,fdo->bfo", xc, W)
        return y[:, 0, :] if squeeze else y
