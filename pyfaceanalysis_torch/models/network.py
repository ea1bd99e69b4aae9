"""Hierarchical SFA networks as stacks of batched block-diagonal products.

Port of ``pyfaceanalysis_tpu.models.network``. A layer owns a static
(F, k) gather map ("switchboard") from the previous layer's flat output, a
nonlinear :class:`Expansion` and a trained :class:`LinearNode` with
per-field weights (F, k_exp, d). Executing a layer is one gather, one
expansion, one ``bfi,fio->bfo`` product and a clip -- plain torch ops (the
JAX package leaves them to XLA, not to a Pallas kernel).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from pyfaceanalysis_torch.models.expansion import Expansion
from pyfaceanalysis_torch.models.sfa import LinearNode


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Static description of one layer.

    ``field_indices``: (F, k) indices into the previous layer's flattened
    output (field-major). ``node``: "sfa" | "pca" | "igsfa" -- the solver
    that trained the layer. ``out_dim``: features per field. ``clip``:
    post-projection clipping in output-std units (None disables).
    """

    field_indices: Tuple[Tuple[int, ...], ...]
    expansion: Expansion
    out_dim: int
    node: str = "sfa"
    slow_dim: Optional[int] = None
    clip: Optional[float] = 4.0

    @property
    def num_fields(self) -> int:
        return len(self.field_indices)

    @property
    def field_size(self) -> int:
        return len(self.field_indices[0])

    def indices_array(self) -> np.ndarray:
        return np.asarray(self.field_indices, np.int32)


class HierarchicalNetwork(nn.Module):
    """Specs + trained nodes for a full network; ``forward`` mirrors the
    reference's ``flow.execute``: (B, D_in) flat pixel rows -> (B, D_out).

    The switchboard maps live as int64 buffers (``indices[i]``), so the
    whole network moves between devices with ``.to``.
    """

    def __init__(self, specs: Sequence[LayerSpec],
                 params: Sequence[LinearNode], input_hw: Tuple[int, int]):
        super().__init__()
        self.specs = tuple(specs)
        self.params = nn.ModuleList(params)
        self.input_hw = tuple(input_hw)
        for i, spec in enumerate(self.specs):
            self.register_buffer(
                f"idx_{i}", torch.as_tensor(spec.indices_array(),
                                            dtype=torch.int64))

    @property
    def indices(self) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f"idx_{i}") for i in range(len(self.specs)))

    @property
    def out_dim(self) -> int:
        last = self.specs[-1]
        return last.num_fields * last.out_dim

    def forward(self, x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return apply_network(self, x, compute_dtype=compute_dtype)

    def execute(self, x: torch.Tensor) -> torch.Tensor:
        """(B, h*w) -> (B, out_dim): the JAX package's name of ``forward``
        (the reference's ``flow.execute``)."""
        return apply_network(self, x)


def apply_layer(spec: LayerSpec, node: LinearNode, index: torch.Tensor,
                x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(B, P) flat -> (B, F * out_dim) flat; ``index`` is the (F, k)
    switchboard map on ``x``'s device."""
    fields = x[:, index]                          # (B, F, k)
    expanded = spec.expansion(fields)             # (B, F, k_exp)
    y = node(expanded, compute_dtype=compute_dtype)
    if spec.clip is not None:
        y = torch.clamp(y, -spec.clip, spec.clip)
    return y.reshape(y.shape[0], -1)


def apply_network(net: HierarchicalNetwork, x: torch.Tensor,
                  compute_dtype: Optional[torch.dtype] = None
                  ) -> torch.Tensor:
    """Runs all layers. ``compute_dtype=torch.bfloat16`` rounds the product
    OPERANDS only (see :meth:`LinearNode.forward`); expansions, clipping
    and the regression heads stay float32."""
    for spec, node, index in zip(net.specs, net.params, net.indices):
        x = apply_layer(spec, node, index, x, compute_dtype=compute_dtype)
    return x
