"""Hierarchical SFA networks as stacks of batched block-diagonal products.

Port of ``pyfaceanalysis_tpu.models.network``. A layer owns a static
(F, k) gather map ("switchboard") from the previous layer's flat output, a
nonlinear :class:`Expansion` and a trained :class:`LinearNode` with
per-field weights (F, k_exp, d). Executing a layer is one gather, one
expansion, one ``bfi,fio->bfo`` product and a clip (the JAX package leaves
them to XLA, not to a Pallas kernel). The product's left operand -- the
previous layer's clip, the gather, the expansion, the centring and the
operand rounding -- is :func:`layer_operand_ref`, plain torch ops, on the
CPU, and one launch of the layer kernel (``ops/cuda_net_layer.py``), the
same bits, on a card. A network chains the raw products, each clipped as
the next layer reads it, so only the last layer's clip and reshape
remain.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from pyfaceanalysis_torch.models.expansion import Expansion
from pyfaceanalysis_torch.models.sfa import LinearNode
from pyfaceanalysis_torch.ops import cuda_net_layer


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


def layer_operand_ref(spec: LayerSpec, node: LinearNode, index: torch.Tensor,
                      x: torch.Tensor, clip: Optional[float] = None,
                      compute_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """The (B, F, D) left operand of a layer's product, in plain torch ops:
    ``x`` is the layer's (B, P) input, or the previous layer's (B, G, O)
    product with that layer's ``clip`` (None: none). ``index`` is the
    (F, k) switchboard map on ``x``'s device."""
    if clip is not None:
        x = torch.clamp(x, -clip, clip)
    x = x.reshape(x.shape[0], -1)
    return node.centred(spec.expansion(x[:, index]), compute_dtype)


def layer_operand(spec: LayerSpec, node: LinearNode, index: torch.Tensor,
                  x: torch.Tensor, clip: Optional[float] = None,
                  compute_dtype: Optional[torch.dtype] = None
                  ) -> torch.Tensor:
    """:func:`layer_operand_ref`'s operand: the layer kernel on a card,
    the plain version elsewhere."""
    if x.device.type != "cuda":
        return layer_operand_ref(spec, node, index, x, clip, compute_dtype)
    return cuda_net_layer.layer_operand(
        x, index, spec.expansion.columns(index.shape[1]),
        node.mean_contiguous(), spec.expansion.exponent, clip, compute_dtype)


def layer_product(spec: LayerSpec, node: LinearNode, index: torch.Tensor,
                  x: torch.Tensor, clip: Optional[float] = None,
                  compute_dtype: Optional[torch.dtype] = None
                  ) -> torch.Tensor:
    """A layer's product (B, F, out_dim), before its clip and as the
    product leaves it (arguments as :func:`layer_operand_ref`)."""
    return torch.einsum("bfd,fdo->bfo",
                        layer_operand(spec, node, index, x, clip,
                                      compute_dtype),
                        node.weights(compute_dtype))


def _clipped_rows(y: torch.Tensor, clip: Optional[float]) -> torch.Tensor:
    if clip is not None:
        y = torch.clamp(y, -clip, clip)
    return y.reshape(y.shape[0], -1)


def apply_layer(spec: LayerSpec, node: LinearNode, index: torch.Tensor,
                x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(B, P) flat -> (B, F * out_dim) flat; ``index`` is the (F, k)
    switchboard map on ``x``'s device."""
    return _clipped_rows(layer_product(spec, node, index, x, None,
                                       compute_dtype), spec.clip)


def apply_network(net: HierarchicalNetwork, x: torch.Tensor,
                  compute_dtype: Optional[torch.dtype] = None
                  ) -> torch.Tensor:
    """Runs all layers. ``compute_dtype=torch.bfloat16`` rounds the product
    OPERANDS only (see :meth:`LinearNode.forward`); expansions, clipping
    and the regression heads stay float32. Each layer reads the previous
    one's product as it is and applies its clip on load."""
    clip = None
    for spec, node, index in zip(net.specs, net.params, net.indices):
        x = layer_product(spec, node, index, x, clip, compute_dtype)
        clip = spec.clip
    return _clipped_rows(x, clip)
