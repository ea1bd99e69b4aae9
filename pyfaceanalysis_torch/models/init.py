"""Deterministic random initialization of network and classifier params.

Port of ``pyfaceanalysis_tpu.models.init``, for compile checks, timings of
untrained topologies and tests. Orthonormal per-field projections keep
activations O(1) through the stack. The draws come from a CPU
``torch.Generator`` seeded with ``seed`` (the JAX package draws from
numpy's ``RandomState``, so one seed gives the two packages different
weights of the same kind).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from pyfaceanalysis_torch.models.network import HierarchicalNetwork
from pyfaceanalysis_torch.models.sfa import LinearNode
from pyfaceanalysis_torch.ops.gaussian import GaussianRegressor


def random_network_params(net: HierarchicalNetwork, seed: int = 0
                          ) -> HierarchicalNetwork:
    """A copy of ``net`` with orthonormal random projections (on the CPU)."""
    gen = torch.Generator().manual_seed(seed)
    params: List[LinearNode] = []
    for spec in net.specs:
        de = spec.expansion.output_dim(spec.field_size)
        F = spec.num_fields
        q, _ = torch.linalg.qr(torch.randn((F, de, spec.out_dim),
                                           generator=gen,
                                           dtype=torch.float64))
        mean = torch.randn((F, de), generator=gen) * 0.01
        params.append(LinearNode(mean, q[..., :spec.out_dim]))
    return HierarchicalNetwork(net.specs, params, net.input_hw)


def random_classifier(input_dim: int, num_classes: int,
                      avg_lo: float, avg_hi: float,
                      seed: int = 0) -> GaussianRegressor:
    gen = torch.Generator().manual_seed(seed)
    means = torch.randn((num_classes, input_dim), generator=gen,
                        dtype=torch.float64).numpy()
    covs = np.stack([np.eye(input_dim)] * num_classes)
    return GaussianRegressor.create(
        means, covs, np.ones(num_classes),
        np.full(num_classes, 1.0 / num_classes),
        np.linspace(avg_lo, avg_hi, num_classes))
