"""Gaussian classifier used as a soft regressor -- the cascade "decoder".

Port of ``pyfaceanalysis_tpu.ops.gaussian.GaussianRegressor`` (inference and
the constructor from legacy-style arrays; ``fit`` belongs to training):

    P(c | x) ~ prior_c / sqrt_det_cov_c * exp(-1/2 (x - mu_c)^T A_c (x - mu_c))
    regression(x) = sum_c P(c | x) * avg_labels_c
    std(x)        = sqrt(sum_c P(c | x) * avg_labels_c^2 - regression(x)^2)

Keeps the JAX package's centred quadratic form, its 3e37 clamp and its -80
floor on the shifted logits.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch
from torch import nn


class GaussianRegressor(nn.Module):
    """``means`` (C, D), ``inv_covs`` (C, D, D), ``log_norm`` (C,) =
    log(prior_c) - log(sqrt_det_cov_c), ``avg_labels`` (C,); float32
    buffers."""

    def __init__(self, means, inv_covs, log_norm, avg_labels):
        super().__init__()
        for name, value in (("means", means), ("inv_covs", inv_covs),
                            ("log_norm", log_norm), ("avg_labels", avg_labels)):
            self.register_buffer(name, torch.tensor(np.asarray(value),
                                                    dtype=torch.float32))

    @property
    def num_classes(self) -> int:
        return self.means.shape[0]

    @property
    def input_dim(self) -> int:
        """Feature truncation width (classifier ``input_dim``)."""
        return self.means.shape[1]

    @staticmethod
    def create(means, inv_covs, sqrt_det_covs, priors, avg_labels
               ) -> "GaussianRegressor":
        """From the attributes of a legacy ``GaussianClassifier``: ``means``
        (C, D), ``inv_covs`` (C, D, D), ``sqrt_det_covs`` (C,) =
        sqrt(det(cov_c)), ``priors`` (C,), ``avg_labels`` (C,). The log
        normalizer is formed in float64 before the float32 buffers are
        made."""
        sqrt_det_covs = np.asarray(sqrt_det_covs, np.float64)
        priors = np.asarray(priors, np.float64)
        log_norm = np.log(priors) - np.log(sqrt_det_covs)
        return GaussianRegressor(means, inv_covs, log_norm, avg_labels)

    def log_posteriors(self, x: torch.Tensor) -> torch.Tensor:
        """(B, D) -> (B, C) unnormalized log posteriors, in the centred form
        (x - mu)^T A (x - mu): the expanded form loses digits to
        cancellation in float32 for well-matched patches."""
        diff = x[:, None, :] - self.means[None, :, :]           # (B, C, D)
        dA = torch.einsum("bcd,cde->bce", diff, self.inv_covs)
        maha = torch.einsum("bce,bce->bc", dA, diff)
        # An infinite quadratic form would make every logit -inf and the
        # softmax NaN; the clamp keeps the winner winning.
        maha = torch.clamp(maha, 0.0, 3.0e37)
        return self.log_norm[None, :] - 0.5 * maha

    def posteriors(self, x: torch.Tensor) -> torch.Tensor:
        logp = self.log_posteriors(x)
        logp = logp - logp.max(dim=-1, keepdim=True).values
        p = torch.exp(torch.clamp(logp, min=-80.0))
        return p / p.sum(dim=-1, keepdim=True)

    def regression(self, x: torch.Tensor, estimate_std: bool = False
                   ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Soft regression output (B,), optionally with the posterior label
        std. Features beyond ``input_dim`` must already be truncated."""
        p = self.posteriors(x)
        reg = p @ self.avg_labels
        if not estimate_std:
            return reg
        second = p @ (self.avg_labels ** 2)
        var = torch.clamp(second - reg ** 2, min=0.0)
        return reg, torch.sqrt(var)

    def classify(self, x: torch.Tensor) -> torch.Tensor:
        """Hard class index (argmax posterior), mirror of MDP ``label()``."""
        return torch.argmax(self.log_posteriors(x), dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.regression(x)
