"""Gaussian classifier used as a soft regressor -- the cascade "decoder".

Port of ``pyfaceanalysis_tpu.ops.gaussian.GaussianRegressor``: inference,
the constructor from legacy-style arrays and the host ``fit``:

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
    log(prior_c) - log(sqrt_det_cov_c), ``avg_labels`` (C,); buffers of
    ``dtype`` (float32 unless asked for another)."""

    def __init__(self, means, inv_covs, log_norm, avg_labels,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for name, value in (("means", means), ("inv_covs", inv_covs),
                            ("log_norm", log_norm), ("avg_labels", avg_labels)):
            self.register_buffer(name, torch.tensor(np.asarray(value),
                                                    dtype=dtype))

    @property
    def num_classes(self) -> int:
        return self.means.shape[0]

    @property
    def input_dim(self) -> int:
        """Feature truncation width (classifier ``input_dim``)."""
        return self.means.shape[1]

    @staticmethod
    def create(means, inv_covs, sqrt_det_covs, priors, avg_labels,
               dtype: torch.dtype = torch.float32) -> "GaussianRegressor":
        """From the attributes of a legacy ``GaussianClassifier``: ``means``
        (C, D), ``inv_covs`` (C, D, D), ``sqrt_det_covs`` (C,) =
        sqrt(det(cov_c)), ``priors`` (C,), ``avg_labels`` (C,). The log
        normalizer is formed in float64 before the ``dtype`` buffers are
        made."""
        sqrt_det_covs = np.asarray(sqrt_det_covs, np.float64)
        priors = np.asarray(priors, np.float64)
        log_norm = np.log(priors) - np.log(sqrt_det_covs)
        return GaussianRegressor(means, inv_covs, log_norm, avg_labels,
                                 dtype)

    @staticmethod
    def fit(x, labels, avg_labels=None, reg: float = 1e-3,
            dtype: torch.dtype = torch.float32) -> "GaussianRegressor":
        """Trains per-class Gaussians in float64 numpy on the host (the
        JAX package's fit, copied); the module is made on the CPU, with
        ``dtype`` buffers.

        Args:
            x: (N, D) features.
            labels: (N,) integer class indices in [0, C).
            avg_labels: (C,) regression target per class; defaults to the
                class index as float.
            reg: relative Tikhonov term: ``reg * mean(diag(cov))`` is added
                to each covariance diagonal (guards small/degenerate classes).
        """
        x = np.asarray(x, np.float64)
        labels = np.asarray(labels)
        classes = np.unique(labels)
        C, D = len(classes), x.shape[1]
        means = np.zeros((C, D))
        inv_covs = np.zeros((C, D, D))
        log_sqrt_det = np.zeros(C)
        priors = np.zeros(C)
        for i, c in enumerate(classes):
            xc = x[labels == c]
            priors[i] = len(xc) / len(x)
            means[i] = xc.mean(axis=0)
            cov = np.atleast_2d(np.cov(xc, rowvar=False, bias=False))
            scale = max(np.trace(cov) / D, 1e-12)
            cov = cov + (reg * scale + 1e-12) * np.eye(D)
            inv_covs[i] = np.linalg.inv(cov)
            log_sqrt_det[i] = 0.5 * np.linalg.slogdet(cov)[1]
        if avg_labels is None:
            avg_labels = classes.astype(np.float64)
        return GaussianRegressor(means, inv_covs,
                                 np.log(priors) - log_sqrt_det, avg_labels,
                                 dtype)

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
