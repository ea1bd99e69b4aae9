"""SFA / GSFA / PCA nodes: the trained projection and its host solvers.

Port of ``pyfaceanalysis_tpu.models.sfa``. :class:`LinearNode` is the
trained affine projection a network layer applies. The fit functions are
the JAX package's host float64 numpy solvers, copied as they are:

    minimize   w^T A w   s.t.   w^T B w = 1,  decorrelated
    A = edge scatter of the training graph, B = covariance of x

solved per receptive field as a symmetric generalized eigenproblem
(smallest eigenvalues first) by whitening B. Graphs with closed-form edge
scatter: ``serial`` (label-ordered groups, edges between consecutive
groups), ``clustered`` (edges within a label class), ``temporal``
(consecutive samples). Inputs are (N, F, D) -- F receptive fields solved
together -- or (N, D), treated as F = 1. The trainer's own path solves on
the device instead (:mod:`pyfaceanalysis_torch.models.moments`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn


def _tensor(value, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A ``dtype`` tensor from a tensor (kept on its device) or an array.
    An array keeps its strides: the shipped archives hold Fortran-ordered
    weights, and the product's kernel, so its last bits, depends on the
    layout. Torch takes no negative stride (a reversed view), so such an
    array is copied first."""
    if isinstance(value, torch.Tensor):
        return value.detach().to(dtype)
    value = np.asarray(value)
    if any(st < 0 for st in value.strides):
        value = value.copy()
    return torch.tensor(value, dtype=dtype)


class LinearNode(nn.Module):
    """A trained affine projection per receptive field: y = (x - mean) @ W.

    ``mean``: (F, D), ``W``: (F, D, O), both buffers of ``dtype`` (float32
    unless a fit is asked for another); either may be given as an array or
    as a tensor, which stays on its device.
    """

    def __init__(self, mean, W, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.register_buffer("mean", _tensor(mean, dtype))
        self.register_buffer("W", _tensor(W, dtype))
        self._kept = {}

    @property
    def out_dim(self) -> int:
        return self.W.shape[-1]

    def _keep(self, key, source: torch.Tensor, make) -> torch.Tensor:
        """``make(source)``, made once per buffer (and in-place version of
        it) and kept. Not kept when made inside a CUDA graph's capture,
        where its tensor would hold its values only after a replay."""
        hit = self._kept.get(key)
        if hit is not None and hit[0] is source and hit[1] == source._version:
            return hit[2]
        out = make(source)
        if not (source.is_cuda and torch.cuda.is_current_stream_capturing()):
            self._kept[key] = (source, source._version, out)
        return out

    def weights(self, compute_dtype: Optional[torch.dtype] = None
                ) -> torch.Tensor:
        """W as the product takes it: ``W.to(compute_dtype).float()`` (the
        operand rounding, which keeps W's strides: they choose the
        product's kernel, so its last bits), or W itself."""
        if compute_dtype is None:
            return self.W
        return self._keep(("W", compute_dtype), self.W,
                          lambda W: W.to(compute_dtype).float())

    def mean_contiguous(self) -> torch.Tensor:
        """The (F, D) mean in row-major order (the archives hold some
        Fortran-ordered), as the layer kernel reads it."""
        return self._keep("mean", self.mean, torch.Tensor.contiguous)

    def centred(self, x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The product's left operand from (B, F, D) ``x``: ``x - mean``,
        rounded to ``compute_dtype`` and back when one is given."""
        xc = x - self.mean[None]
        if compute_dtype is not None:
            xc = xc.to(compute_dtype).float()
        return xc

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
        y = torch.einsum("bfd,fdo->bfo", self.centred(x, compute_dtype),
                         self.weights(compute_dtype))
        return y[:, 0, :] if squeeze else y


def _ensure_3d(x) -> Tuple[np.ndarray, bool]:
    x = np.asarray(x, np.float64)
    if x.ndim == 2:
        return x[:, None, :], True
    return x, False


def temporal_edge_scatter(x: np.ndarray) -> np.ndarray:
    """A from consecutive-sample differences: (N, F, D) -> (F, D, D)."""
    dx = x[1:] - x[:-1]
    return np.einsum("nfd,nfe->fde", dx, dx) / max(len(dx), 1)


def serial_edge_scatter(x: np.ndarray, labels: np.ndarray,
                        num_groups: int = 50) -> np.ndarray:
    """Serial-graph edge scatter: all pairs between consecutive label
    groups, from per-group moments (s_g = sum of x, M_g = sum of x x^T):

      sum_{i in g, j in g+1} (xi-xj)(xi-xj)^T
        = n_{g+1} M_g + n_g M_{g+1} - s_g s_{g+1}^T - s_{g+1} s_g^T
    """
    N, F, D = x.shape
    order = np.argsort(labels, kind="stable")
    xs = x[order]
    bounds = np.linspace(0, N, num_groups + 1).astype(int)
    A = np.zeros((F, D, D))
    total_edges = 0.0
    s_prev = M_prev = n_prev = None
    for g in range(num_groups):
        xg = xs[bounds[g]:bounds[g + 1]]
        n = len(xg)
        if n == 0:
            continue
        s = xg.sum(axis=0)                                 # (F, D)
        M = np.einsum("nfd,nfe->fde", xg, xg)              # (F, D, D)
        if s_prev is not None:
            A += (n * M_prev + n_prev * M
                  - np.einsum("fd,fe->fde", s_prev, s)
                  - np.einsum("fd,fe->fde", s, s_prev))
            total_edges += n * n_prev
        s_prev, M_prev, n_prev = s, M, n
    return A / max(total_edges, 1.0)


def clustered_edge_scatter(x: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Clustered-graph edge scatter: all intra-class pairs in closed form,
    sum_{i,j in c} (xi-xj)(xi-xj)^T = 2 (n_c M_c - s_c s_c^T), each class
    weighted by 1/n_c."""
    N, F, D = x.shape
    A = np.zeros((F, D, D))
    total = 0.0
    for c in np.unique(labels):
        xc = x[labels == c]
        n = len(xc)
        if n < 2:
            continue
        s = xc.sum(axis=0)
        M = np.einsum("nfd,nfe->fde", xc, xc)
        A += 2.0 * (n * M - np.einsum("fd,fe->fde", s, s)) / n
        total += float(n - 1)
    return A / max(total, 1.0)


def covariance(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Mean (F, D) and covariance (F, D, D) over the sample axis."""
    mean = x.mean(axis=0)
    xc = x - mean
    cov = np.einsum("nfd,nfe->fde", xc, xc) / max(len(x) - 1, 1)
    return mean, cov


def solve_gsfa(A: np.ndarray, B: np.ndarray, out_dim: int,
               reg: float = 1e-7) -> np.ndarray:
    """Solves A w = lambda B w for the ``out_dim`` smallest eigenvalues by
    whitening (B = U S U^T, Wh = U S^-1/2, then eigh of Wh^T A Wh);
    returns (F, D, out_dim). Directions whose B eigenvalue is below
    ``reg * max`` leave the whitened space."""
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    F, D, _ = B.shape
    W = np.zeros((F, D, out_dim))
    evals_B, evecs_B = np.linalg.eigh(B)
    for f in range(F):
        ev, Uf = evals_B[f], evecs_B[f]
        keep = ev > max(ev.max(), 0.0) * reg + 1e-30
        Uf = Uf[:, keep]
        wh = Uf / np.sqrt(ev[keep])
        M = wh.T @ A[f] @ wh
        M = (M + M.T) * 0.5
        _, V = np.linalg.eigh(M)
        k = min(out_dim, V.shape[1])
        W[f, :, :k] = wh @ V[:, :k]
    return W


def sfa_fit(x, out_dim: int, graph: str = "temporal",
            labels: Optional[np.ndarray] = None, num_groups: int = 50,
            reg: float = 1e-7, dtype: torch.dtype = torch.float32
            ) -> LinearNode:
    """Fits (G)SFA on (N, F, D) or (N, D) data. ``graph``: "temporal",
    "serial" or "clustered" (the last two need ``labels``). The node's
    buffers are ``dtype``."""
    x3, _ = _ensure_3d(x)
    mean, B = covariance(x3)
    xc = x3 - mean
    if graph == "temporal":
        A = temporal_edge_scatter(xc)
    elif graph == "serial":
        A = serial_edge_scatter(xc, np.asarray(labels), num_groups)
    elif graph == "clustered":
        A = clustered_edge_scatter(xc, np.asarray(labels))
    else:
        raise ValueError(f"unknown graph {graph!r}")
    return LinearNode(mean, solve_gsfa(A, B, out_dim, reg=reg), dtype)


def pca_fit(x, out_dim: int, dtype: torch.dtype = torch.float32
            ) -> LinearNode:
    """Fits PCA on (N, F, D) or (N, D) data (principal components first);
    the node's buffers are ``dtype``."""
    x3, _ = _ensure_3d(x)
    mean, cov = covariance(x3)
    _, evecs = np.linalg.eigh(cov)                   # ascending
    return LinearNode(mean, evecs[..., ::-1][..., :out_dim], dtype)


def igsfa_fit(x, slow_dim: int, out_dim: int, graph: str = "temporal",
              labels: Optional[np.ndarray] = None, num_groups: int = 50,
              reg: float = 1e-7, dtype: torch.dtype = torch.float32
              ) -> LinearNode:
    """Information-preserving GSFA: ``slow_dim`` slow features and a PCA of
    the slow-reconstruction residual, ``out_dim`` outputs in all, folded
    into one affine node [W_slow | P_resid] on centred x."""
    x3, _ = _ensure_3d(x)
    N, F, D = x3.shape
    slow = sfa_fit(x3, slow_dim, graph=graph, labels=labels,
                   num_groups=num_groups, reg=reg)
    # The float32 node, as the JAX function reads it back.
    mean = slow.mean.numpy()
    Ws = slow.W.numpy()                               # (F, D, slow_dim)
    xc = x3 - mean
    y = np.einsum("nfd,fds->nfs", xc, Ws)             # slow outputs
    W_out = np.zeros((F, D, out_dim))
    pca_dim = out_dim - slow_dim
    for f in range(F):
        coef, *_ = np.linalg.lstsq(y[:, f, :], xc[:, f, :], rcond=None)
        resid = xc[:, f, :] - y[:, f, :] @ coef
        cov = resid.T @ resid / max(N - 1, 1)
        _, evecs = np.linalg.eigh(cov)
        P = evecs[:, ::-1][:, :pca_dim]               # (D, pca_dim)
        # (x - y coef) P = x (P - Ws coef P)
        W_out[f, :, :slow_dim] = Ws[f]
        W_out[f, :, slow_dim:slow_dim + P.shape[1]] = P - Ws[f] @ (coef @ P)
    return LinearNode(mean, W_out, dtype)
