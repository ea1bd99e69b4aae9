"""Graph-moment accumulation and eigensolves for GSFA training, on the device.

Port of ``pyfaceanalysis_tpu.models.moments``. Training a GSFA layer is
second-moment accumulation, (N, F, D) data -> (F, D, D) covariance and edge
scatter, which are batched products; the generalized eigensolves on the
(F, D, D) results are batched too. Everything stays on the data's device;
only the label sorts of the serial graph and the class list of the
clustered graph are host numpy (labels are small and live on the host).

Closed forms (no edge enumeration):

- temporal:  A = mean over consecutive diffs of dx dx^T
- serial:    groups g of equal size m in label order; edges between all
             pairs of consecutive groups:
                 sum_g [ m (M_g + M_{g+1}) - s_g s_{g+1}^T - s_{g+1} s_g^T ]
             where sum_g m (M_g + M_{g+1}) = m (2 M_tot - M_first - M_last).
- clustered: A = sum_c 2 (n_c M_c - s_c s_c^T) / n_c.

Eigenvectors are determined up to sign (any two eigensolvers may return a
column negated); the networks are sign-equivariant, so trained features
agree with another solver's up to a per-column sign. No sign convention is
imposed, as the JAX package imposes none.

The solvers take float32 moments, as the JAX package's do, but solve in
float64 on the same device and return float32. The rank-control penalty
puts eigenvalues of 1e6 beside slownesses of 1e-3 in one matrix, and a
float32 eigensolver is accurate only relative to the matrix norm:
cuSOLVER's float32 ``eigh`` on an H100 returned slownesses off by factors
of 6 to 59 where LAPACK's float32 was within 1e-4 and float64 within 1e-13
on either (tools/torch_eigh_check.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, F, D), (N, F, E) -> (F, D, E) = sum_n a_n^T b_n per field."""
    return torch.einsum("nfd,nfe->fde", a, b)


def _eigh(x: torch.Tensor):
    """Batched symmetric eigendecomposition, ascending, of the symmetrized
    input (``jnp.linalg.eigh`` symmetrizes its input the same way)."""
    return torch.linalg.eigh((x + x.transpose(-1, -2)) / 2)


def mean_cov(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, F, D) -> (mean (F, D), cov (F, D, D))."""
    n = x.shape[0]
    mean = x.mean(dim=0)
    xc = x - mean
    return mean, _gram(xc, xc) / (n - 1)


def temporal_scatter(xc: torch.Tensor) -> torch.Tensor:
    dx = xc[1:] - xc[:-1]
    return _gram(dx, dx) / max(dx.shape[0], 1)


def serial_scatter(xc_sorted: torch.Tensor, num_groups: int) -> torch.Tensor:
    """xc_sorted: (N, F, D) centred data already sorted by label; the rows
    past the last whole group (N mod num_groups) are dropped."""
    N, F, D = xc_sorted.shape
    m = N // num_groups
    xg = xc_sorted[: m * num_groups].reshape(num_groups, m, F, D)
    s = xg.sum(dim=1)                                      # (G, F, D)
    M_tot = _gram(xg.reshape(num_groups * m, F, D),
                  xg.reshape(num_groups * m, F, D))
    M_first = _gram(xg[0], xg[0])
    M_last = _gram(xg[-1], xg[-1])
    cross = _gram(s[:-1], s[1:])
    A = (m * (2.0 * M_tot - M_first - M_last)
         - cross - cross.transpose(-1, -2))
    edges = m * m * (num_groups - 1)
    return A / edges


def clustered_scatter(xc: torch.Tensor, onehot: torch.Tensor,
                      num_classes: int) -> torch.Tensor:
    """xc: (N, F, D) centred; onehot: (N, C) class indicators."""
    counts = onehot.sum(dim=0)                             # (C,)
    w = onehot / torch.clamp(counts, min=1.0)[None, :]     # weight 1/n_c
    s = torch.einsum("nc,nfd->cfd", w, xc)                 # s_c / n_c
    # M_c / n_c, one class at a time: a (N, C, F, D) product would hold C
    # copies of the data.
    M = torch.stack([_gram(xc * w[:, c, None, None], xc)
                     for c in range(num_classes)])
    A = (2.0 * torch.einsum("c,cfde->fde", counts, M)
         - 2.0 * torch.einsum("c,cfde->fde", counts,
                              s[:, :, :, None] * s[:, :, None, :]))
    total = torch.clamp((counts - 1.0).sum(), min=1.0)
    return A / total


def gsfa_moments(x: torch.Tensor, graph: str, labels=None,
                 num_groups: int = 50, label_weights=None):
    """Moments (mean (F, D), B (F, D, D), A (F, D, D)) on ``x``'s device;
    the host labels drive the graph structure.

    ``serial`` takes (N,) labels or an (N, K) label matrix: the edge
    scatter is then the weighted average of the K per-label serial graphs
    (one feature space serving several regression targets). Labels are
    sorted with numpy's stable argsort, so ties fall as in the JAX package.
    """
    mean, B = mean_cov(x)
    xc = x - mean
    if graph == "temporal":
        A = temporal_scatter(xc)
    elif graph == "serial":
        lab = np.asarray(labels)
        if lab.ndim == 1:
            lab = lab[:, None]
        w = (np.ones(lab.shape[1]) if label_weights is None
             else np.asarray(label_weights, np.float64))
        A = None
        for k in range(lab.shape[1]):
            order = torch.as_tensor(np.argsort(lab[:, k], kind="stable"),
                                    device=xc.device)
            Ak = float(w[k]) * serial_scatter(xc[order], num_groups)
            A = Ak if A is None else A + Ak
        A = A / float(w.sum())
    elif graph == "clustered":
        classes, dense = np.unique(np.asarray(labels), return_inverse=True)
        onehot = torch.as_tensor(
            np.eye(len(classes), dtype=np.float32)[dense.reshape(-1)],
            device=xc.device)
        A = clustered_scatter(xc, onehot, len(classes))
    else:
        raise ValueError(f"unknown graph {graph!r}")
    return mean, B, A


def solve_gsfa_device(A: torch.Tensor, B: torch.Tensor, out_dim: int,
                      reg: float = 1e-4) -> torch.Tensor:
    """Smallest ``out_dim`` eigenvectors of A w = lambda B w per field, on
    the device (in float64, see the module's text), with relative Tikhonov
    regularization of B. Returns (F, D, out_dim) in B's dtype."""
    dtype = B.dtype
    A, B = A.double(), B.double()
    D = B.shape[-1]
    eye = torch.eye(D, dtype=B.dtype, device=B.device)
    trB = torch.diagonal(B, dim1=-2, dim2=-1).sum(-1)[:, None, None] / D
    Breg = B + (reg * trB + 1e-12) * eye
    evals, evecs = _eigh(Breg)
    # Rank control: directions below 1e-3 of the top variance are zeroed in
    # the whitener AND penalized in M (a zero row would otherwise read as
    # eigenvalue 0, "perfectly slow", and take the solution). The cut sits
    # well above float32 eigh noise and keeps whitening gains bounded.
    bad = evals <= 1e-3 * evals.max(dim=-1, keepdim=True).values
    inv_sqrt = torch.where(bad, torch.zeros_like(evals),
                           1.0 / torch.sqrt(torch.clamp(evals, min=1e-12)))
    wh = evecs * inv_sqrt[:, None, :]
    M = wh.transpose(-1, -2) @ A @ wh
    M = (M + M.transpose(-1, -2)) * 0.5
    penalty = torch.where(bad, torch.full_like(evals, 1e6),
                          torch.zeros_like(evals))
    M = M + torch.diag_embed(penalty)
    _, V = _eigh(M)
    return (wh @ V[..., :out_dim]).to(dtype)


def solve_pca_device(B: torch.Tensor, out_dim: int) -> torch.Tensor:
    """Principal ``out_dim`` eigenvectors per field, largest first (solved
    in float64, returned in B's dtype)."""
    _, evecs = _eigh(B.double())
    return torch.flip(evecs, dims=[-1])[..., :out_dim].to(B.dtype)


def solve_igsfa_device(A: torch.Tensor, B: torch.Tensor, slow_dim: int,
                       out_dim: int, reg: float = 1e-5) -> torch.Tensor:
    """Information-preserving GSFA: ``slow_dim`` GSFA directions and a
    whitened PCA of the slow-reconstruction residual, folded into one
    (F, D, out_dim) map.

    From the moments alone: with W the slow projection, the least-squares
    reconstruction coefficient is ``coef = (W^T B W)^-1 W^T B`` and the
    residual covariance is ``B - G^T S^-1 G`` (G = W^T B). The PCA part is
    whitened so every output has about unit variance. Solved in float64,
    returned in B's dtype."""
    dtype = B.dtype
    A, B = A.double(), B.double()
    W = solve_gsfa_device(A, B, slow_dim)                  # (F, D, s)
    G = W.transpose(-1, -2) @ B                            # W^T B (F, s, D)
    S = G @ W                                              # W^T B W
    s_dim = S.shape[-1]
    trS = torch.diagonal(S, dim1=-2, dim2=-1).sum(-1)[:, None, None] / s_dim
    eye = torch.eye(s_dim, dtype=S.dtype, device=S.device)
    coef = torch.linalg.solve(S + (reg * trS + 1e-12) * eye, G)
    resid_cov = B - coef.transpose(-1, -2) @ G
    resid_cov = (resid_cov + resid_cov.transpose(-1, -2)) * 0.5
    evals, evecs = _eigh(resid_cov)
    pca_dim = out_dim - slow_dim
    P = torch.flip(evecs, dims=[-1])[..., :pca_dim]        # (F, D, p)
    lam = torch.flip(evals, dims=[-1])[..., :pca_dim]
    top = evals[..., -1][:, None]
    scale = torch.where(lam <= 1e-3 * top, torch.zeros_like(lam),
                        1.0 / torch.sqrt(torch.clamp(lam, min=1e-12)))
    # Residual projection in input coordinates: (xc - xc W coef) P
    # = xc (P - W (coef P)), whitened per direction.
    WcP = W @ (coef @ P)
    W_pca = (P - WcP) * scale[:, None, :]
    return torch.cat([W, W_pca], dim=-1).to(dtype)
