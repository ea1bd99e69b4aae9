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

The moments come in the data's dtype; ``training.trainer.train_network``
hands them float64 data (the JAX trainer accumulates float32): the serial
scatter is a difference of large sums, and with float32 sums its trailing
slow directions follow the rounding of the summation order (see
``train_network``). The solvers solve in float64 on the same device and
return the moments' dtype. The rank-control penalty
puts eigenvalues of 1e6 beside slownesses of 1e-3 in one matrix, and a
float32 eigensolver is accurate only relative to the matrix norm:
cuSOLVER's float32 ``eigh`` on an H100 returned slownesses off by factors
of 6 to 59 where LAPACK's float32 was within 1e-4 and float64 within 1e-13
on either (tools/torch_eigh_check.py).

Sharded data (a data mesh, ``parallel.mesh``): ``mean_cov``,
``gsfa_moments`` and ``temporal_scatter`` also take a list of row blocks,
one per device, in row order; one tensor is the one-block case of the same
code. Each block gives partial sums on its device (``serial_partials``,
``clustered_partials``) and the sums are added on the first block's
device (``serial_combine``, ``clustered_combine``), as XLA's psum adds
them; the moments come back there. The serial graph's label sort stays
global (a row's group is its rank in the global stable order // m, and the
group sums are ``index_add_`` on the device), and the temporal graph's
difference across a block boundary takes the next block's first row (a
one-row halo).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np
import torch


def _gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, F, D), (N, F, E) -> (F, D, E) = sum_n a_n^T b_n per field."""
    return torch.einsum("nfd,nfe->fde", a, b)


def _eigh(x: torch.Tensor):
    """Batched symmetric eigendecomposition, ascending, of the symmetrized
    input (``jnp.linalg.eigh`` symmetrizes its input the same way)."""
    return torch.linalg.eigh((x + x.transpose(-1, -2)) / 2)


Sharded = Union[torch.Tensor, Sequence[torch.Tensor]]


def _blocks(x: Sharded) -> List[torch.Tensor]:
    return [x] if isinstance(x, torch.Tensor) else list(x)


def _psum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum of per-shard partials on the first shard's device."""
    lead = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(lead)
    return total


def _centred(blocks: Sequence[torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """(mean, cov) on the first block's device, and the centred blocks,
    each on its own device."""
    n = sum(b.shape[0] for b in blocks)
    mean = _psum([b.sum(dim=0) for b in blocks]) / n
    xcs = [b - mean.to(b.device) for b in blocks]
    return mean, _psum([_gram(c, c) for c in xcs]) / (n - 1), xcs


def mean_cov(x: Sharded) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, F, D) -> (mean (F, D), cov (F, D, D)); ``x`` may be a list of
    row blocks (see the module's text)."""
    mean, cov, _ = _centred(_blocks(x))
    return mean, cov


def temporal_scatter(xc: Sharded) -> torch.Tensor:
    """Mean of dx dx^T over consecutive centred rows; over row blocks, each
    block's last row pairs with the next block's first (the halo)."""
    blocks = _blocks(xc)
    parts = []
    for j, c in enumerate(blocks):
        if j + 1 < len(blocks):
            c = torch.cat([c, blocks[j + 1][:1].to(c.device)], dim=0)
        dx = c[1:] - c[:-1]
        parts.append(_gram(dx, dx))
    n = sum(b.shape[0] for b in blocks)
    return _psum(parts) / max(n - 1, 1)


def serial_partials(xc: torch.Tensor, group: np.ndarray, num_groups: int
                    ) -> Tuple[torch.Tensor, ...]:
    """One block's partial sums of the serial graph: ``xc`` (n, F, D)
    centred rows, ``group`` (n,) host ints, each row's group in the global
    label order (``num_groups`` or more: past the last whole group, in
    none). Returns s (G, F, D), M_tot, M_first and M_last (F, D, D) on
    ``xc``'s device; the host indices go up in one copy."""
    group = np.asarray(group)
    G = num_groups
    kept = np.nonzero(group < G)[0]
    host = [group[kept], np.nonzero(group == 0)[0],
            np.nonzero(group == G - 1)[0]]
    if len(kept) < len(group):
        host.append(kept)
    idx = torch.as_tensor(np.concatenate(host), device=xc.device).split(
        [len(h) for h in host])
    rows = xc[idx[3]] if len(idx) > 3 else xc
    s = xc.new_zeros((G,) + tuple(xc.shape[1:])).index_add_(0, idx[0], rows)
    first, last = xc[idx[1]], xc[idx[2]]
    return s, _gram(rows, rows), _gram(first, first), _gram(last, last)


def serial_combine(partials: Sequence[Tuple[torch.Tensor, ...]],
                   m: int) -> torch.Tensor:
    """The serial edge scatter (groups of ``m`` rows) from every block's
    :func:`serial_partials`, on the first block's device."""
    s, M_tot, M_first, M_last = (_psum(p) for p in zip(*partials))
    cross = _gram(s[:-1], s[1:])
    A = (m * (2.0 * M_tot - M_first - M_last)
         - cross - cross.transpose(-1, -2))
    return A / (m * m * (s.shape[0] - 1))


def serial_scatter(xc_sorted: torch.Tensor, num_groups: int) -> torch.Tensor:
    """xc_sorted: (N, F, D) centred data already sorted by label; the rows
    past the last whole group (N mod num_groups) are dropped."""
    m = xc_sorted.shape[0] // num_groups
    group = np.arange(xc_sorted.shape[0]) // m
    return serial_combine([serial_partials(xc_sorted, group, num_groups)], m)


def clustered_partials(xc: torch.Tensor, w: torch.Tensor, num_classes: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block's class sums: ``w`` (n, C) is each row's class indicator
    over its class's global count. Returns s (C, F, D) = s_c / n_c and
    M (C, F, D, D) = M_c / n_c on ``xc``'s device."""
    s = torch.einsum("nc,nfd->cfd", w, xc)
    # One class at a time: a (N, C, F, D) product would hold C copies of
    # the data.
    M = torch.stack([_gram(xc * w[:, c, None, None], xc)
                     for c in range(num_classes)])
    return s, M


def clustered_combine(partials: Sequence[Tuple[torch.Tensor, ...]],
                      counts: torch.Tensor) -> torch.Tensor:
    """The clustered edge scatter from every block's
    :func:`clustered_partials` and the global class counts (C,), on the
    first block's device."""
    s, M = (_psum(p) for p in zip(*partials))
    A = (2.0 * torch.einsum("c,cfde->fde", counts, M)
         - 2.0 * torch.einsum("c,cfde->fde", counts,
                              s[:, :, :, None] * s[:, :, None, :]))
    total = torch.clamp((counts - 1.0).sum(), min=1.0)
    return A / total


def clustered_scatter(xc: torch.Tensor, onehot: torch.Tensor,
                      num_classes: int) -> torch.Tensor:
    """xc: (N, F, D) centred; onehot: (N, C) class indicators."""
    counts = onehot.sum(dim=0)                             # (C,)
    w = onehot / torch.clamp(counts, min=1.0)[None, :]     # weight 1/n_c
    return clustered_combine([clustered_partials(xc, w, num_classes)],
                             counts)


def gsfa_moments(x: Sharded, graph: str, labels=None,
                 num_groups: int = 50, label_weights=None):
    """Moments (mean (F, D), B (F, D, D), A (F, D, D)) on ``x``'s device;
    the host labels drive the graph structure. ``x`` may be a list of row
    blocks (see the module's text); the moments are then on the first
    block's device.

    ``serial`` takes (N,) labels or an (N, K) label matrix: the edge
    scatter is then the weighted average of the K per-label serial graphs
    (one feature space serving several regression targets). Labels are
    sorted with numpy's stable argsort, so ties fall as in the JAX package.
    """
    mean, B, xcs = _centred(_blocks(x))
    offsets = np.cumsum([0] + [c.shape[0] for c in xcs])
    n = int(offsets[-1])
    if graph == "temporal":
        A = temporal_scatter(xcs)
    elif graph == "serial":
        lab = np.asarray(labels)
        if lab.ndim == 1:
            lab = lab[:, None]
        w = (np.ones(lab.shape[1]) if label_weights is None
             else np.asarray(label_weights, np.float64))
        m = n // num_groups
        A = None
        for k in range(lab.shape[1]):
            # Each row's group in the global stable label order.
            rank = np.empty(n, np.int64)
            rank[np.argsort(lab[:, k], kind="stable")] = np.arange(n)
            group = rank // m
            Ak = float(w[k]) * serial_combine(
                [serial_partials(c, group[a:b], num_groups)
                 for c, a, b in zip(xcs, offsets[:-1], offsets[1:])], m)
            A = Ak if A is None else A + Ak
        A = A / float(w.sum())
    elif graph == "clustered":
        classes, dense = np.unique(np.asarray(labels), return_inverse=True)
        dense = dense.reshape(-1)
        C = len(classes)
        cls = [torch.as_tensor(dense[a:b], device=c.device)
               for c, a, b in zip(xcs, offsets[:-1], offsets[1:])]
        counts = _psum([torch.bincount(k, minlength=C)
                        for k in cls]).to(mean.dtype)
        partials = []
        for c, k in zip(xcs, cls):
            w = (torch.nn.functional.one_hot(k, C).to(c.dtype)
                 / torch.clamp(counts, min=1.0).to(c.device))  # 1/n_c
            partials.append(clustered_partials(c, w, C))
        A = clustered_combine(partials, counts)
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
