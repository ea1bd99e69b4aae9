"""Sharded GSFA training step (data parallel over samples x model parallel
over receptive fields).

Port of ``pyfaceanalysis_tpu.parallel.train_step``. One "training step" of
this model family accumulates graph moments over a batch and re-solves the
per-field generalized eigenproblems:

    B_f = cov over samples of x[:, f, :]          (data-parallel reduction)
    A_f = cov over samples of dx[:, f, :]         (temporal-difference graph)
    W_f = smallest generalized eigenvectors of (A_f, B_f)

On a 2-D mesh the samples are split over "data" and the fields over
"model": the device at (i, j) holds rows block i of field block j. Each
field block's sums are added on its column's first device (i = 0), where
its eigensolves run; the per-field blocks are independent. The temporal
difference across a row-block boundary takes the next block's first row.

The solve's precision is ``SOLVE_DTYPE`` (the JAX function solves in
float32); ``tools/torch_eigh_check.py --gsfa_step`` measures float32
against float64 on the card.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from pyfaceanalysis_torch.models import moments
from pyfaceanalysis_torch.parallel.mesh import Mesh

# The eigensolves' precision (see the module's text).
SOLVE_DTYPE = torch.float64


def gsfa_solve(B: torch.Tensor, A: torch.Tensor, out_dim: int,
               dtype: torch.dtype = SOLVE_DTYPE) -> torch.Tensor:
    """(F, D, D) moments -> (F, D, out_dim) slow directions, solved in
    ``dtype`` on their device, returned in float32: B regularised by
    1e-5 of its mean variance, whitened, A's smallest eigenvectors."""
    B, A = B.to(dtype), A.to(dtype)
    D = B.shape[-1]
    eye = torch.eye(D, dtype=dtype, device=B.device)
    trB = torch.diagonal(B, dim1=-2, dim2=-1).sum(-1)[:, None, None] / D
    Breg = B + 1e-5 * trB * eye
    evals, evecs = torch.linalg.eigh((Breg + Breg.transpose(-1, -2)) / 2)
    wh = evecs / torch.sqrt(torch.clamp(evals, min=1e-10))[:, None, :]
    M = wh.transpose(-1, -2) @ A @ wh
    M = (M + M.transpose(-1, -2)) * 0.5
    _, V = torch.linalg.eigh(M)
    return (wh @ V[..., :out_dim]).to(torch.float32)


def gsfa_step(x: torch.Tensor, out_dim: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, F, D) samples -> (mean (F, D), W (F, D, out_dim)) on ``x``'s
    device. Temporal graph: consecutive samples are neighbours."""
    mean, B, A = moments.gsfa_moments(x.to(torch.float32), "temporal")
    return mean, gsfa_solve(B, A, out_dim)


def sharded_gsfa_step(mesh: Mesh, x, out_dim: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`gsfa_step` with N over the mesh's "data" axis and F over its
    "model" axis. Returns mean and W gathered on the mesh's first
    device."""
    x = torch.as_tensor(x, dtype=torch.float32)
    grid = mesh.devices.reshape(mesh.shape["data"], mesh.shape["model"])
    x_rows = torch.tensor_split(x, grid.shape[0], dim=0)
    means: List[torch.Tensor] = []
    Ws: List[torch.Tensor] = []
    for j in range(grid.shape[1]):
        # Field block j: its row blocks down column j of the mesh; the
        # moments come back on the column's first device.
        blocks = [torch.tensor_split(xr, grid.shape[1], dim=1)[j].to(d)
                  for xr, d in zip(x_rows, grid[:, j])]
        mean, B, A = moments.gsfa_moments(blocks, "temporal")
        means.append(mean)
        Ws.append(gsfa_solve(B, A, out_dim))
    lead = mesh.leader
    return (torch.cat([m.to(lead) for m in means], dim=0),
            torch.cat([w.to(lead) for w in Ws], dim=0))


def sharded_train_network(mesh: Mesh, net, x: torch.Tensor,
                          graph: str = "serial", labels=None,
                          num_groups: int = 50, label_weights=None,
                          verbose: bool = False):
    """The production trainer's ``train_network`` with the sample axis
    sharded over ``mesh``'s "data" axis (``apps.train --data_mesh=N`` and
    the dry run go through the same function)."""
    from pyfaceanalysis_torch.training.trainer import train_network
    return train_network(net, x, graph=graph, labels=labels,
                         num_groups=num_groups, label_weights=label_weights,
                         verbose=verbose, mesh=mesh)
