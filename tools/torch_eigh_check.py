#!/usr/bin/env python3
"""Accuracy of the training eigensolves on one NVIDIA GPU against the CPU.

    python3 tools/torch_eigh_check.py

Trains build_higsfa(64, top_dim=20) on the CPU on chip_smoke's one-latent
set (``latent_set``) and, layer by layer on the CPU-trained inputs, takes
the layer's moments (A, B) once and solves them on the card and on the
CPU: ``torch.linalg.eigh`` of the regularised B (largest eigenvalue error
against a float64 solve, relative to the largest eigenvalue, and the
largest eigenpair residual |B v - l v| / |B|), and the GSFA solve in
float32 arithmetic (``solve_f32``: the JAX package's float32 algorithm,
rank-control penalty included) and through
``models.moments.solve_gsfa_device`` (the trainer's, float64 inside):
slowness w'Aw of each output column against a float64 solve, and the share
of output columns equal up to sign within 1e-2 between card and CPU.
Prints the card's name and power limit; the last line is one JSON object.
Without a card it exits with an error.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def solve_f32(torch, A, B, out_dim, reg=1e-4):
    """The GSFA solve in float32 arithmetic, operation for operation the
    JAX package's ``solve_gsfa_device``."""
    A, B = A.float(), B.float()
    D = B.shape[-1]
    eye = torch.eye(D, dtype=B.dtype, device=B.device)
    trB = torch.diagonal(B, dim1=-2, dim2=-1).sum(-1)[:, None, None] / D
    Breg = B + (reg * trB + 1e-12) * eye
    evals, evecs = torch.linalg.eigh((Breg + Breg.transpose(-1, -2)) / 2)
    bad = evals <= 1e-3 * evals.max(dim=-1, keepdim=True).values
    inv_sqrt = torch.where(bad, torch.zeros_like(evals),
                           1.0 / torch.sqrt(torch.clamp(evals, min=1e-12)))
    wh = evecs * inv_sqrt[:, None, :]
    M = wh.transpose(-1, -2) @ A @ wh
    M = (M + M.transpose(-1, -2)) * 0.5
    M = M + torch.diag_embed(torch.where(bad, torch.full_like(evals, 1e6),
                                         torch.zeros_like(evals)))
    _, V = torch.linalg.eigh((M + M.transpose(-1, -2)) / 2)
    return wh @ V[..., :out_dim]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_eigh_check: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import latent_set
    from pyfaceanalysis_torch.models import builder, moments
    from pyfaceanalysis_torch.models.network import apply_layer
    from pyfaceanalysis_torch.training import trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    x, u = latent_set(2000, 21)
    x = torch.from_numpy(x)
    net = trainer.train_network(builder.build_higsfa(64, top_dim=20), x,
                                graph="serial", labels=u, num_groups=50,
                                verbose=False)
    rows = []
    cur = x
    for li, (spec, node, index) in enumerate(zip(net.specs, net.params,
                                                 net.indices)):
        inp = spec.expansion(cur[:, index])
        _, B, A = moments.gsfa_moments(inp, "serial", labels=u,
                                       num_groups=50)
        D = B.shape[-1]
        trB = torch.diagonal(B, dim1=-2, dim2=-1).sum(-1)[:, None, None] / D
        Breg = B + (1e-4 * trB + 1e-12) * torch.eye(D)
        Breg = (Breg + Breg.transpose(-1, -2)) / 2
        ref_l = torch.linalg.eigvalsh(Breg.double())
        top = ref_l[:, -1:].abs()
        row = {"layer": li, "fields": int(B.shape[0]), "dim": int(D)}
        for side, dev in (("cpu", "cpu"), ("card", "cuda")):
            lam, vec = torch.linalg.eigh(Breg.to(dev))
            lam, vec = lam.cpu().double(), vec.cpu().double()
            row[f"eig_err_{side}"] = float(((lam - ref_l).abs() / top).max())
            res = Breg.double() @ vec - vec * lam[:, None, :]
            row[f"residual_{side}"] = float(
                (res.norm(dim=-2) / Breg.double().norm(dim=(-2, -1))[:, None]
                 ).max())
        # slowness of the solutions against the float64 solve
        ref_W = moments.solve_gsfa_device(A.double(), B.double(),
                                          spec.out_dim)
        ref_s = torch.einsum("fdo,fde,feo->fo", ref_W, A.double(), ref_W)
        outs = {}
        for side, dev in (("cpu", "cpu"), ("card", "cuda")):
            for prec in ("f32", "trainer"):
                solve = (moments.solve_gsfa_device if prec == "trainer"
                         else lambda a, b, o: solve_f32(torch, a, b, o))
                W = solve(A.to(dev), B.to(dev), spec.out_dim).cpu().double()
                s = torch.einsum("fdo,fde,feo->fo", W, A.double(), W)
                row[f"slowness_err_{side}_{prec}"] = float(
                    ((s - ref_s).abs() / ref_s.abs().clamp(min=1e-6)).max())
                outs[(side, prec)] = W
        xc = (inp - inp.mean(0)).double()
        for prec in ("f32", "trainer"):
            a = torch.einsum("nfd,fdo->nfo", xc, outs[("card", prec)])
            b = torch.einsum("nfd,fdo->nfo", xc, outs[("cpu", prec)])
            d = torch.minimum((a - b).abs().amax(0), (a + b).abs().amax(0))
            row[f"share_up_to_sign_{prec}"] = float(
                (d <= 1e-2).double().mean())
        rows.append(row)
        print(json.dumps(row))
        cur = apply_layer(spec, node, index, cur)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({"layers": rows, "torch": torch.__version__,
                      "cuda": torch.version.cuda, "smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
