#!/usr/bin/env python3
"""Accuracy of the training eigensolves on one NVIDIA GPU against the CPU.

    python3 tools/torch_eigh_check.py [--gsfa_step]

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

With ``--gsfa_step`` it measures ``parallel.train_step.gsfa_solve`` (the
solve of ``gsfa_step``, 1e-5 trace regulariser, no rank-control penalty)
in float32 against float64, on the card and on the CPU, on the same
moments: at the dry run's shapes (16 x data_axis samples, 4 x model_axis
fields of 6; one card and a 4 x 2 mesh), on tests/test_parallel.py's
(64, 8, 6) input and at one full-width layer (layer 0 of
build_higsfa(64, top_dim=20) on the one-latent set in latent order, so
that consecutive samples are graph neighbours): the largest difference of
W up to sign, and by how much it exceeds the JAX test's tolerance (rtol
1e-2, atol 1e-3; 0 or less is within).

Prints the card's name and power limit; the last line is one JSON object.
Without a card it exits with an error.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np


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


def gsfa_step_check(torch, latent_set) -> list:
    """float32 against float64 ``gsfa_solve`` on the card and the CPU (see
    the module's text); one row per input and side."""
    from pyfaceanalysis_torch.models import builder, moments
    from pyfaceanalysis_torch.parallel.train_step import gsfa_solve

    rng = np.random.RandomState(0)
    cases = {f"dry run {d}x{m}": (rng.randn(16 * d, 4 * m, 6), 3)
             for d, m in ((1, 1), (4, 2))}
    cases["tests (64, 8, 6)"] = (np.random.RandomState(1).randn(64, 8, 6), 3)
    x, u = latent_set(2000, 21)
    x = torch.from_numpy(x[np.argsort(u)])
    net = builder.build_higsfa(64, top_dim=20)
    spec = net.specs[0]
    cases["full width: layer 0 of build_higsfa(64)"] = (
        spec.expansion(x[:, net.indices[0]]), spec.out_dim)
    rows = []
    for name, (data, out_dim) in cases.items():
        data = torch.as_tensor(data, dtype=torch.float32)
        for side, dev in (("cpu", "cpu"), ("card", "cuda")):
            _, B, A = moments.gsfa_moments(data.to(dev), "temporal")
            W32 = gsfa_solve(B, A, out_dim, torch.float32).cpu().double()
            W64 = gsfa_solve(B, A, out_dim, torch.float64).cpu().double()
            W32 = W32 * torch.sign((W32 * W64).sum(dim=-2, keepdim=True))
            diff = (W32 - W64).abs()
            row = {"input": name, "shape": list(data.shape),
                   "out_dim": out_dim, "side": side,
                   "max_abs_diff": float(diff.max()),
                   "excess_over_tol": float(
                       (diff - (1e-3 + 1e-2 * W64.abs())).max()),
                   "max_abs_W": float(W64.abs().max())}
            rows.append(row)
            print(json.dumps(row))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gsfa_step", action="store_true",
                    help="measure gsfa_step's solve in float32 against "
                         "float64")
    args = ap.parse_args(argv)
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
    if args.gsfa_step:
        rows = gsfa_step_check(torch, latent_set)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
        print(smi)
        print(json.dumps({"gsfa_step": rows, "torch": torch.__version__,
                          "cuda": torch.version.cuda, "smi": smi}))
        return 0
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
