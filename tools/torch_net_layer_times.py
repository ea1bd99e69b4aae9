#!/usr/bin/env python3
"""Times the PyTorch/CUDA port's HiGSFA layer kernel against its bound.

    python3 tools/torch_net_layer_times.py [--rows 512,8192]

Builds ``pyfaceanalysis_torch/ops/csrc/net_layer.cu``, loads the shipped
``net_disc`` (bf16 operands, as the cascade runs it) and ``net_age`` (f32,
as the heads run it) and, at each row count of uniform noise: requires
every layer's operand and the output to equal the plain path's bit for bit
(``chip_smoke.net_layer_chain``), prints the device time per call of the
kernel at layers 0 and 1 beside its plain version and its bytes bound
(``chip_smoke.time_net_layer``), and the whole network's device time
through the kernel and through the plain path. The kernel's block size
and shared-memory target are the constants ``kThreads`` and
``kSmemTarget`` of ``net_layer.cu``. Ends with one JSON line. Needs one NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", default="512,2048,8192,19440")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_net_layer_times: needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import device_ms, net_layer_chain, time_net_layer
    from pyfaceanalysis_torch.io.artifacts import load_network
    from pyfaceanalysis_torch.models.network import (
        apply_network,
        layer_operand_ref,
    )
    from pyfaceanalysis_torch.ops import cuda_net_layer as nl

    dev = torch.device("cuda")
    nl.KERNEL.lib()
    for line in nl.KERNEL.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")
    print(f"device {torch.cuda.get_device_name(0)}")
    g = torch.Generator(device="cpu").manual_seed(0)
    out = []
    for name, cd in (("net_disc", torch.bfloat16), ("net_age", None)):
        net = load_network(os.path.join(ROOT, "SavedNetworksTPU",
                                        f"{name}.npz")).to(dev)
        for B in (int(r) for r in args.rows.split(",")):
            x = torch.rand(B, net.input_hw[0] * net.input_hw[1],
                           generator=g).to(dev)
            net_layer_chain(torch, net, x, cd, f"{name} B={B}")
            rows = time_net_layer(torch, name, net, x, cd, args.iters)

            def plain_net():
                y, clip = x, None
                for spec, node, index in zip(net.specs, net.params,
                                             net.indices):
                    y = torch.einsum("bfd,fdo->bfo", layer_operand_ref(
                        spec, node, index, y, clip, cd),
                        node.W.to(cd).float() if cd else node.W)
                    clip = spec.clip
                return torch.clamp(y, -clip, clip).reshape(B, -1)

            fw, fn = device_ms(torch, lambda: apply_network(
                net, x, compute_dtype=cd), max(args.iters // 5, 3))
            pw, pn = device_ms(torch, plain_net, max(args.iters // 10, 3))
            print(f"{name} forward B={B}: kernel path {fw:.6f} ms in {fn} "
                  f"launches, plain path {pw:.6f} ms in {pn}")
            out.append({"net": name, "rows": B, "layers": rows,
                        "forward_ms": fw, "forward_launches": fn,
                        "plain_forward_ms": pw, "plain_forward_launches": pn})
    print(json.dumps({"net_layer": out}))


if __name__ == "__main__":
    main()
