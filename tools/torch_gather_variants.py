#!/usr/bin/env python3
"""Times block-shape variants of the PyTorch/CUDA port's gather kernel.

    python3 tools/torch_gather_variants.py [--seed N] [--rounds K]

Builds ``pyfaceanalysis_torch/ops/csrc/gather.cu`` once per variant of its
two compile-time knobs (``PFA_GATHER_THREADS``: threads per block;
``PFA_GATHER_MIN_BLOCKS``: a patch's rows are cut into as few bands as
still give this many blocks, so a smaller value means fewer, longer blocks),
all ``nvcc`` runs started together, requires each variant to equal the
plain version exactly on the timed inputs, and prints each variant's device
time per launch (``torch.profiler``, 100 launches, the rounds taken in
turns so that clock drift hits all variants alike) beside the block count.
The inputs are refinement-sized: a random 8x808x1024 pyramid and 512, 256
and 128 rotated boxes at 64x64 nearest, as the detect path calls the
kernel. Needs one NVIDIA GPU and nvcc; the shipped variant is the source's
default (256 threads, 512 blocks).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VARIANTS = [(256, 512), (256, 256), (256, 1024), (256, 2048), (256, 1 << 20),
            (128, 512), (128, 1024), (512, 512)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_gather_variants: needs an NVIDIA GPU with CUDA")
    from chip_smoke import device_ms
    from pyfaceanalysis_torch.ops import cuda_gather
    from pyfaceanalysis_torch.ops.cuda_build import (
        NVCC_FLAGS,
        CudaLibrary,
        build_all,
        check_launch,
    )
    from pyfaceanalysis_torch.ops.patches import sample_patches_pyramid_ref

    dev = torch.device("cuda")
    libs = {v: CudaLibrary(
        "gather.cu", cuda_gather.KERNEL.functions,
        NVCC_FLAGS + (f"-DPFA_GATHER_THREADS={v[0]}",
                      f"-DPFA_GATHER_MIN_BLOCKS={v[1]}")) for v in VARIANTS}
    build_all(list(libs.values()))

    g = torch.Generator().manual_seed(args.seed)
    L, lh, lw, hw = 8, 808, 1024, (64, 64)
    pyramid = torch.rand((L, lh, lw), generator=g).to(dev)
    scales = torch.tensor([1.3 ** (k + 1) for k in range(L - 1)] + [1.0],
                          device=dev)

    def batch(B):
        levels = torch.randint(0, L, (B,), generator=g,
                               dtype=torch.int32).to(dev)
        side = 64.0 * scales[levels.long()] * (
            0.8 + 0.45 * torch.rand(B, generator=g).to(dev))
        cx = 1000.0 * torch.rand(B, generator=g).to(dev)
        cy = 800.0 * torch.rand(B, generator=g).to(dev)
        boxes = torch.stack([cx - side / 2, cy - side / 2,
                             cx + side / 2 - 1, cy + side / 2 - 1], 1)
        angles = (48.0 * torch.rand(B, generator=g) - 24.0).to(dev)
        return levels, boxes, angles

    def launcher(lib, levels, boxes, angles, out):
        ptrs, strides, is64 = cuda_gather.patch_inputs(scales, levels,
                                                       boxes, angles)
        fn = lib.lib().pfa_gather_launch
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            check_launch(fn(pyramid.data_ptr(), *ptrs, out.data_ptr(),
                            *strides, is64, boxes.shape[0], L, lh, lw,
                            hw[0], hw[1], 0, stream), "gather variant")
        return launch

    results = []
    for B in (512, 256, 128):
        levels, boxes, angles = batch(B)
        want = sample_patches_pyramid_ref(pyramid, scales, levels, boxes,
                                          angles, hw)
        out = torch.empty_like(want)
        launches = {v: launcher(lib, levels, boxes, angles, out)
                    for v, lib in libs.items()}
        for v, launch in launches.items():
            out.zero_()
            launch()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                sys.exit(f"variant {v} differs from the plain version")
        times = {v: [] for v in VARIANTS}
        for _ in range(args.rounds):
            for v, launch in launches.items():
                times[v].append(device_ms(torch, launch, 100)[0])
        for threads, min_blocks in VARIANTS:
            # The launch's own block shape (csrc/gather.cu).
            tx = min(hw[1] // 4, threads)
            ty = max(1, min(threads // tx, hw[0]))
            max_bands = -(-hw[0] // ty)
            bands = max(1, min(max_bands, -(-min_blocks // B)))
            rows = ty * -(-max_bands // bands)
            t = times[(threads, min_blocks)]
            results.append({"B": B, "threads": threads,
                            "min_blocks": min_blocks,
                            "blocks": B * -(-hw[0] // rows),
                            "ms": statistics.median(t), "ms_rounds": t})
            print(json.dumps(results[-1]))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
