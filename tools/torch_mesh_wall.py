#!/usr/bin/env python3
"""Wall times of the data mesh on one card against the unsharded calls.

    python3 tools/torch_mesh_wall.py [--rounds N] [--shards S] [--root DIR]

On cuda:0, with the shipped ``SavedNetworksTPU`` models at the default
config, times warm synchronised calls of ``detect`` on one synthetic
1000x800 scene and of a fused ``detect_batch`` of 16 such scenes, each
unsharded, on a one-card mesh and on S shards of the one card (a mesh
that names cuda:0 S times, set on the detector as chip_smoke does); and
``train_network`` (``build_higsfa(64, top_dim=20)``, serial graph, 50
groups) on chip_smoke's one-latent set of 2,000 patches, likewise. The
calls go round by round, one of each path per round, so a slow stretch
of the shared host falls on every path alike. Prints the median and the
minimum of each path in ms, a JSON line of them, and the card's name and
power limit.

``--root DIR`` imports the port from another checkout (say an earlier
tree unpacked with ``git archive``), so that two versions can be timed one
after the other in one call on the same card; the scenes, the latent set
and the model files come from this repository either way.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--root", default=None)
    args = ap.parse_args()

    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    from chip_smoke import latent_set, synthetic_scene
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    import pyfaceanalysis_torch
    from pyfaceanalysis_torch.config import DetectorConfig
    from pyfaceanalysis_torch.engine.detector import (
        DetectionModel,
        FaceDetector,
    )
    from pyfaceanalysis_torch.models import builder
    from pyfaceanalysis_torch.parallel.mesh import Mesh, make_mesh
    from pyfaceanalysis_torch.training import trainer

    print(f"port from {os.path.dirname(pyfaceanalysis_torch.__file__)}")
    dev = torch.device("cuda", 0)
    model = DetectionModel.load(os.path.join(ROOT, "SavedNetworksTPU"),
                                device=dev)
    scenes = [synthetic_scene(i) for i in range(16)]
    S = args.shards
    meshes = {"unsharded": None, "one-card mesh": make_mesh(1, device=dev),
              f"{S} shards": Mesh(np.array([dev] * S, dtype=object),
                                  ("data",))}
    lx, labels = latent_set(2000, 21)
    x = torch.from_numpy(lx).to(dev)
    paths = {}
    for name, mesh in meshes.items():
        det = FaceDetector(model, DetectorConfig(), device=dev)
        det._mesh = mesh        # a mesh of one card repeated, as chip_smoke
        paths[f"detect, {name}"] = (lambda d=det: d.detect(scenes[0]))
        paths[f"detect_batch 16, {name}"] = (
            lambda d=det: d.detect_batch(scenes))
        paths[f"train_network, {name}"] = (
            lambda m=mesh: trainer.train_network(
                builder.build_higsfa(64, top_dim=20), x, graph="serial",
                labels=labels, num_groups=50, verbose=False, mesh=m))
    for fn in paths.values():       # warm: kernels built, caches filled
        fn()
        fn()
    times = {k: [] for k in paths}
    for _ in range(args.rounds):
        for name, fn in paths.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    summary = {}
    for name, ts in times.items():
        summary[name] = {"median_ms": statistics.median(ts),
                         "min_ms": min(ts)}
        print(f"{name}: median {statistics.median(ts):.3f} ms, min "
              f"{min(ts):.3f} ms over {args.rounds} rounds")
    print(json.dumps({"mesh_wall": summary, "rounds": args.rounds}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
