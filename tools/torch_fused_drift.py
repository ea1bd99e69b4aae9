#!/usr/bin/env python3
"""Where the fused batch cascade and the single-image cascade part ways.

    python3 tools/torch_fused_drift.py [--seed N] [--batch B] [--device cuda]

Runs ``run_cascade`` of the PyTorch/CUDA port on ``--batch`` synthetic
1000x800 scenes twice: once per image, and once fused over all images, both
with ``collect_trace`` (compaction off, so row r of image i is row
``i * n + r`` of the fused batch at every stage). For each of the 17 stages
it prints, over the real windows of all images, how many are alive on
exactly one side, and the largest difference in confidence, box coordinate
and angle among windows alive on both. Done for ``matmul_dtype`` "bf16"
(the default: operands rounded to bfloat16) and "f32".

Both sides run the same code on the same pixels; what differs is the row
count of every product, for which the GPU's matrix library may choose
another kernel and so another summation order. The table shows the size of
that first difference and how the stages amplify it.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch
    sys.path.insert(0, ROOT)
    from chip_smoke import synthetic_scene
    from pyfaceanalysis_torch.config import DetectorConfig
    from pyfaceanalysis_torch.engine import cascade
    from pyfaceanalysis_torch.engine.detector import (
        DetectionModel,
        FaceDetector,
    )
    from pyfaceanalysis_torch.ops.pyramid import (
        build_pyramid,
        build_pyramid_batch,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    model = DetectionModel.load(os.path.join(ROOT, "SavedNetworksTPU"),
                                device=args.device)
    B = args.batch
    scenes = [synthetic_scene(args.seed + i) for i in range(B)]
    im_h, im_w = scenes[0].shape
    geom = model.spec.face_geom
    hw = (geom.subimage_height, geom.subimage_width)
    for dtype in ("bf16", "f32"):
        det = FaceDetector(model, DetectorConfig(matmul_dtype=dtype),
                           device=args.device)
        cfg = det.config
        state, n, pyr, scales = det._grid_state(im_w, im_h)
        state_b, _, pyr_b, scales_b = det._grid_state(im_w, im_h, batch=B)
        stack = det._to_canvas_batch(scenes)
        _, fused = cascade.run_cascade(
            model.plan, model.det_nets, geom, cfg, hw, stack, model.det_clfs,
            state_b, pyramid=build_pyramid_batch(stack, pyr_b.scales,
                                                 pyr_b.level_hw),
            crops=pyr_b.crops, pyr_scales=scales_b,
            collect_trace=True, n_images=B, n_per_image=n)
        singles = []
        for i in range(B):
            _, trace = cascade.run_cascade(
                model.plan, model.det_nets, geom, cfg, hw, stack[i],
                model.det_clfs, state, pyramid=build_pyramid(
                    stack[i], pyr.scales, pyr.level_hw),
                crops=pyr.crops, pyr_scales=scales,
                collect_trace=True)
            singles.append(trace)
        print(f"matmul_dtype={dtype}: {B} images x {n} windows; per stage: "
              "alive fused / alive single / alive on one side only / max "
              "|d conf| / max |d box| px / max |d angle| deg (both alive)")
        for si, st in enumerate(model.plan):
            def rows(k):
                return torch.cat([singles[i][si][k][:n] for i in range(B)])
            f = [fused[si][k][: B * n] for k in range(4)]
            s_boxes, s_ang, s_mask, s_conf = (rows(k) for k in range(4))
            both = f[2] & s_mask

            def worst(a, b):
                d = (a - b).abs()[both]
                return float(d.max()) if d.numel() else 0.0
            print(f"  stage {si:2d} {st.kind:5s}{st.serial}: "
                  f"{int(f[2].sum()):5d} {int(s_mask.sum()):5d} "
                  f"{int((f[2] != s_mask).sum()):4d}  "
                  f"{worst(f[3], s_conf):.3e}  {worst(f[0], s_boxes):.3e}  "
                  f"{worst(f[1], s_ang):.3e}")
    if args.device == "cuda":
        print(torch.cuda.get_device_name(0), "|", subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
