#!/usr/bin/env python3
"""A default-size training run of the PyTorch port on one NVIDIA GPU, timed.

    python3 tools/torch_train_full.py --out_dir DIR [apps.train switches]

Runs ``python -m pyfaceanalysis_torch.apps.train --out_dir DIR
--no_calibrate`` at the default sizes (plus any further switches given),
then the disc-ladder and eye-gate calibration of the written directory
alone, and prints each wall time (host clock around synchronised work),
the per-network split from the trainer's log, peak device memory, and the
card's name and power limit; the last line is one JSON object. Without a
card it exits with an error.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out_dir", required=True)
    args, extra = ap.parse_known_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_train_full: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pyfaceanalysis_torch.apps import train as train_app
    from pyfaceanalysis_torch.training import calibration

    argv = ["--out_dir", args.out_dir, "--no_calibrate", *extra]
    text = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        rc = train_app.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak_train = torch.cuda.max_memory_allocated()
    log = text.getvalue()
    for line in log.splitlines():
        if line.startswith("[train]"):
            print(f"train| {line}")
    if rc != 0:
        print(f"torch_train_full: apps.train returned {rc}", file=sys.stderr)
        return 1
    split = {m.group(1): dict(zip(("render", "fit", "features", "gaussian"),
                                  map(float, m.groups()[1:])))
             for m in re.finditer(
                 r"\[train\] (\S+): done \(render ([\d.]+) s, fit ([\d.]+) "
                 r"s, features ([\d.]+) s, gaussian ([\d.]+) s\)", log)}

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        result = calibration.calibrate_model(args.out_dir, verbose=False)
        calibration.write_calibration(args.out_dir, result, verbose=False)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    peak_calib = torch.cuda.max_memory_allocated()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"default-size training {train_s:.3f} s (peak device memory "
          f"{peak_train / 1e6:.0f} MB), calibration of "
          f"{result['faces']} faces {calib_s:.3f} s (peak "
          f"{peak_calib / 1e6:.0f} MB): {smi}")
    print(json.dumps({"train_s": train_s, "per_network_s": split,
                      "peak_bytes_train": peak_train,
                      "calibration_s": calib_s,
                      "peak_bytes_calibration": peak_calib,
                      "calibration": {k: result[k] for k in (
                          "cut_offs_face", "tolerance_xy_eye", "faces",
                          "converged", "bg_per_image")},
                      "device": torch.cuda.get_device_name(0), "smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
