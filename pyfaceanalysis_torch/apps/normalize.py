"""pfa-normalize: batch dataset normalization (training-corpus preparation);
run as ``python -m pyfaceanalysis_torch.apps.normalize``.

Port of ``pyfaceanalysis_tpu.apps.normalize``, itself a port of the
``face_normalization_tools.py`` __main__ tool (:332-475): read a
coordinate file (alternating filename / 6-float eye+mouth lines), normalize
each face and write JPEGs named by an output pattern. Supported modes mirror
the reference's:

    mid_eyes_mouth_horiz                 (eyes_mouth_area, eye-line rotation)
    mid_eyes_inferred-mouth_horiz        (inferred mouth)
    mid_eyes_inferred-mouthZ_horiz       (Z frame, 2x zoom-out)
    mid_eyes_inferred-mouthZ4_horiz      (age-estimation frame, 256x260)
    mid_eyes_inferred-mouthZ4_horiz-Test (17x20 debug frame)
    background                 (noFace centering: 10 negative crops/face)
    leftEye / rightEye         (per-eye Z crops; rightEye mirrored)

Faces with inter-eye distance < 5 px are skipped like the reference (:461).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from pyfaceanalysis_torch.config import resolve_device

# mode -> (method, centering, rotation, out_size override, tries per face)
# (face_normalization_tools.py:368-438; Z4 = the age-estimation frame,
# Z4-Test = its 17x20 debug frame, background writes 10 crops per face)
_MODES = {
    "mid_eyes_mouth_horiz": ("eyes_mouth_area", "mid_eyes_mouth",
                             "EyeLineRotation", None, 1),
    "mid_eyes_inferred-mouth_horiz": ("eyes_inferred-mouth_area",
                                      "mid_eyes_inferred-mouth",
                                      "EyeLineRotation", None, 1),
    "mid_eyes_inferred-mouthZ_horiz": ("eyes_inferred-mouth_areaZ",
                                       "mid_eyes_inferred-mouth",
                                       "EyeLineRotation", None, 1),
    "mid_eyes_inferred-mouthZ4_horiz": ("eyes_inferred-mouth_areaZ",
                                        "mid_eyes_inferred-mouth",
                                        "EyeLineRotation", (256, 260), 1),
    "mid_eyes_inferred-mouthZ4_horiz-Test": (
        "eyes_inferred-mouth_areaZ-Test", "mid_eyes_inferred-mouth",
        "EyeLineRotation", (17, 20), 1),
    "background": ("eyes_mouth_area", "noFace", "noRotation", None, 10),
    "leftEye": ("eyes_inferred-mouth_areaZ", "eyeL", "EyeLineRotation",
                None, 1),
    "rightEye": ("eyes_inferred-mouth_areaZ", "eyeR", "EyeLineRotation",
                 None, 1),
}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="pfa-normalize",
        description="Normalize a face dataset from a coordinate file.")
    p.add_argument("coordinate_file",
                   help="alternating filename / 6-float coordinate lines")
    p.add_argument("output_pattern", help="e.g. out/image%%05d.jpg")
    p.add_argument("mode", choices=sorted(_MODES))
    p.add_argument("--out_width", type=int, default=256)
    p.add_argument("--out_height", type=int, default=192)
    p.add_argument("--base_dir", default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--background", choices=("zero", "random"),
                   default="zero",
                   help="fill for out-of-frame pixels: zero (PIL EXTENT "
                   "black) or random noise (the reference's "
                   "im_transform_randombackground, "
                   "face_normalization_tools.py:53,316)")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="device the frames are sampled on (default cuda; "
                   "raises without a card)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    from pyfaceanalysis_torch import normalization
    from pyfaceanalysis_torch.io import images as im_io
    from pyfaceanalysis_torch.io.writers import load_true_coordinates

    method, centering, rotation, size_override, num_tries = _MODES[args.mode]
    filenames, coords = load_true_coordinates(args.base_dir,
                                              args.coordinate_file)
    rng = np.random.RandomState(args.seed)
    out_dir = os.path.dirname(args.output_pattern)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    written = 0
    for i, (fn, row) in enumerate(zip(filenames, coords)):
        elx, ely, erx, ery = row[0:4]
        mx, my = row[6], row[7]
        dist_eyes = float(np.hypot(erx - elx, ery - ely))
        if dist_eyes < 5.0:     # reference skip rule (:461)
            print(f"skipping {fn}: inter-eye distance {dist_eyes:.1f} < 5")
            continue
        image, _ = im_io.load_image(fn, prescale_size=None)
        image = torch.as_tensor(image, device=device)
        out_size = size_override or (args.out_width, args.out_height)
        for _try in range(num_tries):
            out = normalization.normalize_image(
                image, (elx, ely, erx, ery, mx, my),
                normalization_method=method, centering_mode=centering,
                rotation_mode=rotation, out_size=out_size, rng=rng,
                background=args.background)
            im_io.save_image(args.output_pattern % written, out, quality=90)
            written += 1
    print(f"wrote {written} normalized images")
    return 0


if __name__ == "__main__":
    sys.exit(main())
