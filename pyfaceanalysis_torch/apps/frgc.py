"""pfa-frgc: FRGC 2.0 metadata tooling; run as
``python -m pyfaceanalysis_torch.apps.frgc``.

Port of ``pyfaceanalysis_tpu.apps.frgc``, itself a port of
``xml_frgc_tools.py``: parse the FRGC metadata XML (per-recording
eye/nose/mouth annotations, :18-116), parse biometric-signature XML sets
(recording id -> image filename, :119-157), merge them (:160-173), and batch
face-centered crops (process_image_facecenter, :176-244).

Uses xml.etree (stdlib) instead of lxml; the element/attribute names follow
the FRGC 2.0 schema as consumed by the reference.
"""

from __future__ import annotations

import argparse
import os
import sys
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

Coords = Dict[str, Dict[str, Tuple[float, float]]]


def _local(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def load_frgc_coordinate_data(path: str) -> Coords:
    """Recording id -> {"LeftEyeCenter": (x, y), "RightEyeCenter": ...,
    "Nose": ..., "Mouth": ...} from the FRGC metadata XML."""
    out: Coords = {}
    for _, elem in ET.iterparse(path):
        if _local(elem.tag) != "Recording":
            continue
        rid = elem.get("recording_id") or elem.get("name")
        points = {}
        for child in elem:
            name = _local(child.tag)
            if name in ("LeftEyeCenter", "RightEyeCenter", "Nose", "Mouth"):
                x, y = child.get("x"), child.get("y")
                if x is not None and y is not None:
                    points[name] = (float(x), float(y))
        if rid and points:
            out[rid] = points
        elem.clear()
    return out


def load_frgc_biometric_signatures(paths: List[str]) -> Dict[str, str]:
    """Recording id -> image filename from biometric-signature XML sets."""
    out: Dict[str, str] = {}
    for path in paths:
        for _, elem in ET.iterparse(path):
            name = _local(elem.tag)
            if name.lower().endswith("presentation"):
                rid = elem.get("name") or elem.get("biometric-signature")
                fn = elem.get("file-name") or elem.get("filename")
                if rid and fn:
                    out[rid] = fn
                elem.clear()
    return out


def merge_dictionaries(coords: Coords, files: Dict[str, str]
                       ) -> List[Tuple[str, Dict[str, Tuple[float, float]]]]:
    """Join annotations with filenames on recording id
    (xml_frgc_tools.py:160-173)."""
    merged = []
    for rid, pts in coords.items():
        if rid in files:
            merged.append((files[rid], pts))
    return merged


def process_image_facecenter(image: np.ndarray,
                             points: Dict[str, Tuple[float, float]],
                             out_size: Tuple[int, int] = (256, 192),
                             device=None) -> Optional[np.ndarray]:
    """Face-centered normalized crop from FRGC annotations
    (xml_frgc_tools.py:176-244), sampled on ``device`` (default ``cuda``)."""
    from pyfaceanalysis_torch import normalization

    if "LeftEyeCenter" not in points or "RightEyeCenter" not in points:
        return None
    elx, ely = points["LeftEyeCenter"]
    erx, ery = points["RightEyeCenter"]
    if "Mouth" in points:
        mx, my = points["Mouth"]
        method, centering = "eyes_mouth_area", "mid_eyes_mouth"
    else:
        mx = my = 0.0
        method = "eyes_inferred-mouth_area"
        centering = "mid_eyes_inferred-mouth"
    return normalization.normalize_image(
        image, (elx, ely, erx, ery, mx, my), normalization_method=method,
        centering_mode=centering, rotation_mode="EyeLineRotation",
        out_size=out_size, device=device)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="pfa-frgc",
        description="FRGC 2.0 XML -> normalized face crops")
    p.add_argument("metadata_xml")
    p.add_argument("signature_xmls", nargs="+")
    p.add_argument("--image_dir", default="")
    p.add_argument("--out_pattern", default="frgc_out/face%05d.jpg")
    p.add_argument("--out_width", type=int, default=256)
    p.add_argument("--out_height", type=int, default=192)
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="device the frames are sampled on (default cuda; "
                   "raises without a card)")
    args = p.parse_args(argv)

    from pyfaceanalysis_torch.config import resolve_device
    from pyfaceanalysis_torch.io import images as im_io

    device = resolve_device(args.device)

    coords = load_frgc_coordinate_data(args.metadata_xml)
    files = load_frgc_biometric_signatures(args.signature_xmls)
    merged = merge_dictionaries(coords, files)
    print(f"{len(coords)} annotated recordings, {len(files)} signatures, "
          f"{len(merged)} matched")
    out_dir = os.path.dirname(args.out_pattern)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    written = 0
    for fn, pts in merged:
        path = os.path.join(args.image_dir, fn)
        if not os.path.exists(path):
            continue
        image, _ = im_io.load_image(path, prescale_size=None)
        out = process_image_facecenter(
            image, pts, (args.out_width, args.out_height), device=device)
        if out is None:
            continue
        im_io.save_image(args.out_pattern % written, out, quality=90)
        written += 1
    print(f"wrote {written} normalized crops")
    return 0


if __name__ == "__main__":
    sys.exit(main())
