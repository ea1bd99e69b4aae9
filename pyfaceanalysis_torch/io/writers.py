"""Result writing, batch files and ground-truth coordinate loaders.

Exact ports of the reference's text formats:

- output rows (FaceDetectUpdated.py:1258-1278): append-mode,
  ``x0, y0, x1, y1, angle, elx, ely, erx, ery[, age, race, gender, conf]``
  with coordinates rounded to ints, angle/conf as floats, age as %2.1f;
  ``right_screen_eye_first`` swaps the eye pair.
- batch file (face_analysis.py:224-243): alternating input/output lines.
- "normalization file" ground truth (face_analysis.py:246-310): filename
  line + 6-or-8 float line -> 14-tuple including a derived face box.
"""

from __future__ import annotations

import math
import os
from typing import List, Tuple

import numpy as np


def write_detections(path: str, detections,
                     right_screen_eye_first: bool = False,
                     write_age_race_gender_confidence: bool = True) -> None:
    """Appends detection rows in the reference output format."""
    with open(path, "a") as fd:
        for d in detections:
            ints = [int(round(v)) for v in
                    (*d.box, *d.eye_left, *d.eye_right)]
            x0, y0, x1, y1, elx, ely, erx, ery = ints
            if right_screen_eye_first:
                elx, ely, erx, ery = erx, ery, elx, ely
            fd.write("%d, %d, %d, %d, %f, %d, %d, %d, %d"
                     % (x0, y0, x1, y1, d.angle, elx, ely, erx, ery))
            if write_age_race_gender_confidence and d.age is not None:
                fd.write(", %2.1f, %s, %s, %f"
                         % (d.age, d.race, d.gender, d.confidence))
            fd.write(" \n")


def read_batch_file(path: str) -> Tuple[List[str], List[str]]:
    """Alternating image/output filename lines (face_analysis.py:224-243)."""
    with open(path) as f:
        lines = [ln.rstrip("\n").rstrip("\r") for ln in f]
    image_filenames, output_filenames = [], []
    for i in range(len(lines) // 2):
        image_filenames.append(lines[2 * i].rstrip())
        output_filenames.append(lines[2 * i + 1].rstrip())
    return image_filenames, output_filenames


def load_true_coordinates(base_dir: str, filename: str
                          ) -> Tuple[List[str], np.ndarray]:
    """"Normalization file" ground-truth loader (face_analysis.py:246-310).

    Format: repeated [image filename line; coordinate line with 6 or 8
    floats]. 8 floats = eyeL xy, eyeR xy, NOSE xy, MOUTH xy; 6 floats =
    eyeL xy, eyeR xy, NOSE xy with the mouth approximated "as if the face
    were perfectly vertical": mouth_x = mid-eyes x, mouth_y = mid-eyes y +
    (erx - elx) * 42/37 (exact reference semantics).

    Returns (filenames, (N, 14) array [elx, ely, erx, ery, nx, ny, mx, my,
    fcx, fcy, bx0, by0, bx1, by1]). The face box is the reference's: center
    at mid(mid-eyes, mouth), side 128 * sqrt(triangle_area /
    ((37/0.825)*(42/0.825)/2)).
    """
    filenames: List[str] = []
    coords: List[List[float]] = []
    with open(filename) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    i = 0
    while i + 1 < len(lines):
        fn = lines[i]
        vals = [float(v) for v in lines[i + 1].replace(",", " ").split()]
        i += 2
        if len(vals) >= 8:
            elx, ely, erx, ery, nx, ny, mx, my = vals[:8]
        elif len(vals) == 6:
            elx, ely, erx, ery, nx, ny = vals
            mx = (elx + erx) / 2.0
            my = (ely + ery) / 2.0 + (erx - elx) * 42.0 / 37.0
        else:
            continue
        filenames.append(os.path.join(base_dir, fn) if base_dir else fn)
        coords.append(truth_row_from_landmarks(elx, ely, erx, ery,
                                               nx, ny, mx, my))
    return filenames, np.asarray(coords)


def truth_row_from_landmarks(elx: float, ely: float, erx: float, ery: float,
                             nx: float, ny: float, mx: float, my: float
                             ) -> List[float]:
    """14-element ground-truth row [eyes, nose, mouth, face center, face
    box] with the reference's derived face box: center at mid(mid-eyes,
    mouth), side 128 * sqrt(triangle_area / canonical_area)
    (face_analysis.py:276-300)."""
    eyes_mx, eyes_my = (elx + erx) / 2.0, (ely + ery) / 2.0
    fcx, fcy = (eyes_mx + mx) / 2.0, (eyes_my + my) / 2.0
    dist_eyes = math.hypot(erx - elx, ery - ely)
    height_triangle = math.hypot(eyes_mx - mx, eyes_my - my)
    current_area = dist_eyes * height_triangle / 2.0
    desired_area = (37.0 / 0.825) * (42.0 / 0.825) / 2.0
    side = 128.0 * math.sqrt(current_area / max(desired_area, 1e-12))
    box = [fcx - side / 2, fcy - side / 2, fcx + side / 2, fcy + side / 2]
    return [elx, ely, erx, ery, nx, ny, mx, my, fcx, fcy] + box
