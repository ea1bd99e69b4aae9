"""Detection de-duplication ("purge") -- exact port of the reference NMS.

Reference: ``purgue_detected_faces_angles_eyes_confidence``
(face_analysis.py:186-221): sort detections by (1 - confidence) * inter-eye
distance (confidence is Disc "non-faceness", so lower is better), then
greedily keep entries whose minimum relative eye error against all kept
entries exceeds 0.25. Runs on host (a handful of detections), numpy only.
"""

from __future__ import annotations

import numpy as np


def relative_eye_error_np(eyes_a: np.ndarray, eyes_b: np.ndarray) -> float:
    """face_analysis.py:158-165 on two (4,) [elx, ely, erx, ery] rows."""
    dist_left = np.sqrt(((eyes_b[0:2] - eyes_a[0:2]) ** 2).sum())
    dist_right = np.sqrt(((eyes_b[2:4] - eyes_a[2:4]) ** 2).sum())
    dist_eyes = np.sqrt(((eyes_b[0:2] - eyes_b[2:4]) ** 2).sum())
    return max(dist_left, dist_right) / max(dist_eyes, 1e-12)


def purge_detections(rows: np.ndarray, threshold: float = 0.25,
                     weight_confidences_by_area: bool = True) -> np.ndarray:
    """rows: (N, >=10) [x0, y0, x1, y1, angle, elx, ely, erx, ery, conf,
    *extra]. Extra trailing columns (e.g. refined eye centers when
    config.eye_iters > 1) ride along untouched -- scoring and clustering
    use only the first 10.

    Returns the kept rows, best first.
    """
    rows = np.asarray(rows, np.float64)
    if len(rows) <= 1:
        return rows.copy()
    conf = rows[:, 9]
    if weight_confidences_by_area:
        areas = np.sqrt((rows[:, 7] - rows[:, 5]) ** 2 +
                        (rows[:, 8] - rows[:, 6]) ** 2)
        weighted = (1.0 - conf) * areas
        weighted = weighted / max(weighted.max(), 1e-12)
    else:
        weighted = conf.copy()
    order = np.argsort(weighted)[::-1]
    rows = rows[order]

    kept = [rows[0]]
    for row in rows:
        min_d = min(relative_eye_error_np(row[5:9], k[5:9]) for k in kept)
        if min_d > threshold:
            kept.append(row)
    return np.asarray(kept)
