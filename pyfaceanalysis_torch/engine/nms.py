"""Detection de-duplication ("purge") -- exact port of the reference NMS.

Reference: ``purgue_detected_faces_angles_eyes_confidence``
(face_analysis.py:186-221): sort detections by (1 - confidence) * inter-eye
distance (confidence is Disc "non-faceness", so lower is better), then
greedily keep entries whose minimum relative eye error against all kept
entries exceeds 0.25. Runs on host, numpy only, over up to
``max_detections`` rows (~3-5 an image in the shipped scenes, ~20-30 in
group photos): the relative eye error of every pair is one float64 matrix,
computed once with the per-pair operations in their order, and the greedy
pass reads it, visiting only the rows that an earlier row could drop.
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

    err = relative_eye_error_matrix(rows[:, 5:9])
    # The per-pair loop keeps row i iff Python's min of its errors against
    # the rows kept so far, row 0 first, exceeds the threshold. That min
    # keeps its first value unless a later one is smaller, so a NaN against
    # row 0 drops row i and a NaN against a later kept row never does.
    # sup[i, k]: earlier row k, if kept, drops row i.
    sup = err <= threshold
    sup[:, 0] = ~(err[:, 0] > threshold)
    sup = np.tril(sup, -1)
    # Rows that no earlier row can drop are kept outright; the greedy pass
    # visits only the others, in order.
    keep = np.ones(len(rows), bool)
    for i in np.flatnonzero(sup.any(axis=1)):
        keep[i] = not (sup[i] & keep).any()
    kept = np.flatnonzero(keep)
    if err[0, 0] > threshold:   # the loop also tests row 0 against itself
        kept = np.insert(kept, 1, 0)
    return rows[kept]


def relative_eye_error_matrix(eyes: np.ndarray) -> np.ndarray:
    """(N, 4) float64 [elx, ely, erx, ery] rows -> (N, N) matrix whose
    [i, k] is ``relative_eye_error_np(eyes[i], eyes[k])`` bit for bit: the
    same differences, squares, two-term sums, ``sqrt``, ``max`` and divide,
    in the same order (``max`` as Python's: the first unless the second is
    larger)."""
    ex = np.ascontiguousarray(eyes.T)              # (4, N)
    d2 = (ex[:, None, :] - ex[:, :, None]) ** 2    # [c, i, k]: row k - row i
    dist_left = np.sqrt(d2[0] + d2[1])
    dist_right = np.sqrt(d2[2] + d2[3])
    e2 = (ex[0:2] - ex[2:4]) ** 2
    dist_eyes = np.sqrt(e2[0] + e2[1])
    num = np.where(dist_right > dist_left, dist_right, dist_left)
    den = np.where(1e-12 > dist_eyes, 1e-12, dist_eyes)
    return num / den[None, :]
