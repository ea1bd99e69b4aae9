"""The comparison that decides ``correct``: the program's detections of a
sample of requests against the plain reference's detections of the same
images.

The outputs are thresholded (a last-bit difference can add or drop a
detection, or let NMS keep another window of the same face), so
detections are first paired, image by image: a program detection and a
reference detection are the same face when the larger of their two eye
distances is under ``PAIR_TOLERANCE`` of the reference's inter-eye
distance (the detector's own NMS criterion); pairs are taken greedily,
closest first. The numbers:

- ``unpaired_share``: per image, the detections without a partner,
  program's and reference's, over all detections of both (0 where
  neither has any), averaged over the images, so that an image left
  without its answer counts whole however many faces it holds;
- for each quantity of a pair -- ``coord_px``, the largest difference of
  a box corner or eye coordinate in pixels; ``angle_deg``; ``conf``, the
  confidence; ``attr``, the largest difference of age, age std, race or
  gender value, each over its label range (1 is the whole range) -- its
  median (``_p50``), 90th percentile (``_p90``) and largest (``_max``)
  over all pairs of the sample.

A pair-wise number with no pairs reads 0; ``unpaired_share`` then carries
the difference. Which numbers a cell compares, and their limits, are in
its ``limits/<cell>.json``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

PAIR_TOLERANCE = 0.25
QUANTITIES = ("coord_px", "angle_deg", "conf", "attr")
STATS = (("p50", 50), ("p90", 90), ("max", 100))
NUMBERS = ("unpaired_share",) + tuple(
    f"{q}_{s}" for q in QUANTITIES for s, _ in STATS)
_ATTRS = (("age", "Age"), ("age_std", "Age"), ("race_value", "Race"),
          ("gender_value", "Gender"))


def as_dict(d) -> dict:
    """A program ``Detection`` (or a reference dict) as a plain dict."""
    if isinstance(d, dict):
        return d
    return dict(box=tuple(d.box), angle=d.angle, eye_left=tuple(d.eye_left),
                eye_right=tuple(d.eye_right), confidence=d.confidence,
                age=d.age, age_std=d.age_std, race_value=d.race_value,
                gender_value=d.gender_value)


def _eyes(d: dict) -> np.ndarray:
    return np.asarray([*d["eye_left"], *d["eye_right"]], np.float64)


def _relative_eye_error(a: np.ndarray, b: np.ndarray) -> float:
    dl = np.hypot(*(a[0:2] - b[0:2]))
    dr = np.hypot(*(a[2:4] - b[2:4]))
    return max(dl, dr) / max(np.hypot(*(b[0:2] - b[2:4])), 1e-12)


def pair(got: Sequence[dict], want: Sequence[dict]):
    """Greedy closest-first pairs (i, j) of ``got`` and ``want``."""
    cand = sorted((_relative_eye_error(_eyes(g), _eyes(w)), i, j)
                  for i, g in enumerate(got) for j, w in enumerate(want))
    used_g, used_w, pairs = set(), set(), []
    for err, i, j in cand:
        if err >= PAIR_TOLERANCE:
            break
        if i in used_g or j in used_w:
            continue
        used_g.add(i)
        used_w.add(j)
        pairs.append((i, j))
    return pairs


def compare(got: Sequence[Sequence], want: Sequence[Sequence[dict]],
            label_ranges: Dict[str, float]) -> Dict[str, float]:
    """The numbers of the module docstring over images: ``got[k]`` the
    program's detections of image k, ``want[k]`` the reference's.
    ``label_ranges`` maps "Age", "Race" and "Gender" to label ranges."""
    shares = []
    gaps: Dict[str, List[float]] = {q: [] for q in QUANTITIES}
    for g_list, w_list in zip(got, want):
        g_list = [as_dict(d) for d in g_list]
        pairs = pair(g_list, w_list)
        n_all = len(g_list) + len(w_list)
        shares.append((n_all - 2 * len(pairs)) / max(n_all, 1))
        for i, j in pairs:
            g, w = g_list[i], w_list[j]
            pg = np.asarray([*g["box"], *_eyes(g)], np.float64)
            pw = np.asarray([*w["box"], *_eyes(w)], np.float64)
            gaps["coord_px"].append(float(np.abs(pg - pw).max()))
            gaps["angle_deg"].append(abs(float(g["angle"])
                                         - float(w["angle"])))
            gaps["conf"].append(abs(float(g["confidence"])
                                    - float(w["confidence"])))
            attr = 0.0
            for key, head in _ATTRS:
                if w.get(key) is None:
                    continue
                if g.get(key) is None:
                    attr = float("inf")
                    break
                attr = max(attr, abs(float(g[key]) - float(w[key]))
                           / label_ranges[head])
            gaps["attr"].append(attr)
    out = {"unpaired_share": float(np.mean(shares)) if shares else 0.0}
    for q in QUANTITIES:
        for name, pct in STATS:
            out[f"{q}_{name}"] = (float(np.percentile(gaps[q], pct))
                                  if gaps[q] else 0.0)
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number that has a limit is within it (a NaN is
    not)."""
    return all(numbers[name] <= limit for name, limit in limits.items())


def label_ranges(model) -> Dict[str, float]:
    """Spread of each head's class labels, from the reference model."""
    out = {}
    for head in ("Age", "Race", "Gender"):
        lab = model.clf(head).avg_labels
        out[head] = float(lab.max() - lab.min())
    return out
