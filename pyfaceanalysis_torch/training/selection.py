"""Training-side candidate scoring and the multi-seed disc selection rule.

Port of ``pyfaceanalysis_tpu.training.selection``. A single-seed disc
retrain ships a lottery ticket: its dataset-sampling variance exceeds the
effects being compared. So the trainer trains the disc nets K times on K
dataset seeds, scores every candidate on a training-side panel (held-out
seeds stay untouched), and ships the winner of a declared rule.

Scoring is detection-only quality (the disc nets gate detection; attribute
heads are shared across candidates): synthetic-scene recall + FP/img
through the port's fused ``detect_batch``, and real-photo anchors TP/FP/FN
(data/train_faces_gt.txt, when its photos are present; the TNS group photo
is evaluation-only and never scored here).

Selection rule (declared):
1. eliminate candidates with anchors FN > 0 or TP < 3 (must find every
   real face);
2. among candidates with panel recall >= recall_floor, pick the lowest
   panel FP/img (ties: lower anchors FP);
3. if none reaches the floor, pick the highest recall.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch


def score_panel(det, n_scenes: int = 48, seed: int = 777,
                canvas: int = 320, face_size=(70.0, 150.0),
                chunk: int = 16) -> Dict:
    """Synthetic-scene recall / FP per image of ``det`` (a FaceDetector).

    Scene geometry from ``RandomState(seed)``, textures from
    ``Sampler(seed * 100000 + i)``; acceptance: relative eye error < 0.25
    (FaceDetectUpdated.py:887)."""
    from pyfaceanalysis_torch.engine.nms import relative_eye_error_np
    from pyfaceanalysis_torch.training import synth
    from pyfaceanalysis_torch.training.sampler import Sampler

    rng = np.random.RandomState(seed)
    scenes, truths = [], []
    for i in range(n_scenes):
        F = rng.uniform(*face_size)
        margin = 0.8 * F
        cx = rng.uniform(margin, canvas - margin)
        cy = rng.uniform(margin, canvas - margin)
        img, attrs = synth.render_face(
            Sampler(seed * 100000 + i, det.device),
            canvas_hw=(canvas, canvas), face_size=F, center=(cx, cy),
            angle_deg=0.0)
        scenes.append(img.cpu().numpy())
        truths.append(np.concatenate([attrs["eye_l"].cpu().numpy(),
                                      attrs["eye_r"].cpu().numpy()]))

    tp = 0
    fp = 0
    for k in range(0, n_scenes, chunk):
        dets = det.detect_batch(scenes[k: k + chunk],
                                estimate_attributes=False)
        for j, out in enumerate(dets):
            true_eyes = truths[k + j]
            matched = False
            for d in out:
                eyes = np.array([*d.eye_left, *d.eye_right])
                if relative_eye_error_np(eyes, true_eyes) < 0.25:
                    if matched:
                        fp += 1          # duplicate of a matched face
                    matched = True
                else:
                    fp += 1
            tp += int(matched)
    return {"recall": tp / max(n_scenes, 1),
            "fp_per_image": fp / max(n_scenes, 1),
            "scenes": n_scenes, "seed": seed}


def score_anchors(det, anchors: str = "data/train_faces_gt.txt") -> Dict:
    """Real-photo TP/FP/FN of ``det`` on the training anchors
    (detection-only)."""
    from pyfaceanalysis_torch.engine.evaluation import GroundTruthEvaluator
    from pyfaceanalysis_torch.io.images import load_image
    from pyfaceanalysis_torch.io.writers import load_true_coordinates

    filenames, _ = load_true_coordinates("", anchors)
    tot = dict(tp=0, fp=0, fn=0)
    for fn in sorted(set(filenames)):
        ev = GroundTruthEvaluator.from_files(anchors)
        image, factor = load_image(fn, 1000)
        dets = det.detect(image, estimate_attributes=False)
        ev.record(fn, dets, prescale_factor=factor)
        tot["tp"] += ev.true_positives
        tot["fp"] += ev.false_positives
        tot["fn"] += ev.false_negatives
    return tot


def score_candidate(model_dir: str, n_scenes: int = 48,
                    panel_seed: int = 777,
                    anchors: str = "data/train_faces_gt.txt",
                    smallest_face: float = 0.15,
                    device: Union[str, torch.device, None] = None) -> Dict:
    """Full training-side score of one candidate artifact directory, on
    ``device`` (default ``cuda``). The anchors join when their annotation
    file and every photo it names are present."""
    from pyfaceanalysis_torch.config import DetectorConfig
    from pyfaceanalysis_torch.engine.detector import (
        DetectionModel,
        FaceDetector,
    )
    from pyfaceanalysis_torch.training.calibration import anchor_photos

    model = DetectionModel.load(model_dir, device=device)
    det = FaceDetector(model, DetectorConfig(smallest_face=smallest_face),
                       device=device)
    out = score_panel(det, n_scenes=n_scenes, seed=panel_seed)
    if anchor_photos(anchors) is not None:
        det_a = FaceDetector(model, DetectorConfig(smallest_face=0.1),
                             device=device)
        out["anchors"] = score_anchors(det_a, anchors)
    return out


def score_tns(model_dir: str, gt_file: str = "data/tns_group_gt.txt",
              image: Optional[str] = None, smallest_face: float = 0.1,
              device: Union[str, torch.device, None] = None
              ) -> Optional[Dict]:
    """TNS ship-gate measurement: detection-only TP/FP/FN of ``model_dir``
    on the reference's flagship group photo (8-face truth in ``gt_file``;
    ``image`` defaults to the photo the truth file names). The photo stays
    excluded from training, mining, calibration and selection; this
    exists only to gate the final winner's promotion on "TNS TP >= 4 AND
    FP <= 2". Returns None when the files are unavailable."""
    if not os.path.exists(gt_file):
        return None
    from pyfaceanalysis_torch.io.writers import load_true_coordinates
    if image is None:
        image = load_true_coordinates("", gt_file)[0][0]
    if not os.path.exists(image):
        return None
    from pyfaceanalysis_torch.config import DetectorConfig
    from pyfaceanalysis_torch.engine.detector import (
        DetectionModel,
        FaceDetector,
    )
    from pyfaceanalysis_torch.engine.evaluation import GroundTruthEvaluator
    from pyfaceanalysis_torch.io.images import load_image

    model = DetectionModel.load(model_dir, device=device)
    det = FaceDetector(model, DetectorConfig(smallest_face=smallest_face),
                       device=device)
    ev = GroundTruthEvaluator.from_files(gt_file)
    img, factor = load_image(image, det.config.prescale_size)
    dets = det.detect(img, estimate_attributes=False)
    ev.record(image, dets, prescale_factor=factor)
    return {"tp": ev.true_positives, "fp": ev.false_positives,
            "fn": ev.false_negatives}


def tns_gate(tns: Optional[Dict], min_tp: int = 4, max_fp: int = 2) -> Dict:
    """Applies the declared TNS ship-gate thresholds (TP >= 4, FP <= 2) to
    a :func:`score_tns` result."""
    ok = bool(tns) and tns["tp"] >= min_tp and tns["fp"] <= max_fp
    return {"result": tns, "min_tp": min_tp, "max_fp": max_fp,
            "pass": ok, "evaluated": tns is not None}


def select(scores: Sequence[Dict], recall_floor: float = 0.73,
           verbose: bool = True) -> Optional[int]:
    """Applies the declared rule to a list of score dicts (each optionally
    carrying "anchors"); returns the winning index or None if every
    candidate is eliminated."""
    rows: List[Dict] = []
    for i, s in enumerate(scores):
        a = s.get("anchors") or {}
        eliminated = bool(a) and (a.get("fn", 0) > 0 or a.get("tp", 0) < 3)
        rows.append(dict(i=i, recall=s["recall"], fp=s["fp_per_image"],
                         a_fp=a.get("fp", 0), eliminated=eliminated))
    if verbose:
        for r, s in zip(rows, scores):
            a = s.get("anchors")
            atxt = (f"{a['tp']}TP/{a['fp']}FP/{a['fn']}FN" if a else "-")
            print(f"  candidate {r['i']}: recall {r['recall']:.4f} "
                  f"FP/img {r['fp']:.4f} anchors {atxt}"
                  f"{'  ELIMINATED' if r['eliminated'] else ''}", flush=True)
    alive = [r for r in rows if not r["eliminated"]]
    if not alive:
        return None
    floor = [r for r in alive if r["recall"] >= recall_floor]
    if floor:
        floor.sort(key=lambda r: (r["fp"], r["a_fp"]))
        return floor[0]["i"]
    alive.sort(key=lambda r: -r["recall"])
    return alive[0]["i"]
