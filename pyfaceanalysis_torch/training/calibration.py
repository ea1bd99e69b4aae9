"""Disc-cutoff-ladder + eye-gate calibration (the trainer's closing step).

Port of ``pyfaceanalysis_tpu.training.calibration``. The reference's
``cut_offs_face`` ladder (FaceDetectUpdated.py:98) was tuned to the
reference classifiers' non-faceness scale; a freshly trained Gaussian
soft-classifier has another absolute scale, so the constants would kill
well-centred true faces mid-cascade. This module calibrates every disc
stage from the cascade's own refinement trajectories (permissive-gate traced
runs of the port's ``FaceDetector`` on held-out synthetic scenes and the
real training anchors), plus the eye "too far" gate (reference constant
9.0, face_analysis.py:1073).

Scene geometry comes from ``np.random.RandomState(seed)`` as in the JAX
package; textures from ``Sampler(seed * 1000 + i)``, so a calibration of
the same model places the same faces but renders other pixels. The real
anchors join only when their annotation file and every photo it names are
present.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple, Union

import numpy as np
import torch


def anchor_photos(anchors: str):
    """(filenames, truth rows) of an annotation file, or None when the file
    or one of the photos it names is missing."""
    from pyfaceanalysis_torch.io.writers import load_true_coordinates
    if not (anchors and os.path.exists(anchors)):
        return None
    filenames, coords = load_true_coordinates("", anchors)
    if not all(os.path.exists(f) for f in set(filenames)):
        return None
    return filenames, coords


def collect_image(det, image, truth_rows, cfg, model):
    """One permissive-gate traced cascade run of ``det`` on ``image``.

    Returns (per-face list of {serial: best responsible conf}, background
    conf per serial, n_faces_covered, n_converged, eye |reg| list)."""
    from pyfaceanalysis_torch import geometry
    from pyfaceanalysis_torch.config import DESIRED_SAMPLING, EYE_SAMPLING
    from pyfaceanalysis_torch.engine import cascade as cascade_mod
    from pyfaceanalysis_torch.engine import eyes as eyes_mod

    det.detect(image, estimate_attributes=False, collect_trace=True)
    trace = det.last_trace
    plan = model.plan
    geom = model.spec.face_geom

    state, n_real, _ = cascade_mod.make_grid_state(
        image.shape[1], image.shape[0], geom, cfg)
    g_boxes = state.boxes.numpy()[:n_real]
    g_cx = (g_boxes[:, 0] + g_boxes[:, 2]) / 2.0
    g_cy = (g_boxes[:, 1] + g_boxes[:, 3]) / 2.0
    g_side = np.sqrt((g_boxes[:, 2] - g_boxes[:, 0]) ** 2 +
                     (g_boxes[:, 3] - g_boxes[:, 1]) ** 2)
    max_dx = state.max_dx.numpy()[:n_real]
    max_dy = state.max_dy.numpy()[:n_real]

    resp_any = np.zeros(n_real, bool)
    resp_sets = []
    covered = 0
    truth_rows = np.atleast_2d(truth_rows)
    for row in truth_rows:
        fcx, fcy = row[8], row[9]
        fbox = row[10:14]
        f_side = np.hypot(fbox[2] - fbox[0], fbox[3] - fbox[1])
        ratio = f_side / g_side
        resp = ((np.abs(g_cx - fcx) <= max_dx) &
                (np.abs(g_cy - fcy) <= max_dy) &
                (ratio >= geom.mins / DESIRED_SAMPLING) &
                (ratio <= geom.maxs / DESIRED_SAMPLING))
        resp_sets.append(np.where(resp)[0])
        resp_any |= resp
        covered += int(resp.any())

    # Converging responsible windows: final centre error < 9 regression px
    # (the 0.25-of-inter-eye acceptance radius, FaceDetectUpdated.py:887)
    # and final scale within 20%, under permissive disc gates.
    f_boxes = np.asarray(trace[-1][0])[:n_real]
    f_mask = np.asarray(trace[-1][2])[:n_real]
    f_cx = (f_boxes[:, 0] + f_boxes[:, 2]) / 2.0
    f_cy = (f_boxes[:, 1] + f_boxes[:, 3]) / 2.0
    f_w = np.maximum(f_boxes[:, 2] - f_boxes[:, 0], 1e-9)
    conv_sets = []
    for row, ridx in zip(truth_rows, resp_sets):
        fbox = row[10:14]
        f_side = np.hypot(fbox[2] - fbox[0], fbox[3] - fbox[1]) / np.sqrt(2)
        ex = (row[8] - f_cx[ridx]) / f_w[ridx] * geom.regression_width
        ey = (row[9] - f_cy[ridx]) / f_w[ridx] * geom.regression_height
        es = f_side / f_w[ridx]
        good = (f_mask[ridx] & (np.hypot(ex, ey) < 9.0)
                & (es > 0.8) & (es < 1.25))
        conv_sets.append(ridx[good])

    face_confs = [dict() for _ in resp_sets]
    bg_confs = {}
    prev_mask = np.ones(n_real, bool)
    for si, st in enumerate(plan):
        mask_si = np.asarray(trace[si][2])[:n_real]
        if st.kind == "Disc":
            conf_si = np.asarray(trace[si][3])[:n_real]
            for fi, cidx in enumerate(conv_sets):
                alive = cidx[prev_mask[cidx]]
                if len(alive):
                    face_confs[fi][st.serial] = float(conf_si[alive].min())
            bg = prev_mask & ~resp_any
            bg_confs[st.serial] = (conf_si[bg], np.where(bg)[0])
        prev_mask = mask_si
    n_conv = sum(1 for c in conv_sets if len(c))

    # Eye |reg| of each converged true face (best window): the calibration
    # source of the "too far" gate. The eye patches come from the canvas
    # gather, as in the JAX package.
    eye_regs = []
    f_ang = np.asarray(trace[-1][1])[:n_real]
    best = []
    for row, cidx in zip(truth_rows, conv_sets):
        if not len(cidx):
            continue
        err = np.hypot(row[8] - f_cx[cidx], row[9] - f_cy[cidx])
        best.append(cidx[int(np.argmin(err))])
    if best:
        dev = det.device
        boxes = torch.as_tensor(f_boxes[best], device=dev)
        angles = torch.as_tensor(f_ang[best], device=dev)
        n = len(best)
        _, l_b, r_b = geometry.compute_approximate_eye_boxes_coordinates(
            boxes, angles, face_sampling=DESIRED_SAMPLING,
            eye_sampling=EYE_SAMPLING)
        eg = model.spec.eye_geom
        with torch.no_grad():
            _, max_reg = eyes_mod.localize_eyes(
                model.nets["net_eye"], model.clf_input_dim("EyeLX"),
                model.clf_input_dim("EyeLY"),
                (eg.subimage_height, eg.subimage_width),
                det._to_canvas(image), model.classifier("EyeLX"),
                model.classifier("EyeLY"), torch.cat([l_b, r_b]),
                torch.cat([angles, angles]))
        max_reg = max_reg.cpu().numpy()
        eye_regs = list(np.maximum(max_reg[:n], max_reg[n:2 * n]))
    return face_confs, bg_confs, covered, n_conv, eye_regs


def background_rate(ladder, bg_images, disc_serials):
    """Cumulative background survival through ``ladder``: a window passes
    iff its conf clears the cutoff at every disc stage it stayed alive for.
    bg_images: per image {serial: (conf array, window index array)}.
    Returns (windows/image, passed, total)."""
    total = passed = 0
    for bg in bg_images:
        alive = None
        for s in disc_serials:
            if s not in bg:
                continue
            conf, idx = bg[s]
            ok = dict(zip(idx, conf < ladder[s]))
            if alive is None:
                alive = ok
                total += len(idx)
            else:
                alive = {i: alive.get(i, False) and ok.get(i, False)
                         for i in alive}
        if alive:
            passed += sum(alive.values())
    n_img = max(len(bg_images), 1)
    return passed / n_img, passed, total


def cap_ladder(face_ladder, bg_images, disc_serials, bg_budget,
               ref=None, log=print, protect=()):
    """Precision cap: interpolate ``face_ladder`` back toward the reference
    constants -- cutoff_t[s] = ref[s] + t (face[s] - ref[s]) -- and
    binary-search the loosest t whose cumulative background survival meets
    ``bg_budget`` windows/image. t=0 (the reference ladder) is the floor: a
    budget unreachable even there is reported, not forced.

    ``protect`` (serial indices) exempts rungs from the interpolation:
    protected rungs keep their face-calibrated value and the budget is
    reclaimed from the unprotected rungs alone (below the reference
    constants if the protected rungs alone spend the whole budget). The
    no-room floor is always the uniform reference ladder: if even that
    exceeds the budget, the face-calibrated ladder is returned unchanged."""
    from pyfaceanalysis_torch.config import REFERENCE_CUT_OFFS_FACE

    ref = list(REFERENCE_CUT_OFFS_FACE) if ref is None else list(ref)
    face_cut = list(face_ladder)
    protect = set(protect)

    def at(t):
        # t in [t_floor, 1]; negative t tightens unprotected rungs below
        # the reference (clamped at 0) to pay for protected rungs.
        return [face_cut[s] if s in protect
                else max(ref[s] + t * (face_cut[s] - ref[s]), 0.0)
                for s in range(len(face_cut))]

    floor_rate, _, _ = background_rate(ref, bg_images, disc_serials)
    if floor_rate > bg_budget:
        who = (" (with protected rungs at reference values too)"
               if protect else "")
        log(f"  bg cap: even the uniform reference ladder{who} passes "
            f"{floor_rate:.1f}/image > budget {bg_budget}; keeping the "
            f"face-calibrated ladder (cap has no room)")
        return face_cut
    lo_rate, _, _ = background_rate(at(0.0), bg_images, disc_serials)
    if lo_rate <= bg_budget:
        lo, hi = 0.0, 1.0
    else:
        # Protected rungs alone blow the budget at t=0: reclaim it from
        # the unprotected rungs by searching below the reference, down to
        # the t that puts every unprotected rung at 0.
        unprot = [s for s in range(len(face_cut))
                  if s not in protect and face_cut[s] > ref[s]]
        if not unprot:
            log(f"  bg cap: no unprotected rung can tighten and rate "
                f"{lo_rate:.1f} > budget {bg_budget}; keeping the "
                f"face-calibrated ladder")
            return face_cut
        t_floor = min(-ref[s] / (face_cut[s] - ref[s]) for s in unprot)
        lo, hi = t_floor, 0.0
    for _ in range(20):
        mid = (lo + hi) / 2.0
        r, _, _ = background_rate(at(mid), bg_images, disc_serials)
        if r <= bg_budget:
            lo = mid
        else:
            hi = mid
    # Round down (tighter): plain rounding can nudge a cutoff just past the
    # budget boundary the search found. Protected rungs keep the
    # face-calibrated value bit for bit.
    ladder = [face_cut[s] if s in protect else int(v * 10000) / 10000.0
              for s, v in enumerate(at(lo))]
    rate, passed, total = background_rate(ladder, bg_images, disc_serials)
    log(f"  bg cap (budget {bg_budget}/image): t={lo:.3f} -> "
        f"{[f'{v:.3f}' for v in ladder]} ({passed}/{total} = "
        f"{rate:.1f}/image)")
    return ladder


def anchor_passes(image: np.ndarray, rows: np.ndarray,
                  anchor_small_ie: Tuple[float, ...] = ()):
    """The (image, truth_rows) pass list for one real anchor photo.

    Pass 0 is the native-size photo. For each target inter-eye size (px) in
    ``anchor_small_ie`` a small-scale replica is appended: the photo is
    downscaled with the product's own prescale method (PIL NEAREST,
    io.images.load_image) so the median face lands at that size. Targets at
    or above 0.9x the native size are skipped. Truth rows are scaled with
    the image."""
    passes = [(image, rows)]
    ie = np.median(np.hypot(rows[:, 2] - rows[:, 0],
                            rows[:, 3] - rows[:, 1]))
    for target in anchor_small_ie:
        s = float(target) / float(ie)
        if s >= 0.9:                    # already near/below the target size
            continue
        from PIL import Image as _PILImage
        im = _PILImage.fromarray(
            np.clip(image * 255.0, 0, 255).astype(np.uint8))
        w, h = im.size
        new_w, new_h = max(int(w * s), 64), max(int(h * s), 64)
        small = im.resize((new_w, new_h), _PILImage.NEAREST)
        # Scale rows by the actual per-axis scale (the 64-px floor can
        # clamp the resize).
        sx, sy = new_w / float(w), new_h / float(h)
        scaled = np.asarray(rows, np.float64).copy()
        scaled[:, 0::2] *= sx
        scaled[:, 1::2] *= sy
        passes.append((np.asarray(small, np.float32) / 255.0, scaled))
    return passes


def calibrate_model(model_dir: str, scenes: int = 40, seed: int = 1234,
                    canvas: int = 320, angle_max: float = 15.0,
                    q: float = 0.95, margin: float = 1.10,
                    anchors: str = "data/train_faces_gt.txt",
                    smallest_face: float = 0.15,
                    bg_budget: float = 0.0,
                    bg_protect: Tuple[int, ...] = (),
                    anchor_small_ie: Tuple[float, ...] = (),
                    verbose: bool = True,
                    device: Union[str, torch.device, None] = None) -> Dict:
    """Computes the calibrated disc ladder + eye gate for ``model_dir`` on
    ``device`` (default ``cuda``).

    ``anchor_small_ie`` adds downscaled replicas of each real anchor photo
    (see :func:`anchor_passes`). ``bg_budget`` > 0 adds a precision
    constraint (:func:`cap_ladder`); 0 only ever loosens cutoffs to spare
    converged faces and reports the background rate.

    Returns {"cut_offs_face": [10 floats], "tolerance_xy_eye": float,
    "bg_per_image": float, "faces": int, "converged": int, "bg_protect":
    list}. Does not write the manifest: pass the result to
    :func:`write_calibration`.
    """
    from pyfaceanalysis_torch.config import (
        REFERENCE_CUT_OFFS_FACE,
        DetectorConfig,
    )
    from pyfaceanalysis_torch.engine.detector import (
        DetectionModel,
        FaceDetector,
    )
    from pyfaceanalysis_torch.io.images import load_image
    from pyfaceanalysis_torch.io.writers import truth_row_from_landmarks
    from pyfaceanalysis_torch.training import synth
    from pyfaceanalysis_torch.training.sampler import Sampler

    def log(msg):
        if verbose:
            print(msg, flush=True)

    model = DetectionModel.load(model_dir, device=device)
    cfg = DetectorConfig(smallest_face=smallest_face,
                         cut_offs_face=(2.0,) * 10, last_cut_off_face=2.0)
    det = FaceDetector(model, cfg, device=device)
    cfg = det.config

    disc_serials = sorted({p.serial for p in model.plan if p.kind == "Disc"})
    per_stage = {s: [] for s in disc_serials}   # per-face best conf
    bg_images = []                        # per image: {serial: (conf, idx)}
    eye_regs_all = []                           # synthetic converged faces
    eye_regs_real = []                          # real-anchor converged faces
    total_faces = total_covered = total_conv = 0

    # --- synthetic held-out scenes ---------------------------------------
    rng = np.random.RandomState(seed)
    for i in range(scenes):
        F = rng.uniform(70.0, 150.0)
        margin_px = 0.8 * F
        cx = rng.uniform(margin_px, canvas - margin_px)
        cy = rng.uniform(margin_px, canvas - margin_px)
        ang = rng.uniform(-angle_max, angle_max)
        img, attrs = synth.render_face(
            Sampler(seed * 1000 + i, det.device), canvas_hw=(canvas, canvas),
            face_size=F, center=(cx, cy), angle_deg=ang)
        el = attrs["eye_l"].cpu().numpy()
        er = attrs["eye_r"].cpu().numpy()
        mo = attrs["mouth"].cpu().numpy()
        row = np.asarray(truth_row_from_landmarks(
            el[0], el[1], er[0], er[1],
            (el[0] + er[0]) / 2, (el[1] + er[1]) / 2, mo[0], mo[1]))
        fc, bg, cov, nc, eregs = collect_image(det, img.cpu().numpy(), row,
                                               cfg, model)
        for d in fc:
            for s, v in d.items():
                per_stage[s].append(v)
        bg_images.append(bg)
        eye_regs_all.extend(eregs)
        total_faces += 1
        total_covered += cov
        total_conv += nc

    # --- real training anchors (never the evaluation photo) ---------------
    found = anchor_photos(anchors)
    if found is None and anchors and os.path.exists(anchors):
        log(f"real anchors of {anchors} skipped: a photo it names is "
            f"missing")
    if found is not None:
        filenames, coords = found
        by_file = {}
        for f, c in zip(filenames, coords):
            by_file.setdefault(f, []).append(c)
        for f, rows in by_file.items():
            image, factor = load_image(f, cfg.prescale_size)
            rows = np.stack(rows) * factor
            passes = anchor_passes(image, rows, anchor_small_ie)
            for p_img, p_rows in passes:
                fc, bg, cov, nc, eregs = collect_image(det, p_img, p_rows,
                                                       cfg, model)
                for d in fc:
                    for s2, v in d.items():
                        per_stage[s2].append(v)
                bg_images.append(bg)
                eye_regs_real.extend(eregs)
                total_faces += len(p_rows)
                total_covered += cov
                total_conv += nc

    log(f"\ncalibration set: {total_faces} faces "
        f"({total_covered} covered by the grid, "
        f"{total_conv} with a converging trajectory)")

    ladder = list(REFERENCE_CUT_OFFS_FACE)
    log(f"{'stage':>6s} {'n':>4s} {'q50':>7s} {'q90':>7s} {'q95':>7s} "
        f"{'max':>7s} {'ref':>6s} {'new':>7s}")
    for s in disc_serials:
        vals = np.asarray(per_stage[s])
        ref = REFERENCE_CUT_OFFS_FACE[s]
        if not len(vals):
            log(f"Disc{s:<2d} {0:>4d}  (no surviving faces; keeping "
                f"{ref:.3f})")
            continue
        cut = float(np.quantile(vals, q)) * margin
        cut = float(np.clip(cut, ref, 0.985))
        ladder[s] = round(cut, 4)
        log(f"Disc{s:<2d} {len(vals):4d} {np.quantile(vals, .5):7.3f} "
            f"{np.quantile(vals, .9):7.3f} {np.quantile(vals, .95):7.3f} "
            f"{vals.max():7.3f} {ref:6.2f} {ladder[s]:7.3f}")

    bg_per_image, passed_bg, total_bg = background_rate(ladder, bg_images,
                                                        disc_serials)
    log(f"  background windows surviving the calibrated ladder: "
        f"{passed_bg}/{total_bg} ({bg_per_image:.1f}/image pre-NMS)")

    if bg_budget > 0 and bg_per_image > bg_budget:
        ladder = cap_ladder(ladder, bg_images, disc_serials, bg_budget,
                            log=log, protect=bg_protect)
        bg_per_image, passed_bg, total_bg = background_rate(
            ladder, bg_images, disc_serials)

    # --- eye "too far" gate from converged true faces ----------------------
    # The real-anchor quantile when available, clipped to [9, 14]: only
    # ever loosens, and never past where the regression range (+-10.5)
    # stops being informative.
    eye_tol = 9.0
    pool = eye_regs_real if len(eye_regs_real) >= 4 else (
        eye_regs_real + eye_regs_all)
    if pool:
        vals = np.asarray(pool)
        tag = "real-anchor" if len(eye_regs_real) >= 4 else "mixed"
        eye_tol = float(np.clip(np.quantile(vals, q) * 1.05, 9.0, 14.0))
        eye_tol = round(eye_tol, 2)
        log(f"\neye |reg| of converged faces ({tag}, n={len(vals)}): "
            f"q50={np.quantile(vals, .5):.2f} "
            f"q90={np.quantile(vals, .9):.2f} "
            f"q95={np.quantile(vals, .95):.2f} max={vals.max():.2f} "
            f"-> tolerance_xy_eye {eye_tol:.2f} (ref 9.0)")

    return {"cut_offs_face": ladder, "tolerance_xy_eye": eye_tol,
            "bg_per_image": bg_per_image, "faces": total_faces,
            "converged": total_conv, "bg_protect": sorted(bg_protect)}


def write_calibration(model_dir: str, result: Dict,
                      verbose: bool = True) -> None:
    """Writes a :func:`calibrate_model` result into the model manifest.

    Final gate: keep the stricter of the trainer's residual-patch estimate
    and the converged-trajectory quantile (precision lives at the final
    gate, recall at the mid-ladder ones), except when rung 9 is
    bg-budget-protected: the min-clamp would undo the protection, and the
    background budget already bounds the FP cost.
    """
    path = os.path.join(model_dir, "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    ladder = list(result["cut_offs_face"])
    last = manifest.get("calibration", {}).get("last_cut_off_face")
    if last is not None and 9 not in set(result.get("bg_protect", ())):
        ladder[9] = min(ladder[9], round(float(last), 4))
    manifest.setdefault("calibration", {})["cut_offs_face"] = ladder
    manifest["calibration"]["last_cut_off_face"] = ladder[9]
    manifest["calibration"]["tolerance_xy_eye"] = result["tolerance_xy_eye"]
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1)
    if verbose:
        print(f"wrote calibrated ladder to {path}: "
              f"{[f'{v:.3f}' for v in ladder]}", flush=True)
