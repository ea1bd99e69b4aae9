"""The finisher's host work as array code, held to the per-pair and per-row
algorithms it replaced.

``engine/nms.purge_detections`` reads one pairwise matrix of relative eye
errors; ``engine/heads._frame_arrays`` computes every row's Z frame at
once (``normalization.inferred_mouth_z_frames``); ``_assemble_batch``
converts each array with one ``.tolist()``. Each must give the old
results bit for bit: the loops they replaced are copied below and compared
with ``np.array_equal``. CPU only; imports no JAX.
"""

import types

import numpy as np
import pytest
from torch_threads import fair_torch_threads  # noqa: F401  (autouse)

from pyfaceanalysis_torch import normalization
from pyfaceanalysis_torch.config import DetectorConfig
from pyfaceanalysis_torch.engine import detector as detector_mod
from pyfaceanalysis_torch.engine import heads, nms
from pyfaceanalysis_torch.engine.detector import Detection, FaceDetector


def _purge_per_pair(rows, threshold=0.25, weight_confidences_by_area=True):
    """The per-pair greedy purge, as the reference writes it."""
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
    rows = rows[np.argsort(weighted)[::-1]]
    kept = [rows[0]]
    for row in rows:
        min_d = min(nms.relative_eye_error_np(row[5:9], k[5:9])
                    for k in kept)
        if min_d > threshold:
            kept.append(row)
    return np.asarray(kept)


def _frames_per_row(rows):
    """The per-row Z frames through ``normalization.frame_params``."""
    centers, angles, sfs = [], [], []
    for row in rows:
        fp = normalization.frame_params(
            [row[5], row[6], row[7], row[8], 0.0, 0.0],
            normalization_method="eyes_inferred-mouth_areaZ",
            centering_mode="mid_eyes_inferred-mouth",
            rotation_mode="EyeLineRotation",
            out_size=(heads.Z_SIZE[1], heads.Z_SIZE[0]))
        centers.append([fp.center_x, fp.center_y])
        angles.append(fp.angle_deg)
        sfs.append(fp.sf)
    return centers, angles, sfs


def _faces(rng, n, ncols=10, spread=400.0):
    """n detection rows: boxes, angles, eyes of faces 10-120 px apart,
    confidences in [0, 0.4]; columns past 10 hold refined eyes."""
    centre = rng.uniform(0, spread, (n, 2))
    half = rng.uniform(5, 60, (n, 1))
    tilt = rng.uniform(-0.5, 0.5, (n, 1))
    dx, dy = half * np.cos(tilt), half * np.sin(tilt)
    eyes = np.concatenate([centre - np.concatenate([dx, dy], 1),
                           centre + np.concatenate([dx, dy], 1)], 1)
    box = np.concatenate([centre - 2 * half, centre + 2 * half], 1)
    rows = np.concatenate([box, np.degrees(tilt), eyes,
                           rng.uniform(0, 0.4, (n, 1))], 1)
    if ncols > 10:
        extra = eyes + rng.uniform(-1, 1, (n, 4))
        rows = np.concatenate([rows, extra, rng.uniform(
            0, 1, (n, ncols - 14))], 1)
    return rows


def _clustered(rng, n_faces, per_face, jitter=2.0):
    """Each face detected ``per_face`` times a few pixels apart, shuffled."""
    base = _faces(rng, n_faces, spread=1000.0)
    rows = np.repeat(base, per_face, axis=0)
    rows[:, 0:9] += rng.uniform(-jitter, jitter, (len(rows), 9))
    rows[:, 9] = rng.uniform(0, 0.4, len(rows))
    return rows[rng.permutation(len(rows))]


def _tied(rng):
    """Equal confidence and inter-eye distance: every weight ties, so the
    order is argsort's tie order, reversed."""
    rows = _faces(rng, 40)
    rows[:, 9] = 0.125
    rows[:, 7] = rows[:, 5] + 30.0
    rows[:, 8] = rows[:, 6]
    rows[::3, 5:9] = rows[0, 5:9]                 # some exact duplicates
    return rows


def _zero_eyes(rng):
    """Rows whose eyes coincide: inter-eye distance 0, the 1e-12 floor."""
    rows = _faces(rng, 12)
    rows[::2, 7:9] = rows[::2, 5:7]
    rows[1, 5:9] = rows[0, 5:9]
    return rows


def _nan_row(rng):
    """A row with NaN eyes: the NaN errors keep Python min's semantics."""
    rows = _faces(rng, 10)
    rows[4, 5:9] = np.nan
    rows[6, 7] = np.nan
    return rows


CASES = {
    "0-rows": lambda rng: np.zeros((0, 10)),
    "1-row": lambda rng: _faces(rng, 1),
    "2-rows": lambda rng: _faces(rng, 2),
    "2-duplicates": lambda rng: np.repeat(_faces(rng, 1), 2, axis=0),
    "26-group": lambda rng: _faces(rng, 26, spread=1000.0),
    "64-dense": lambda rng: _faces(rng, 64, spread=150.0),
    "160-spread": lambda rng: _faces(rng, 160, spread=4000.0),
    "256-clustered": lambda rng: _clustered(rng, 32, 8),
    "90-clustered-loose": lambda rng: _clustered(rng, 30, 3, jitter=12.0),
    "tied-weights": _tied,
    "zero-eye-distance": _zero_eyes,
    "14-columns": lambda rng: _faces(rng, 30, ncols=14, spread=300.0),
    "15-columns": lambda rng: _faces(rng, 30, ncols=15, spread=300.0),
    "float32-rows": lambda rng: _faces(rng, 30, spread=300.0).astype(
        np.float32),
    "nan-eyes": _nan_row,
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 2147483659])
def test_purge_equals_per_pair(case, seed):
    rows = CASES[case](np.random.RandomState(seed % (1 << 32)))
    got = nms.purge_detections(rows, 0.25)
    want = _purge_per_pair(rows, 0.25)
    assert got.dtype == want.dtype == np.float64
    assert got.shape == want.shape
    assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("threshold", [-1.0, 0.0, 0.1, 1.0, 3.0])
@pytest.mark.parametrize("by_area", [True, False])
def test_purge_equals_per_pair_thresholds(threshold, by_area):
    rows = _clustered(np.random.RandomState(7), 12, 4, jitter=6.0)
    got = nms.purge_detections(rows, threshold, by_area)
    want = _purge_per_pair(rows, threshold, by_area)
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def test_eye_error_matrix_equals_per_pair():
    eyes = _zero_eyes(np.random.RandomState(3))[:, 5:9]
    err = nms.relative_eye_error_matrix(eyes)
    want = np.array([[nms.relative_eye_error_np(a, b) for b in eyes]
                     for a in eyes])
    assert np.array_equal(err, want)


def _frame_rows(seed):
    rng = np.random.RandomState(seed)
    rows = _faces(rng, 200, spread=3000.0)
    rows[:50, 5:9] *= -1.0                        # eyes left of the origin
    rows[50:60, 7:9] = rows[50:60, 5:7]           # zero inter-eye distance
    rows[60:70, 7] = rows[60:70, 5] - 40.0        # upside-down faces
    rows[70:80, 5:9] = rng.uniform(-1e-3, 1e-3, (10, 4))
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2147483647])
def test_z_frames_equal_per_row(seed):
    rows = _frame_rows(seed)
    cx, cy, angles, sfs = normalization.inferred_mouth_z_frames(rows[:, 5:9])
    centers, want_angles, want_sfs = _frames_per_row(rows)
    # float64, element for element, before the rounding to float32
    assert np.array_equal(np.stack([cx, cy], 1), np.asarray(centers))
    assert np.array_equal(angles, np.asarray(want_angles))
    assert np.array_equal(sfs, np.asarray(want_sfs))
    got = heads._frame_arrays(rows)
    want = (np.asarray(centers, np.float32),
            np.asarray(want_angles, np.float32),
            np.asarray(want_sfs, np.float32))
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        assert np.array_equal(g, w)


def test_z_frames_of_purged_rows():
    """The heads' inputs as the finisher makes them: purged 14-column
    rows, float32 rows, and no rows."""
    rng = np.random.RandomState(5)
    for rows in (nms.purge_detections(_faces(rng, 40, ncols=14)),
                 _faces(rng, 20).astype(np.float32)):
        centers, angles, sfs = _frames_per_row(rows)
        got = heads._frame_arrays(rows)
        assert np.array_equal(got[0], np.asarray(centers, np.float32))
        assert np.array_equal(got[1], np.asarray(angles, np.float32))
        assert np.array_equal(got[2], np.asarray(sfs, np.float32))
    c, a, s = heads._frame_arrays(np.zeros((0, 10)))
    assert c.shape == (0, 2) and a.shape == (0,) and s.shape == (0,)


def _detections_per_value(purged_per_image, attrs, cfg):
    """Detections built with one ``float()`` per value."""
    out, offset = [], 0
    for purged in purged_per_image:
        dets = []
        for j, r in enumerate(purged):
            k = offset + j
            refined = len(r) >= 14 and cfg.eye_report == "refined"
            e = r[10:14] if refined else r[5:9]
            a = [None if v is None else float(v[k]) for v in attrs]
            dets.append(Detection(
                box=tuple(float(v) for v in r[0:4]), angle=float(r[4]),
                eye_left=(float(e[0]), float(e[1])),
                eye_right=(float(e[2]), float(e[3])),
                confidence=float(r[9]), age=a[0], age_std=a[1],
                race_value=a[2], gender_value=a[3]))
        offset += len(purged)
        out.append(dets)
    return out


def _assemble(monkeypatch, purged_per_image, cfg, attributes):
    n = sum(len(p) for p in purged_per_image)
    rng = np.random.RandomState(n)
    attrs = [rng.uniform(-3, 80, n).astype(np.float32) for _ in range(4)]
    monkeypatch.setattr(
        detector_mod.heads_mod, "estimate_age_race_gender_multi",
        lambda stack, rows, img_idx, model, tta, graph_cache: tuple(attrs))
    det = types.SimpleNamespace(config=cfg, model=None, _head_graphs=None,
                                _wants_attributes=lambda: True)
    got = FaceDetector._assemble_batch(det, None, purged_per_image,
                                       attributes)
    want = _detections_per_value(
        purged_per_image,
        attrs if attributes and n else [None] * 4, cfg)
    return got, want


@pytest.mark.parametrize("ncols,eye_report", [(10, "refined"),
                                              (14, "refined"),
                                              (14, "pass1")])
@pytest.mark.parametrize("attributes", [True, False])
def test_assembly_equals_per_value(monkeypatch, ncols, eye_report,
                                   attributes):
    rng = np.random.RandomState(11)
    purged = [nms.purge_detections(_faces(rng, n, ncols=ncols))
              if n else np.zeros((0, 10)) for n in (23, 0, 1, 5)]
    cfg = DetectorConfig(eye_report=eye_report)
    got, want = _assemble(monkeypatch, purged, cfg, attributes)
    assert got == want
    for d in (d for dets in got for d in dets):
        values = (*d.box, d.angle, *d.eye_left, *d.eye_right, d.confidence)
        assert all(type(v) is float for v in values)
        attr = (d.age, d.age_std, d.race_value, d.gender_value)
        assert all(type(v) is float for v in attr) if attributes \
            else attr == (None,) * 4


def test_assembly_without_faces(monkeypatch):
    got, want = _assemble(monkeypatch, [np.zeros((0, 10))] * 3,
                          DetectorConfig(), True)
    assert got == want == [[], [], []]
