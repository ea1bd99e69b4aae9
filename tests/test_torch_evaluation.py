"""PyTorch port vs the JAX package: the ground-truth evaluators.

The same detections, truth rows and cascade traces go through both
packages' ``GroundTruthEvaluator`` and ``PerStageEvaluator``: every counter
is equal and the ``report()`` strings are equal letter for letter. The
scenes are those of tests/test_evaluation.py.
"""

import types

import numpy as np
import pytest
from test_evaluation import _Det, _truth_row

from pyfaceanalysis_torch.config import DetectorConfig as TConfig
from pyfaceanalysis_torch.config import NetGeometry as TGeometry
from pyfaceanalysis_torch.engine import cascade as t_cascade
from pyfaceanalysis_torch.engine import evaluation as t_eval
from pyfaceanalysis_tpu.config import DetectorConfig as JConfig
from pyfaceanalysis_tpu.config import NetGeometry as JGeometry
from pyfaceanalysis_tpu.engine import evaluation as j_eval

_FACE_A = _truth_row(100, 100, 140, 100)
_FACE_B = _truth_row(300, 100, 340, 100)
_FACE_C = _truth_row(108, 100, 148, 100)          # overlaps face A

# name -> (truth rows, detections as (eye_left, eye_right), (TP, FP, FN))
_SCENES = {
    "multi_face": ([_FACE_A, _FACE_B],
                   [((101, 101), (139, 100)), ((500, 500), (540, 500))],
                   (1, 1, 1)),
    "duplicate": ([_FACE_A],
                  [((101, 101), (139, 100)), ((102, 100), (141, 101))],
                  (1, 1, 0)),
    "crowded_greedy": ([_FACE_A, _FACE_C],
                       [((100, 100), (140, 100)), ((103, 100), (143, 100))],
                       (2, 0, 0)),
    "no_detection": ([_FACE_A, _FACE_B], [], (0, 0, 2)),
    "single_row_truth": ([_FACE_A], [((100.5, 99.0), (140.0, 101.0))],
                         (1, 0, 0)),
}


def _final_evaluators(rows, display_errors=False, as_vector=False):
    truth = {"img.jpg": rows[0] if as_vector else np.stack(rows)}
    return (t_eval.GroundTruthEvaluator(dict(truth),
                                        display_errors=display_errors),
            j_eval.GroundTruthEvaluator(dict(truth),
                                        display_errors=display_errors))


def _assert_same_final(te, je):
    for name in ("true_positives", "false_positives", "false_negatives",
                 "eye_errors", "offending_images"):
        assert getattr(te, name) == getattr(je, name), name


@pytest.mark.parametrize("display_errors", [False, True])
@pytest.mark.parametrize("scene", sorted(_SCENES))
def test_ground_truth_evaluator_matches_jax(scene, display_errors, capsys):
    rows, det_eyes, counts = _SCENES[scene]
    dets = [_Det(*e) for e in det_eyes]
    te, je = _final_evaluators(rows, display_errors,
                               as_vector=scene == "single_row_truth")
    outs = []
    for ev in (te, je):
        ev.record("some/dir/img.jpg", dets, prescale_factor=1.0)
        ev.record("unknown.jpg", dets)                # no truth: ignored
        report = ev.report()
        outs.append((report, capsys.readouterr().out))
    _assert_same_final(te, je)
    assert (te.true_positives, te.false_positives,
            te.false_negatives) == counts
    assert outs[0] == outs[1]                        # report and all prints
    assert outs[0][0].startswith("ground-truth evaluation:")
    assert ("rel_eye_error=" in outs[0][1]) == (display_errors and bool(dets))


def test_ground_truth_evaluator_prescale_and_files_match_jax(tmp_path):
    """Truth read from a file (6-float rows, two faces of one image), with
    a prescaling factor that maps the annotations into the detection
    frame."""
    p = tmp_path / "truth.txt"
    p.write_text("a/img.jpg\n200 200 280 200 240 240\n"
                 "img.jpg\n600 200 680 200 640 240\n"
                 "other.jpg\n50 50 90 50 70 70\n")
    dets = [_Det((100.4, 100.2), (139.8, 99.9)), _Det((301, 99), (339, 101)),
            _Det((20, 20), (30, 20))]
    evs = []
    for mod, kw in ((t_eval, dict(coordinates_filename=str(p))),
                    (j_eval, dict(coordinates_filename=str(p))),
                    (t_eval, dict(true_coordinates_file=str(p))),
                    (j_eval, dict(true_coordinates_file=str(p)))):
        ev = mod.GroundTruthEvaluator.from_files(**kw)
        ev.record("img.jpg", dets, prescale_factor=0.5)
        ev.record("other.jpg", [])
        evs.append(ev)
    for ev in evs[1:]:
        _assert_same_final(evs[0], ev)
        assert ev.report() == evs[0].report()
    assert (evs[0].true_positives, evs[0].false_positives,
            evs[0].false_negatives) == (2, 1, 1)
    assert evs[0].offending_images == ["other.jpg"]


# -- per stage ------------------------------------------------------------------

_PLAN = [("Disc", 1), ("PosX", 0), ("PosY", 0), ("PAng", 0), ("Scale", 0),
         ("Disc", 3), ("Disc", 9)]
_HW = (96, 120)


def _stub_model(geom):
    model = types.SimpleNamespace()
    model.plan = [types.SimpleNamespace(kind=k, serial=s) for k, s in _PLAN]
    model.spec = types.SimpleNamespace(face_geom=geom)
    return model


def _synthetic_case(seed):
    """Truth rows built on three grid windows, and a trace that jitters the
    grid and kills windows stage by stage."""
    cfg = TConfig(bucket_sizes=(256, 1024))
    state, n_real, _ = t_cascade.make_grid_state(_HW[1], _HW[0], TGeometry(),
                                                 cfg)
    grid = state.boxes.numpy()
    n_pad = len(grid)
    assert n_real > 20 and n_pad > n_real
    rng = np.random.RandomState(seed)
    picks = rng.choice(n_real, 3, replace=False)
    rows = []
    for k, pick in enumerate(picks):
        # A face that fills its grid window, with the eyes where the
        # window's eye prior puts them; the third face's annotated eyes lie
        # far from there, so its windows are responsible and wrong.
        x0, y0, x1, y1 = grid[pick]
        side = x1 - x0
        fcx, fcy = (x0 + x1) / 2.0, (y0 + y1) / 2.0
        dx = 18.5 * side / 128.0 / 0.825 + (0.6 * side if k == 2 else 0.0)
        dy = 21.0 * side / 128.0 / 0.825
        rows.append([fcx - dx, fcy - dy, fcx + dx, fcy - dy, fcx, fcy,
                     fcx, fcy + dy, fcx, fcy, x0, y0, x1, y1])
    # A fourth face far too large for the grid's scale envelope.
    rows.append(list(_truth_row(10, 40, 110, 40)))
    trace = []
    boxes = grid.copy()
    mask = np.ones(n_pad, bool)
    mask[n_real:] = False
    for _ in _PLAN:
        boxes = (boxes + rng.uniform(-1.0, 1.0, boxes.shape)
                 ).astype(np.float32)
        mask = mask & (rng.rand(n_pad) < 0.8)
        mask[picks[:2]] = True
        trace.append((boxes.copy(), np.zeros(n_pad, np.float32), mask.copy(),
                      rng.rand(n_pad).astype(np.float32)))
    return np.asarray(rows), trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_per_stage_evaluator_matches_jax(seed, capsys):
    rows, trace = _synthetic_case(seed)
    truth = {"img.jpg": rows}
    cfg_kw = dict(bucket_sizes=(256, 1024))
    te = t_eval.PerStageEvaluator(dict(truth), _stub_model(TGeometry()),
                                  TConfig(**cfg_kw))
    je = j_eval.PerStageEvaluator(dict(truth), _stub_model(JGeometry()),
                                  JConfig(**cfg_kw))
    for ev in (te, je):
        ev.record_image("d/img.jpg", _HW, trace, prescale_factor=1.0)
        ev.record_image("d/img.jpg", _HW, None)        # no trace: ignored
        ev.record_image("unknown.jpg", _HW, trace)     # no truth: ignored
    for name in ("true_positives", "false_positives", "false_negatives",
                 "active_boxes", "num_boxes"):
        np.testing.assert_array_equal(getattr(te, name), getattr(je, name),
                                      err_msg=name)
    assert te.num_faces_seen == je.num_faces_seen == 4
    assert te.offending_images == je.offending_images
    assert te.stage_names == je.stage_names
    for t_errs, j_errs in zip(te.errors, je.errors):
        assert len(t_errs) == len(j_errs)
        if t_errs:
            np.testing.assert_allclose(t_errs, j_errs, rtol=0, atol=1e-6)
    # The case exercises every counter.
    assert te.active_boxes[0] >= 2 and te.true_positives.sum() > 0
    assert te.false_negatives.sum() > 0 and te.false_positives.sum() > 0
    assert any(te.errors[-1]) or any(te.errors[0])
    t_report = te.report()
    t_out = capsys.readouterr().out
    j_report = je.report()
    assert t_report == j_report
    assert t_out == capsys.readouterr().out
    lines = t_report.splitlines()
    assert len([ln for ln in lines if ln.startswith("After ")]) == len(_PLAN)
    assert "After Disc1  :" in t_report and "rel_eye: mean=" in t_report


def test_per_stage_evaluator_from_files_matches_jax(tmp_path):
    rows, trace = _synthetic_case(3)
    p = tmp_path / "truth.txt"
    p.write_text("".join(
        "img.jpg\n" + " ".join(repr(float(v)) for v in r[:8]) + "\n"
        for r in rows))
    te = t_eval.PerStageEvaluator.from_files(
        _stub_model(TGeometry()), TConfig(bucket_sizes=(256, 1024)), str(p))
    je = j_eval.PerStageEvaluator.from_files(
        _stub_model(JGeometry()), JConfig(bucket_sizes=(256, 1024)), str(p))
    np.testing.assert_array_equal(te.truth["img.jpg"], je.truth["img.jpg"])
    for ev in (te, je):
        ev.record_image("img.jpg", _HW, trace, prescale_factor=1.0)
    assert te.report() == je.report()
