"""PyTorch port vs the JAX package: calibration, selection, the trainer's
pipeline and ``apps.train``.

- The host-side calibration and selection functions equal the JAX
  package's exactly on the inputs of tests/test_training_selection.py.
- ``collect_image`` on the shipped artifacts and one rendered scene (the
  same image on both sides, float32 operands): the same covered and
  converged counts, per-face confidences within 1e-4 (readings 1e-7) and
  the first rung's background windows within 1e-4; later rungs' background
  windows drift through the nearest re-sampling of refined boxes (ROADMAP.md
  section 3), so 95% of them must be common and 60% of those within 1e-4.
- A tiny ``train_pipeline`` on the port alone (the sizes of
  tests/test_trained_pipeline.py or smaller, two calibration scenes, the
  disc-seed selection branch with one seed): every artifact is written,
  the directory loads in both packages with 22 classifiers, the port's
  detector runs on it, and ``reuse`` reloads the networks unchanged.
- ``apps.train`` parses every switch into the TrainConfig JAX's tool
  builds; ``--data_mesh=2`` reaches the trainer and trains the tiny
  pipeline on a 2-device CPU mesh; no card raises.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from torch_draws import fair_torch_threads  # noqa: F401 (autouse)

from pyfaceanalysis_torch.apps import train as t_app
from pyfaceanalysis_torch.training import calibration as t_cal
from pyfaceanalysis_torch.training import selection as t_sel
from pyfaceanalysis_torch.training import trainer as t_tr
from pyfaceanalysis_tpu.apps import train as j_app
from pyfaceanalysis_tpu.training import calibration as j_cal
from pyfaceanalysis_tpu.training import selection as j_sel
from pyfaceanalysis_tpu.training import trainer as j_tr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "SavedNetworksTPU")
CONF_ATOL = 1e-4
# Background windows past the first rung (see test_collect_image_matches_jax).
BG_SHARE = 0.95
BG_AGREE = 0.6



def _quiet(*a, **k):
    pass


# --- host-side calibration and selection -------------------------------------

def _bg_images(seed):
    rng = np.random.RandomState(seed)
    idx = np.arange(40)
    return [{1: (rng.rand(40), idx), 3: (rng.rand(40), idx)}
            for _ in range(10)]


@pytest.mark.parametrize("budget,protect", [(5.0, ()), (0.01, ()),
                                            (5.0, (3,)), (0.2, (3,)),
                                            (0.5, (1, 3))])
def test_cap_ladder_and_background_rate(budget, protect):
    serials = [1, 3]
    ref = [0.0, 0.2, 0.0, 0.2] + [0.0] * 6
    face = [0.0, 0.8, 0.0, 0.8] + [0.0] * 6
    bg = _bg_images(0 if not protect else 1)
    assert (t_cal.background_rate(face, bg, serials)
            == j_cal.background_rate(face, bg, serials))
    got = t_cal.cap_ladder(face, bg, serials, budget, ref=ref, log=_quiet,
                           protect=protect)
    want = j_cal.cap_ladder(face, bg, serials, budget, ref=ref, log=_quiet,
                            protect=protect)
    assert got == want
    # the default reference is the config's constant ladder
    assert (t_cal.cap_ladder(face, bg, serials, budget, log=_quiet)
            == j_cal.cap_ladder(face, bg, serials, budget, log=_quiet))


def test_anchor_passes():
    rng = np.random.RandomState(3)
    image = rng.rand(400, 500).astype(np.float32)
    rows = np.array([
        [100.0, 100.0, 180.0, 100.0, 140.0, 100.0, 140.0, 140.0,
         0, 0, 0, 0, 0, 0],
        [200.0, 200.0, 320.0, 200.0, 260.0, 200.0, 260.0, 260.0,
         0, 0, 0, 0, 0, 0]])
    for img, rw, targets in ((image, rows, (25.0, 95.0, 200.0)),
                             (image[:70, :90], rows[:1] * 0.2, (2.0,))):
        got = t_cal.anchor_passes(img, rw, targets)
        want = j_cal.anchor_passes(img, rw, targets)
        assert len(got) == len(want)
        for (gi, gr), (wi, wr) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gr, wr)


@pytest.mark.parametrize("protect", [(), (9,)])
def test_write_calibration(tmp_path, protect):
    result = {"cut_offs_face": [0.99, 0.95, 0.9, 0.8, 0.7, 0.6, 0.5, 0.45,
                                0.1, 0.31234567],
              "tolerance_xy_eye": 10.5, "bg_protect": list(protect)}
    texts = []
    for mod, sub in ((t_cal, "t"), (j_cal, "j")):
        d = tmp_path / sub
        d.mkdir()
        (d / "manifest.json").write_text(json.dumps(
            {"calibration": {"last_cut_off_face": 0.2012345}}))
        mod.write_calibration(str(d), result, verbose=False)
        texts.append((d / "manifest.json").read_text())
    assert texts[0] == texts[1]


def test_select_and_tns_gate():
    def cand(recall, fp, a_tp=3, a_fp=10, a_fn=0):
        return {"recall": recall, "fp_per_image": fp,
                "anchors": {"tp": a_tp, "fp": a_fp, "fn": a_fn}}
    for scores in ([cand(0.90, 0.2, a_fn=1), cand(0.80, 0.6),
                    cand(0.78, 0.4)],
                   [cand(0.85, 1.2), cand(0.75, 0.5)],
                   [cand(0.80, 0.5, a_fp=15), cand(0.78, 0.5, a_fp=9)],
                   [cand(0.60, 0.1), cand(0.70, 2.0)],
                   [cand(0.9, 0.1, a_tp=2), cand(0.9, 0.1, a_fn=2)],
                   [{"recall": 0.8, "fp_per_image": 0.3}]):
        assert (t_sel.select(scores, recall_floor=0.73, verbose=False)
                == j_sel.select(scores, recall_floor=0.73, verbose=False))
    for tns in (None, {"tp": 4, "fp": 2, "fn": 4}, {"tp": 3, "fp": 0,
                                                     "fn": 5},
                {"tp": 6, "fp": 3, "fn": 2}):
        assert t_sel.tns_gate(tns) == j_sel.tns_gate(tns)


# --- collect_image on the shipped artifacts ----------------------------------

def test_collect_image_matches_jax():
    from pyfaceanalysis_torch.config import DetectorConfig as TCfg
    from pyfaceanalysis_torch.engine import detector as t_det
    from pyfaceanalysis_torch.io.writers import truth_row_from_landmarks
    from pyfaceanalysis_torch.training import synth
    from pyfaceanalysis_torch.training.sampler import Sampler
    from pyfaceanalysis_tpu.config import DetectorConfig as JCfg
    from pyfaceanalysis_tpu.engine import detector as j_det

    img, attrs = synth.render_face(Sampler(1), canvas_hw=(200, 200),
                                   face_size=110.0, center=(100.0, 100.0),
                                   angle_deg=0.0, attr_cues="v2")
    img = img.numpy()
    el, er, mo = (attrs[k].numpy() for k in ("eye_l", "eye_r", "mouth"))
    row = np.asarray(truth_row_from_landmarks(
        el[0], el[1], er[0], er[1], (el[0] + er[0]) / 2,
        (el[1] + er[1]) / 2, mo[0], mo[1]))
    kw = dict(smallest_face=0.15, cut_offs_face=(2.0,) * 10,
              last_cut_off_face=2.0, matmul_dtype="f32")
    jm = j_det.DetectionModel.load(ART)
    jd = j_det.FaceDetector(jm, JCfg(**kw))
    tm = t_det.DetectionModel.load(ART, device="cpu")
    td = t_det.FaceDetector(tm, TCfg(**kw), device="cpu")
    want = j_cal.collect_image(jd, img, row, jd.config, jm)
    got = t_cal.collect_image(td, img, row, td.config, tm)
    assert got[2:4] == want[2:4] == (1, 1)
    assert [sorted(d) for d in got[0]] == [sorted(d) for d in want[0]]
    for g, w in zip(got[0], want[0]):
        for s in w:
            assert abs(g[s] - w[s]) <= CONF_ATOL, (s, g[s], w[s])
    # Background windows: the first rung reads the pyramid crops, equal on
    # both sides; later rungs read re-sampled refined boxes, where the
    # nearest drift moves wandering windows. Readings, rungs 3/5/7/9: common
    # windows 1.0/1.0/0.988/0.988, confidences within 1e-4 on 0.963/0.865/
    # 0.758/0.724 of them.
    assert sorted(got[1]) == sorted(want[1])
    first = min(want[1])
    np.testing.assert_array_equal(got[1][first][1], want[1][first][1])
    np.testing.assert_allclose(got[1][first][0], want[1][first][0], rtol=0,
                               atol=CONF_ATOL)
    for s in want[1]:
        g, w = dict(zip(*got[1][s][::-1])), dict(zip(*want[1][s][::-1]))
        both = set(g) & set(w)
        assert len(both) >= BG_SHARE * max(len(g), len(w)), s
        agree = sum(abs(g[i] - w[i]) <= CONF_ATOL for i in both)
        assert agree >= BG_AGREE * len(both), (s, agree, len(both))
    np.testing.assert_allclose(got[4], want[4], rtol=0, atol=1e-3)


# --- the tiny pipeline -------------------------------------------------------

TINY = dict(num_faces=8, steps_per_face=8, disc_faces=8, disc_steps=8,
            eye_faces=8, eye_steps=8, age_samples=40,
            train_final_disc=False, real_frac=0.0, real_bg_frac=0.0,
            calib_scenes=2, selection_scenes=1, disc_seeds=(5,))


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tiny") / "trained")
    t_tr.train_pipeline(out, t_tr.TrainConfig(**TINY), verbose=False,
                        device="cpu")
    return out


def test_tiny_pipeline_artifacts(tiny_dir):
    names = {n for _, n, c, _ in t_tr._STAGE_LAYOUT if n != "None0"}
    names |= {c for _, _, c, _ in t_tr._STAGE_LAYOUT}
    for name in names:
        assert os.path.exists(os.path.join(tiny_dir, name + ".npz")), name
    assert os.path.exists(os.path.join(tiny_dir, "Pipeline_tpu.txt"))
    calib = json.load(open(os.path.join(tiny_dir, "manifest.json")))[
        "calibration"]
    assert len(calib["cut_offs_face"]) == 10
    assert calib["last_cut_off_face"] == calib["cut_offs_face"][9]
    assert "tolerance_xy_eye" in calib
    sel = json.load(open(os.path.join(tiny_dir, "disc_selection.json")))
    assert sel["seeds"] == [5] and sel["selected_seed"] == 5
    # the candidate was scored on the port's fused detect_batch; the
    # anchors stay out while their photos are missing
    score = sel["scores"][0]
    assert score["scenes"] == 1 and 0.0 <= score["recall"] <= 1.0
    assert ("anchors" in score) == (t_cal.anchor_photos(
        "data/train_faces_gt.txt") is not None)
    assert not sel["tns_gate"]["evaluated"] or "result" in sel["tns_gate"]
    assert os.path.isdir(os.path.join(tiny_dir, "_cand_disc_5"))


def test_tiny_pipeline_loads_in_both_packages(tiny_dir):
    from pyfaceanalysis_torch.config import DetectorConfig
    from pyfaceanalysis_torch.engine import detector as t_det
    from pyfaceanalysis_tpu.engine import detector as j_det

    jm = j_det.DetectionModel.load(tiny_dir)
    tm = t_det.DetectionModel.load(tiny_dir, device="cpu")
    assert len(jm.classifiers) == len(tm.classifiers) == 22
    assert jm.calibration == tm.calibration
    det = t_det.FaceDetector(tm, DetectorConfig(smallest_face=0.4),
                             device="cpu")
    res = det.detect(np.random.RandomState(0).rand(120, 120)
                     .astype(np.float32))
    assert isinstance(res, list)


def test_reuse_reloads_the_networks(tiny_dir, tmp_path):
    import shutil

    from pyfaceanalysis_torch.io import artifacts
    out = str(tmp_path / "again")
    shutil.copytree(tiny_dir, out)
    before = {n: artifacts.load_network(os.path.join(out, n + ".npz"))
              for n in ("net_pose0", "net_eye", "net_age", "net_disc")}
    cfg = t_tr.TrainConfig(**{**TINY, "disc_seeds": (), "calibrate": False})
    t_tr.train_pipeline(out, cfg, verbose=False,
                        reuse=("pose", "eye", "age", "disc"), device="cpu")
    for n, net in before.items():
        again = artifacts.load_network(os.path.join(out, n + ".npz"))
        for a, b in zip(net.params, again.params):
            assert torch.equal(a.W, b.W) and torch.equal(a.mean, b.mean)
    calib = json.load(open(os.path.join(out, "manifest.json")))[
        "calibration"]
    assert "cut_offs_face" not in calib and "last_cut_off_face" in calib


# --- entry points ------------------------------------------------------------

def test_data_mesh_and_missing_card_raise(tmp_path, monkeypatch):
    """``apps.train --data_mesh=2`` hands 2 to train_pipeline, and a mesh of
    two cards raises, naming the count, where fewer exist (the JAX
    make_mesh would shrink the mesh). No card: every entry point raises."""
    out = str(tmp_path / "x")
    seen = {}
    monkeypatch.setattr(t_tr, "train_pipeline",
                        lambda out_dir, cfg, data_mesh=0, **kw:
                        seen.update(data_mesh=data_mesh, **kw))
    assert t_app.main(["--out_dir", out, "--data_mesh=2",
                       "--device=cpu"]) == 0
    assert seen == dict(data_mesh=2, reuse=(), device="cpu")
    monkeypatch.undo()
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < 2:
        from pyfaceanalysis_torch.parallel.mesh import make_mesh
        with pytest.raises(RuntimeError, match=f"asked for 2 CUDA devices "
                                               f"and found {count}"):
            make_mesh(2, device="cuda")
    assert not os.path.exists(out)
    if torch.cuda.is_available():
        return                      # the missing-card half needs no card
    for call in (lambda: t_tr.train_pipeline(out, verbose=False),
                 lambda: t_tr.train_pipeline(out, device="cuda"),
                 lambda: t_app.main(["--out_dir", out, "--quick"]),
                 lambda: t_cal.calibrate_model(ART, scenes=1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not os.path.exists(out)


def test_tiny_pipeline_on_a_data_mesh(tiny_dir, tmp_path):
    """``apps.train --data_mesh=2 --device=cpu`` at the tiny sizes trains
    every network on a 2-device CPU mesh: the directory loads with 22
    classifiers and each network computes the unsharded run's features
    (canonical correlations of the first five, as tests/test_parallel.py
    holds its mesh trainer)."""
    from pyfaceanalysis_torch.engine import detector as t_det
    out = str(tmp_path / "mesh")
    argv = ["--out_dir", out, "--data_mesh=2", "--device=cpu",
            "--no_calibrate", "--no_final_disc", "--real_frac=0",
            "--real_bg_frac=0"] + [f"--{k}={TINY[k]}" for k in (
                "num_faces", "steps_per_face", "age_samples")]
    assert t_app.main(argv) == 0
    mesh_model = t_det.DetectionModel.load(out, device="cpu")
    plain = t_det.DetectionModel.load(tiny_dir, device="cpu")
    assert len(mesh_model.classifiers) == 22
    rng = np.random.RandomState(4)
    for name in ("net_pose0", "net_eye"):
        x = torch.from_numpy(rng.rand(200, 64 * 64).astype(np.float32))
        with torch.no_grad():
            a = plain.nets[name](x).numpy()[:, :5]
            b = mesh_model.nets[name](x).numpy()[:, :5]
        q = [np.linalg.qr((f - f.mean(0)) / (f.std(0) + 1e-9))[0]
             for f in (a, b)]
        cc = np.linalg.svd(q[0].T @ q[1], compute_uv=False)
        assert cc.mean() > 0.98 and cc.min() > 0.9, (name, cc)


ARGVS = [
    [],
    ["--quick"],
    ["--quick", "--calib_scenes=3", "--selection_scenes=40", "--seed=7",
     "--no_final_disc"],
    ["--num_faces=30", "--steps_per_face=7", "--age_samples=99",
     "--age_jitter_px=2.5", "--age_jitter_scale=0.01", "--seed=3",
     "--no_final_disc", "--reuse=pose,eye", "--real_frac=0.1",
     "--real_bg_frac=0.2", "--real_gt_file=gt.txt", "--pose_classes=33",
     "--disc_node=sfa", "--pose_node=igsfa", "--eye_node=igsfa",
     "--pose_head=ridge", "--mined_negatives=m.txt", "--mined_frac=0.7",
     "--attr_cues=v3", "--disc_seeds=4,5,6", "--selection_scenes=12",
     "--no_calibrate", "--calib_scenes=9", "--texture_noise=0.05",
     "--texture_noise_bg=0.08", "--disc_graph=serial",
     "--age_real_frac=0.25", "--age_real_exclude=a.png",
     "--calib_bg_budget=2.5", "--calib_anchor_small_ie=20, 30",
     "--calib_bg_protect=5,7,9", "--data_mesh=0"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_main_parses_like_jax(monkeypatch, argv):
    seen = {}

    def capture(tag):
        def fake(out_dir, cfg, reuse=(), data_mesh=0, **kw):
            seen[tag] = (out_dir, dataclasses.asdict(cfg), tuple(reuse),
                         data_mesh)
        return fake
    monkeypatch.setattr(j_app, "enable_persistent_compilation_cache",
                        lambda: None)
    monkeypatch.setattr(j_tr, "train_pipeline", capture("jax"))
    monkeypatch.setattr(t_tr, "train_pipeline", capture("torch"))
    argv = ["--out_dir", "somewhere", *argv]
    assert j_app.main(argv) == 0
    assert t_app.main(argv + ["--device=cpu"]) == 0
    assert seen["torch"] == seen["jax"]
    assert set(dataclasses.asdict(t_tr.TrainConfig())) == set(
        dataclasses.asdict(j_tr.TrainConfig()))
    assert dataclasses.asdict(t_tr.TrainConfig()) == dataclasses.asdict(
        j_tr.TrainConfig())
