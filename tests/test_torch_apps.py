"""PyTorch port vs the JAX package: the command-line layer.

``apps.detect`` (all switches, single-image and batch mode, evaluation,
side outputs), ``apps.normalize``, ``apps.frgc``, ``apps.camera``,
``utils``, ``parallel.multihost`` and ``viz``, on the CPU
(``--device=cpu``), against the JAX package's tools on the same files.

The two command lines have no switch for the operand type of the cascade
products, and on the CPU the packages compare only at float32 operands
(XLA's CPU compiler may drop the bf16 operand rounding inside a jitted
program; see tests/test_torch_detect.py). The end-to-end tests therefore
run both tools with a ``DetectorConfig`` whose ``matmul_dtype`` defaults to
"f32"; everything else is what the tools build from their switches.
"""

import dataclasses
import functools
import os
import socket
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch
from test_detector import random_artifact_dir  # noqa: F401  (fixture)
from test_torch_batch import SCENES
from test_torch_detect import _scene
from torch_threads import fair_torch_threads  # noqa: F401  (autouse)

from pyfaceanalysis_torch import viz as t_viz
from pyfaceanalysis_torch.apps import camera as t_camera
from pyfaceanalysis_torch.apps import detect as t_detect
from pyfaceanalysis_torch.apps import frgc as t_frgc
from pyfaceanalysis_torch.apps import normalize as t_normalize
from pyfaceanalysis_torch.config import DetectorConfig as TConfig
from pyfaceanalysis_torch.engine import detector as t_detector
from pyfaceanalysis_torch.io import images as t_images
from pyfaceanalysis_torch.io import writers as t_writers
from pyfaceanalysis_torch.normalization import frame_params
from pyfaceanalysis_torch.parallel import multihost as t_multihost
from pyfaceanalysis_torch.utils import benchmark as t_benchmark
from pyfaceanalysis_torch.utils import compile_cache as t_compile_cache
from pyfaceanalysis_torch.utils import profiling as t_profiling
from pyfaceanalysis_tpu import viz as j_viz
from pyfaceanalysis_tpu.apps import camera as j_camera
from pyfaceanalysis_tpu.apps import detect as j_detect
from pyfaceanalysis_tpu.apps import frgc as j_frgc
from pyfaceanalysis_tpu.apps import normalize as j_normalize
from pyfaceanalysis_tpu.config import DetectorConfig as JConfig
from pyfaceanalysis_tpu.utils import benchmark as j_benchmark

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "SavedNetworksTPU")

# Every long option of the JAX tool with a value that differs from its
# default, plus the short form of --batch.
_SWITCHES = {
    "batch": "--batch={batch}", "-b": "-b {batch}",
    "smallest_face": "--smallest_face=0.35",
    "right_screen_eye_first": "--right_screen_eye_first",
    "display_errors": "--display_errors=1",
    "display_plots": "--display_plots=1",
    "coordinates_filename": "--coordinates_filename=truth8.txt",
    "true_coordinates_file": "--true_coordinates_file=truth6.txt",
    "skip_existing_output": "--skip_existing_output=1",
    "write_results": "--write_results=0",
    "adaptive_grid_scale": "--adaptive_grid_scale=0",
    "adaptive_grid_coords": "--adaptive_grid_coords=false",
    "save_patches": "--save_patches=1",
    "network_figures_together": "--network_figures_together=1",
    "last_cut_off_face": "--last_cut_off_face=0.4",
    "cut_offs_face": "--cut_offs_face=.9,.8,.7,.6,.5,.4,.3,.2,.1,.05",
    "write_age_race_gender_confidence":
        "--write_age_race_gender_confidence=0",
    "show_final_detection": "--show_final_detection=1",
    "camera_enabled": "--camera_enabled=1",
    "track_single_face": "--track_single_face=1",
    "pygame_display": "--pygame_display=1",
    "estimate_age_race_gender": "--estimate_age_race_gender=0",
    "image_prescaling": "--image_prescaling=0",
    "save_normalized_face_detections": "--save_normalized_face_detections=1",
    "pipeline_dir": "--pipeline_dir=some/dir",
    "verbose": "--verbose=0",
    "distributed": "--distributed=1",
    "coordinator": "--coordinator=127.0.0.1:9",
    "num_processes": "--num_processes=2",
    "process_id": "--process_id=1",
    "profile_dir": "--profile_dir={tmp}/profile",
    "data_mesh": "--data_mesh=4",
    "batch_mode": "--batch_mode=async",
    "arg_tta": "--arg_tta=3",
    "eye_iters": "--eye_iters=2",
    "stream_depth": "--stream_depth=5",
    "wire_format": "--wire_format=f32",
    "arg_eyes": "--arg_eyes=refined",
    "eye_report": "--eye_report=pass1",
}


def test_switch_table_covers_every_long_option():
    assert len(j_detect._LONG_OPTS) == 38
    assert sorted(o.rstrip("=") for o in j_detect._LONG_OPTS) == sorted(
        k for k in _SWITCHES if k != "-b")
    assert t_detect._LONG_OPTS == j_detect._LONG_OPTS + ["device="]


def _recorded_main(module, argv, monkeypatch):
    calls = []

    def recorder(image_filenames, output_filenames, cfg, **kw):
        calls.append((list(image_filenames), list(output_filenames),
                      dataclasses.asdict(cfg), kw))
        return 0

    monkeypatch.setattr(module, "run_detection", recorder)
    assert module.main(argv) == 0
    assert len(calls) == 1
    return calls[0]


@pytest.mark.parametrize("switch", sorted(_SWITCHES))
def test_switch_builds_the_same_run_as_jax(switch, tmp_path, monkeypatch,
                                           capsys):
    """The same argv through both ``main``s: the same image and output
    lists, ``DetectorConfig`` fields and ``run_detection`` keywords."""
    batch = tmp_path / "batch.txt"
    batch.write_text("a.png\na.txt\nb.png\nb.txt\nc.png\nc.txt\n")
    arg = _SWITCHES[switch].format(batch=batch, tmp=tmp_path)
    argv = arg.split(" ")
    if switch not in ("batch", "-b"):
        argv += ["image.png", "rows.txt"]
    t_call = _recorded_main(t_detect, argv, monkeypatch)
    t_out = capsys.readouterr().out
    j_call = _recorded_main(j_detect, argv, monkeypatch)
    j_out = capsys.readouterr().out
    assert t_call[3].pop("device") is None
    assert t_call == j_call
    assert {f.name for f in dataclasses.fields(TConfig)} == set(t_call[2])
    assert t_out == j_out                      # notices, [distributed] line
    # The switch changed something that reaches the run (the three
    # rendezvous values and the profile directory act inside main()).
    baseline = _recorded_main(t_detect, ["image.png", "rows.txt"],
                              monkeypatch)
    baseline[3].pop("device")
    inert = {"coordinator", "num_processes", "process_id", "profile_dir",
             "distributed", "camera_enabled", "pygame_display",
             "network_figures_together"}
    assert (t_call != baseline) == (switch not in inert)
    if switch == "distributed":
        assert "[distributed] process 0/1: 1 image(s)" in t_out
    if switch == "profile_dir":
        assert os.listdir(tmp_path / "profile")


def test_device_switch_reaches_run_detection(monkeypatch):
    call = _recorded_main(t_detect, ["--device=cpu", "i.png"], monkeypatch)
    assert call[3]["device"] == "cpu" and call[1] == ["i.txt"]


@pytest.mark.parametrize("argv, rc, printed", [
    (["--cut_offs_face=1,2,3", "i.png", "o.txt"], 2,
     "cut_offs_face needs 10"),
    ([], 0, "Usage (either A or B):"),
    (["--no_such_switch=1", "i.png", "o.txt"], 2, "Error parsing options"),
    (["a", "b", "c"], 0, "--write_age_race_gender_confidence=0/1"),
])
def test_parse_outcomes_match_jax(argv, rc, printed, capsys):
    for module in (t_detect, j_detect):
        assert module.main(list(argv)) == rc
        assert printed in capsys.readouterr().out


def test_usage_keeps_every_switch_line():
    """The port's usage text is the JAX tool's, switch line for switch
    line; only the lines that name the framework differ."""
    j_lines = j_detect.USAGE.splitlines()
    t_lines = t_detect.USAGE.splitlines()
    differing = [ln for ln in j_lines if ln not in t_lines]
    assert len(differing) == 5 and all(
        any(w in ln for w in ("TPU", "jax", "ICI")) for ln in differing)
    for opt in t_detect._LONG_OPTS:
        assert "--" + opt.rstrip("=") in t_detect.USAGE or opt == "verbose="
    assert not any(w in t_detect.USAGE for w in ("TPU-native", "jax",
                                                 "xplane"))
    assert "PyTorch/CUDA" in t_detect.USAGE


# -- the tool end to end ----------------------------------------------------------

def _force_f32(monkeypatch_like):
    monkeypatch_like.setattr(t_detect, "DetectorConfig",
                             functools.partial(TConfig, matmul_dtype="f32"))
    monkeypatch_like.setattr(j_detect, "DetectorConfig",
                             functools.partial(JConfig, matmul_dtype="f32"))


def _parse_rows(path):
    rows = []
    with open(path) as f:
        for line in f:
            assert line.endswith(" \n")
            rows.append([v.strip() for v in line[:-2].split(",")])
    return rows


def _assert_rows_agree(t_path, j_path):
    """Integer columns within 1 (a rounding boundary), float columns within
    1e-4, age (one decimal) within 0.1, labels equal."""
    t_rows, j_rows = _parse_rows(t_path), _parse_rows(j_path)
    assert len(t_rows) == len(j_rows) > 0
    for t, j in zip(t_rows, j_rows):
        assert len(t) == len(j) == 13
        for col in (0, 1, 2, 3, 5, 6, 7, 8):
            assert abs(int(t[col]) - int(j[col])) <= 1, (col, t, j)
        for col in (4, 12):
            assert abs(float(t[col]) - float(j[col])) <= 1e-4, (col, t, j)
        assert abs(float(t[9]) - float(j[9])) <= 0.1 + 1e-9
        assert t[10:12] == j[10:12]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both tools once in single-image mode (with side outputs) and once in
    batch mode, on rendered scenes saved as PNG."""
    root = tmp_path_factory.mktemp("cli")
    paths = {}
    for seed in (3,) + SCENES:
        paths[seed] = str(root / f"scene{seed}.png")
        t_images.save_image(paths[seed], _scene(seed))
    mp = pytest.MonkeyPatch()
    _force_f32(mp)
    runs = {"root": root, "paths": paths}
    try:
        for name, module in (("torch", t_detect), ("jax", j_detect)):
            work = root / name
            work.mkdir()
            mp.chdir(work)
            common = ["--wire_format=f32", "--verbose=0",
                      "--pipeline_dir=" + ART]
            if name == "torch":
                common.append("--device=cpu")
            assert module.main(common + [
                "--save_patches=1", "--save_normalized_face_detections=1",
                paths[3], "single.txt"]) == 0
            batch = "".join(f"{paths[s]}\nbatch{s}.txt\n" for s in SCENES)
            (work / "batch.txt").write_text(batch)
            assert module.main(common + ["--batch=batch.txt"]) == 0
            runs[name] = work
    finally:
        mp.undo()
    return runs


@pytest.fixture(scope="module")
def port_detector():
    model = t_detector.DetectionModel.load(ART, device="cpu")
    return t_detector.FaceDetector(
        model, TConfig(matmul_dtype="f32", wire_format="f32"), device="cpu")


def test_cli_single_image_matches_jax_and_own_detect(cli_runs, port_detector,
                                                     tmp_path):
    _assert_rows_agree(cli_runs["torch"] / "single.txt",
                       cli_runs["jax"] / "single.txt")
    image, factor = t_images.load_image(cli_runs["paths"][3], 1000)
    assert factor == 1.0
    own = str(tmp_path / "own.txt")
    t_writers.write_detections(own, port_detector.detect(image))
    with open(own, "rb") as a, open(cli_runs["torch"] / "single.txt",
                                    "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("folder, prefix", [
    ("saved_patches", "patch_im000_"),
    ("normalized_face_detections", "EyeN_im000_")])
def test_cli_side_outputs_match_jax(cli_runs, folder, prefix):
    """One file per detection in each folder; the decoded JPEGs of the two
    tools differ by less than half a grey level on average."""
    t_dir, j_dir = cli_runs["torch"] / folder, cli_runs["jax"] / folder
    names = sorted(os.listdir(t_dir))
    assert names == sorted(os.listdir(j_dir))
    assert len(names) == len(_parse_rows(cli_runs["torch"] / "single.txt"))
    assert all(n.startswith(prefix) and n.endswith(".jpg") for n in names)
    for n in names:
        a, _ = t_images.load_image(str(t_dir / n), None)
        b, _ = t_images.load_image(str(j_dir / n), None)
        assert a.shape == b.shape == ((64, 64) if "patch" in n
                                      else (192, 256))
        assert a.std() > 0.02
        assert np.abs(a - b).mean() * 255 < 0.5


def test_cli_batch_mode_matches_jax_and_own_detect_batch(cli_runs,
                                                         port_detector,
                                                         tmp_path):
    images = [t_images.load_image(cli_runs["paths"][s], 1000)[0]
              for s in SCENES]
    own = port_detector.detect_batch(images)
    assert [len(d) for d in own] == [2, 1, 1]
    for s, dets in zip(SCENES, own):
        _assert_rows_agree(cli_runs["torch"] / f"batch{s}.txt",
                           cli_runs["jax"] / f"batch{s}.txt")
        path = str(tmp_path / f"own{s}.txt")
        t_writers.write_detections(path, dets)
        with open(path, "rb") as a, open(
                cli_runs["torch"] / f"batch{s}.txt", "rb") as b:
            assert a.read() == b.read()


@pytest.fixture(scope="module")
def small_artifacts(random_artifact_dir):  # noqa: F811
    """The random-weight artifact directory and one image that yields
    detections there (a cutoff ladder that rejects nothing)."""
    rng = np.random.RandomState(5)
    return random_artifact_dir, rng.rand(100, 120).astype(np.float32)


_SMALL = ["--device=cpu", "--smallest_face=0.4", "--wire_format=f32",
          "--cut_offs_face=" + ",".join(["1.01"] * 10)]


def _small_run(tmp_path, small_artifacts, extra, n_images=1, monkeypatch=None):
    art, image = small_artifacts
    names = []
    for k in range(n_images):
        names.append(str(tmp_path / f"im{k}.png"))
        if not os.path.exists(names[-1]):
            t_images.save_image(names[-1], image)
    argv = _SMALL + ["--pipeline_dir=" + art] + extra
    if n_images == 1:
        argv += [names[0], str(tmp_path / "out0.txt")]
    else:
        (tmp_path / "batch.txt").write_text("".join(
            f"{n}\n{tmp_path}/out{k}.txt\n" for k, n in enumerate(names)))
        argv += ["--batch=" + str(tmp_path / "batch.txt")]
    return t_detect.main(argv)


@pytest.mark.parametrize("n_images", [1, 2])
def test_cli_appends_to_its_output_files(tmp_path, small_artifacts, n_images,
                                         capsys):
    assert _small_run(tmp_path, small_artifacts, [], n_images) == 0
    first = [(tmp_path / f"out{k}.txt").read_bytes() for k in range(n_images)]
    assert all(first)
    out = capsys.readouterr().out
    assert ("batch: 2 image(s)" in out) == (n_images == 2)
    assert "Loaded networks and classifiers" in out      # Benchmark table
    assert _small_run(tmp_path, small_artifacts, [], n_images) == 0
    for k in range(n_images):
        assert (tmp_path / f"out{k}.txt").read_bytes() == first[k] * 2


def test_cli_batch_summary_counts_the_last_chunks_windows(tmp_path,
                                                         small_artifacts,
                                                         capsys):
    """The batch summary adds the last chunk's ``windows_scanned`` (all its
    images' windows) once per image, as the JAX tool does."""
    assert _small_run(tmp_path, small_artifacts, [], 3) == 0
    out = capsys.readouterr().out
    art, image = small_artifacts
    det = t_detector.FaceDetector(
        t_detector.DetectionModel.load(art, device="cpu"),
        TConfig(smallest_face=0.4), device="cpu")
    det.detect_batch([image] * 3, estimate_attributes=False)
    assert f"{3 * det.windows_scanned} windows in" in out


def test_cli_skips_existing_output(tmp_path, small_artifacts, capsys):
    (tmp_path / "out0.txt").write_text("kept\n")
    assert _small_run(tmp_path, small_artifacts,
                      ["--skip_existing_output=1"]) == 0
    assert (tmp_path / "out0.txt").read_text() == "kept\n"
    assert "(output exists)" in capsys.readouterr().out
    assert _small_run(tmp_path, small_artifacts,
                      ["--skip_existing_output=0", "--verbose=0"]) == 0
    assert (tmp_path / "out0.txt").read_text().startswith("kept\n")
    assert len((tmp_path / "out0.txt").read_text().splitlines()) > 1


def test_cli_write_results_off_and_eye_order(tmp_path, small_artifacts):
    assert _small_run(tmp_path, small_artifacts, ["--write_results=0"]) == 0
    assert not (tmp_path / "out0.txt").exists()
    assert _small_run(tmp_path, small_artifacts, []) == 0
    plain = _parse_rows(tmp_path / "out0.txt")
    os.remove(tmp_path / "out0.txt")
    assert _small_run(tmp_path, small_artifacts,
                      ["--right_screen_eye_first",
                       "--write_age_race_gender_confidence=0"]) == 0
    swapped = _parse_rows(tmp_path / "out0.txt")
    assert len(swapped) == len(plain) > 0
    for p, s in zip(plain, swapped):
        assert len(p) == 13 and len(s) == 9
        assert s[5:9] == p[7:9] + p[5:7] and s[:5] == p[:5]


def test_cli_missing_pipeline_directory_returns_1(tmp_path, capsys):
    for module, extra in ((t_detect, ["--device=cpu"]), (j_detect, [])):
        rc = module.main(extra + ["--pipeline_dir=" + str(tmp_path / "none"),
                                  "i.png", str(tmp_path / "o.txt")])
        assert rc == 1
        assert "not found" in capsys.readouterr().out
    # Known before the card is asked for: the same answer without --device.
    assert t_detect.main(["--pipeline_dir=" + str(tmp_path / "none"),
                          "i.png"]) == 1


def test_cli_defaults_to_the_card(tmp_path, small_artifacts):
    """No --device means cuda: without a card the tool raises, it does not
    move to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    art, _ = small_artifacts
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_detect.main(["--pipeline_dir=" + art, "i.png",
                       str(tmp_path / "o.txt")])
    assert not (tmp_path / "o.txt").exists()


def test_cli_data_mesh_names_the_queue_item(tmp_path, small_artifacts):
    """The data mesh is ported (the name is kept from when the switch
    raised): ``--data_mesh=2 --device=cpu`` writes the bytes the tool
    writes without the switch."""
    assert _small_run(tmp_path, small_artifacts, []) == 0
    plain = (tmp_path / "out0.txt").read_bytes()
    (tmp_path / "out0.txt").unlink()
    assert _small_run(tmp_path, small_artifacts, ["--data_mesh=2"]) == 0
    assert plain and (tmp_path / "out0.txt").read_bytes() == plain


def test_cli_evaluation_reports(tmp_path, small_artifacts, capsys):
    """--coordinates_filename turns both evaluators on beside the detector:
    a truth file written from the tool's own detections gives as many true
    positives as detections, and one per-stage line per plan stage."""
    assert _small_run(tmp_path, small_artifacts, ["--verbose=0"]) == 0
    rows = _parse_rows(tmp_path / "out0.txt")
    assert rows
    with open(tmp_path / "truth.txt", "w") as f:
        for r in rows:
            elx, ely, erx, ery = (float(v) for v in r[5:9])
            mx = (elx + erx) / 2.0
            my = (ely + ery) / 2.0 + (erx - elx) * 42.0 / 37.0
            f.write(f"im0.png\n{elx} {ely} {erx} {ery} {mx} "
                    f"{(ely + my) / 2} {mx} {my}\n")
    capsys.readouterr()
    assert _small_run(tmp_path, small_artifacts, [
        "--verbose=0", "--write_results=0", "--display_errors=1",
        "--coordinates_filename=" + str(tmp_path / "truth.txt")]) == 0
    out = capsys.readouterr().out
    assert f"  true positives:  {len(rows)}\n" in out
    assert "  false positives: 0\n" in out
    assert "  false negatives: 0\n" in out
    assert out.count("-> TP") == len(rows)
    assert len([ln for ln in out.splitlines()
                if ln.startswith("After ")]) == 17
    assert out.index("per-stage ground-truth") < out.index(
        "ground-truth evaluation:")


def test_cli_plots_and_profile(tmp_path, small_artifacts, monkeypatch,
                               capsys):
    monkeypatch.chdir(tmp_path)
    assert _small_run(tmp_path, small_artifacts, [
        "--display_plots=1", "--show_final_detection=1",
        "--profile_dir=" + str(tmp_path / "prof")]) == 0
    out = capsys.readouterr().out
    assert "wrote cascade trace plot: cascade_trace_000.png" in out
    assert "wrote final detection plot: final_detection_000.png" in out
    assert os.path.getsize(tmp_path / "cascade_trace_000.png") > 10_000
    assert os.path.getsize(tmp_path / "final_detection_000.png") > 10_000
    traces = os.listdir(tmp_path / "prof")
    assert len(traces) == 1 and traces[0].endswith(".json")


# -- apps.normalize, apps.frgc, apps.camera ----------------------------------------

def _decoded(pattern, n):
    return [t_images.load_image(pattern % k, None)[0] for k in range(n)]


@pytest.mark.parametrize("mode", sorted(t_normalize._MODES))
def test_normalize_mode_matches_jax(tmp_path, mode, capsys):
    """Each mode through both tools, PNG outputs: the same number of files
    and decoded pixels within one grey level."""
    assert sorted(t_normalize._MODES) == sorted(j_normalize._MODES)
    img_path = str(tmp_path / "face.png")
    t_images.save_image(img_path, np.random.RandomState(1).rand(200, 200))
    coords = tmp_path / "coords.txt"
    coords.write_text(f"{img_path}\n70 90 110 94 90 130\n"
                      f"{img_path}\n70 90 72 90 71 95\n")   # eyes < 5 px
    outs = []
    for name, main, extra in (("t", t_normalize.main, ["--device", "cpu"]),
                              ("j", j_normalize.main, [])):
        pattern = str(tmp_path / name / "out%03d.png")
        assert main([str(coords), pattern, mode, "--out_width", "48",
                     "--out_height", "40", "--seed", "7"] + extra) == 0
        printed = capsys.readouterr().out
        outs.append((pattern, printed))
    assert outs[0][1] == outs[1][1]
    n = 10 if mode == "background" else 1
    assert f"wrote {n} normalized images" in outs[0][1]
    assert "skipping" in outs[0][1]
    for pattern, _ in outs:
        assert not os.path.exists(pattern % n)
    want_hw = {"mid_eyes_inferred-mouthZ4_horiz": (260, 256),
               "mid_eyes_inferred-mouthZ4_horiz-Test": (20, 17)}.get(
                   mode, (40, 48))
    for a, b in zip(_decoded(outs[0][0], n), _decoded(outs[1][0], n)):
        assert a.shape == b.shape == want_hw
        assert np.abs(a - b).max() * 255 <= 1.0 + 1e-6


def test_normalize_random_background_matches_jax_inside_the_frame(tmp_path):
    """--background=random: both tools draw the frame's position and the
    noise seed from the same ``RandomState``, but the noise itself from
    their own generators, so the pixels are compared inside the source
    frame only; outside it both hold noise, not black."""
    img_path = str(tmp_path / "face.png")
    t_images.save_image(img_path, np.random.RandomState(2).rand(120, 160))
    coords = tmp_path / "coords.txt"
    coords.write_text(f"{img_path}\n20 40 60 40 40 60 40 80\n")
    size = (128, 96)
    outs = []
    for name, main, extra in (("t", t_normalize.main, ["--device=cpu"]),
                              ("j", j_normalize.main, [])):
        pattern = str(tmp_path / name / "out%03d.png")
        assert main([str(coords), pattern, "mid_eyes_mouth_horiz",
                     "--out_width", str(size[0]), "--out_height",
                     str(size[1]), "--background", "random"] + extra) == 0
        outs.append(_decoded(pattern, 1)[0])
    fp = frame_params((20, 40, 60, 40, 40, 80), "eyes_mouth_area",
                      "mid_eyes_mouth", "EyeLineRotation", out_size=size)
    X = (np.arange(size[0]) - (size[0] - 1) / 2.0) * fp.sf
    Y = (np.arange(size[1]) - (size[1] - 1) / 2.0) * fp.sf
    assert fp.angle_deg == 0.0
    sx, sy = fp.center_x + X[None, :] + 0 * Y[:, None], \
        fp.center_y + Y[:, None] + 0 * X[None, :]
    inside = (sx > 0.5) & (sx < 158.5) & (sy > 0.5) & (sy < 118.5)
    outside = (sx < -0.5) | (sx > 159.5) | (sy < -0.5) | (sy > 119.5)
    assert inside.sum() > 2000 and outside.sum() > 2000
    assert np.abs(outs[0] - outs[1])[inside].max() * 255 <= 1.0 + 1e-6
    for out in outs:
        assert out[outside].std() > 0.2 and (out[outside] > 0).mean() > 0.9
    assert np.abs(outs[0] - outs[1])[outside].mean() > 0.1


def _frgc_files(tmp_path):
    rng = np.random.RandomState(2)
    images = tmp_path / "images"
    images.mkdir()
    for name in ("img1.png", "img2.png"):
        t_images.save_image(str(images / name), rng.rand(300, 300))
    meta = tmp_path / "meta.xml"
    meta.write_text("""<Metadata>
  <Recording recording_id="r1">
    <LeftEyeCenter x="120" y="140"/>
    <RightEyeCenter x="170" y="144"/>
    <Mouth x="145" y="195"/>
  </Recording>
  <Recording recording_id="r2">
    <LeftEyeCenter x="100" y="120"/>
    <RightEyeCenter x="140" y="118"/>
  </Recording>
  <Recording recording_id="r4">
    <Mouth x="1" y="1"/>
  </Recording>
</Metadata>""")
    sig = tmp_path / "sig.xml"
    sig.write_text("""<Signatures>
  <Presentation name="r1" file-name="img1.png"/>
  <Presentation name="r2" file-name="img2.png"/>
  <Presentation name="r3" file-name="img3.png"/>
  <Presentation name="r4" file-name="img1.png"/>
</Signatures>""")
    return str(meta), str(sig), str(images)


def test_frgc_matches_jax(tmp_path, capsys):
    meta, sig, images = _frgc_files(tmp_path)
    assert (t_frgc.load_frgc_coordinate_data(meta)
            == j_frgc.load_frgc_coordinate_data(meta))
    assert (t_frgc.load_frgc_biometric_signatures([sig])
            == j_frgc.load_frgc_biometric_signatures([sig]))
    outs = []
    for name, main, extra in (("t", t_frgc.main, ["--device=cpu"]),
                              ("j", j_frgc.main, [])):
        pattern = str(tmp_path / name / "face%03d.png")
        assert main([meta, sig, "--image_dir", images, "--out_pattern",
                     pattern, "--out_width", "128", "--out_height", "96"]
                    + extra) == 0
        outs.append((pattern, capsys.readouterr().out))
    assert outs[0][1] == outs[1][1]
    assert "3 annotated recordings, 4 signatures, 3 matched" in outs[0][1]
    assert "wrote 2 normalized crops" in outs[0][1]
    for a, b in zip(_decoded(outs[0][0], 2), _decoded(outs[1][0], 2)):
        assert a.shape == b.shape == (96, 128) and a.std() > 0.02
        assert np.abs(a - b).max() * 255 <= 1.0 + 1e-6
    img = np.random.RandomState(3).rand(60, 60).astype(np.float32)
    assert t_frgc.process_image_facecenter(img, {"Mouth": (1.0, 1.0)},
                                           device="cpu") is None


class _FakePygame(types.ModuleType):
    """The few pygame calls of the camera loop, on a seeded frame."""

    QUIT = 256

    def __init__(self, cameras, frame):
        super().__init__("pygame")
        self.frames_shown = 0
        self.stopped = False
        surf = object()
        cam = types.SimpleNamespace(start=lambda: None,
                                    stop=lambda: setattr(self, "stopped", True),
                                    get_image=lambda: surf)
        self.camera = types.ModuleType("pygame.camera")
        self.camera.init = lambda: None
        self.camera.list_cameras = lambda: list(cameras)
        self.camera.Camera = lambda device, size: cam
        screen = types.SimpleNamespace(blit=lambda s, pos: None)

        def flip():
            self.frames_shown += 1

        self.display = types.SimpleNamespace(
            set_mode=lambda size: screen, set_caption=lambda s: None,
            flip=flip)
        self.surfarray = types.SimpleNamespace(
            array3d=lambda s: frame.swapaxes(0, 1))
        self.draw = types.SimpleNamespace(rect=lambda *a: None,
                                          circle=lambda *a: None)
        self.event = types.SimpleNamespace(get=lambda: [])
        self.init = lambda: None
        self.quit = lambda: None


def _install_pygame(monkeypatch, fake):
    monkeypatch.setitem(sys.modules, "pygame", fake)
    monkeypatch.setitem(sys.modules, "pygame.camera",
                        None if fake is None else fake.camera)


def test_camera_without_pygame_or_camera_matches_jax(monkeypatch, capsys):
    _install_pygame(monkeypatch, None)
    outs = []
    for module in (t_camera, j_camera):
        assert module.main([]) == 1
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "pygame is not installed" in outs[0]
    _install_pygame(monkeypatch, _FakePygame([], None))
    assert t_camera.main([]) == 1
    assert capsys.readouterr().out == "error: no camera found\n"


def test_camera_loop_detects_with_tracking(monkeypatch, small_artifacts,
                                           capsys):
    art, image = small_artifacts
    frame = np.repeat((image * 255).astype(np.uint8)[:, :, None], 3, axis=2)
    fake = _FakePygame(["/dev/video0"], frame)
    _install_pygame(monkeypatch, fake)
    made = []
    real = t_detector.FaceDetector

    def spy(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    monkeypatch.setattr(t_detector, "FaceDetector", spy)
    assert t_camera.main(["--compute_device=cpu", "--pipeline_dir=" + art,
                          "--smallest_face=0.4", "--width=120",
                          "--height=100", "--max_frames=10"]) == 0
    assert fake.frames_shown == 10 and fake.stopped
    assert "FPS:" in capsys.readouterr().out
    det, = made
    assert det.device.type == "cpu" and det.config.track_single_face
    assert not det.config.estimate_age and det.windows_scanned > 0


# -- utils ----------------------------------------------------------------------

def test_benchmark_display_matches_jax(monkeypatch, capsys):
    outs = []
    for module in (t_benchmark, j_benchmark):
        ticks = iter(np.arange(0.0, 100.0, 0.125))
        monkeypatch.setattr(time, "time", lambda: float(next(ticks)))
        b = module.Benchmark(enabled=True)
        for _ in range(3):
            b.update_start_time()
            b.add_task_from_previous_time("Image loaded or captured")
            b.add_task_from_previous_time("Full detection pass")
        b.set_default_reference("networks")
        b.add_task_from_previous_time("x" * 70, reference="networks")
        outs.append((b.display(), b.items(), capsys.readouterr().out))
        off = module.Benchmark(enabled=False)
        off.add_task_from_previous_time("ignored")
        assert off.display() == "(benchmark disabled)" and off.items() == []
    assert outs[0] == outs[1]
    assert outs[0][1][0] == ("Image loaded or captured", 0.375, 3)
    assert "x" * 60 + " " in outs[0][0] and "x" * 61 not in outs[0][0]


def test_maybe_trace_writes_a_trace_and_reraises(tmp_path):
    log_dir = tmp_path / "trace"
    with t_profiling.maybe_trace(str(log_dir)):
        with t_profiling.annotate("cascade"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    first = os.listdir(log_dir)
    assert len(first) == 1 and first[0].endswith(".json")
    assert '"cascade"' in (log_dir / first[0]).read_text()
    with pytest.raises(KeyError, match="from the body"):
        with t_profiling.maybe_trace(str(log_dir)):
            raise KeyError("from the body")
    assert len(os.listdir(log_dir)) == 2         # the trace is still written
    with t_profiling.maybe_trace(None):          # no directory: a no-op
        pass
    assert len(os.listdir(log_dir)) == 2


def test_trace_runs_unprofiled_when_the_profiler_cannot_start(
        tmp_path, monkeypatch, capsys):
    import torch.profiler

    def broken(**kw):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    ran = []
    with t_profiling.trace(str(tmp_path / "t")):
        ran.append(1)
    assert ran == [1]
    assert "trace unavailable (no profiler here)" in capsys.readouterr().out
    with pytest.raises(ZeroDivisionError):
        with t_profiling.trace(str(tmp_path / "t")):
            1 / 0


def test_compile_cache_builds_only_for_the_card():
    assert t_compile_cache.enable_persistent_compilation_cache("cpu") is False
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_compile_cache.enable_persistent_compilation_cache()


# -- parallel.multihost -------------------------------------------------------------

def test_shard_work_strided_disjoint_complete():
    items = [f"im{i}" for i in range(10)]
    shards = [t_multihost.shard_work(items, k, 3) for k in range(3)]
    assert shards[0] == ["im0", "im3", "im6", "im9"]
    assert sorted(sum(shards, [])) == sorted(items)
    imgs = [f"i{k}.jpg" for k in range(5)]
    outs = [f"o{k}.txt" for k in range(5)]
    assert t_multihost.shard_batch_files(imgs, outs, 1, 2) == (
        ["i1.jpg", "i3.jpg"], ["o1.txt", "o3.txt"])


def test_initialize_single_process_identity():
    import torch.distributed as dist

    assert t_multihost.initialize() == (0, 1)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="--process_id"):
        t_multihost.initialize("127.0.0.1:9", 2)
    assert not dist.is_initialized()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_CHILD = """
import sys
import torch.distributed as dist
from pyfaceanalysis_torch.parallel import multihost
pid, nproc = multihost.initialize('127.0.0.1:%d', 2, int(sys.argv[1]),
                                  timeout_s=%f)
try:
    assert nproc == 2 and pid == int(sys.argv[1]), (pid, nproc)
    assert multihost.initialize() == (pid, nproc)     # the group that is up
    imgs = [f'i{k}.jpg' for k in range(5)]
    outs = [f'o{k}.txt' for k in range(5)]
    si, so = multihost.shard_batch_files(imgs, outs, pid, nproc)
    open(sys.argv[2], 'w').write('\\n'.join(si))
finally:
    dist.destroy_process_group()
"""


def _children(tmp_path, ranks, timeout_s):
    prog = _CHILD % (_free_port(), timeout_s)
    env = dict(os.environ, PYTHONPATH=REPO)
    outfiles = [str(tmp_path / f"shard{k}.txt") for k in ranks]
    procs = [subprocess.Popen([sys.executable, "-c", prog, str(k), out],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE)
             for k, out in zip(ranks, outfiles)]
    results = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            results.append((p.returncode, err.decode()[-2000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results, outfiles


def test_initialize_two_process_gloo_rendezvous(tmp_path):
    """A real two-process gloo rendezvous on localhost: each process learns
    its rank, takes its shard of a 5-image batch and destroys the group."""
    results, outfiles = _children(tmp_path, (0, 1), 60.0)
    for rc, err in results:
        assert rc == 0, err
    shards = [open(f).read().split() for f in outfiles]
    assert shards == [["i0.jpg", "i2.jpg", "i4.jpg"], ["i1.jpg", "i3.jpg"]]


def test_initialize_rendezvous_times_out(tmp_path):
    """A process whose partner never comes raises after its timeout; it
    does not hang."""
    t0 = time.time()
    (result,), outfiles = _children(tmp_path, (0,), 2.0)
    assert result[0] != 0 and "Timed out" in result[1]
    assert time.time() - t0 < 60 and not os.path.exists(outfiles[0])


# -- viz ------------------------------------------------------------------------

def test_plot_functions_write_files_like_jax(tmp_path):
    rng = np.random.RandomState(0)
    image = rng.rand(80, 100).astype(np.float32)
    n = 30
    trace = []
    for k in range(20):                        # more stages than panels
        xy = rng.uniform(0, 60, (n, 2))
        boxes = np.concatenate([xy, xy + 20], axis=1).astype(np.float32)
        trace.append((boxes, np.zeros(n, np.float32), rng.rand(n) < 0.5,
                      rng.rand(n).astype(np.float32)))
    names = [f"Stage{k}" for k in range(20)]
    dets = [t_detector.Detection(
        box=(10.0, 12.0, 50.0, 52.0), angle=2.0, eye_left=(22.0, 28.0),
        eye_right=(38.0, 28.5), confidence=0.1, age=30.0, age_std=2.0,
        race_value=1.5, gender_value=-0.5),
        t_detector.Detection(box=(40.0, 30.0, 70.0, 60.0), angle=0.0,
                             eye_left=(50.0, 40.0), eye_right=(60.0, 40.0),
                             confidence=0.4)]
    sizes = {}
    for name, viz in (("t", t_viz), ("j", j_viz)):
        a = str(tmp_path / f"{name}_trace.png")
        b = str(tmp_path / f"{name}_final.png")
        c = str(tmp_path / f"{name}_final_rgb.png")
        assert viz.plot_cascade_trace(image, trace, names, a) == a
        assert viz.plot_final_detections(image, dets, b) == b
        assert viz.plot_final_detections(image, dets, c,
                                         rgb=rng.rand(80, 100, 3) * 0 + 0.5
                                         ) == c
        sizes[name] = [t_images.load_image(p, None)[0].shape
                       for p in (a, b, c)]
    assert sizes["t"] == sizes["j"]
    ta, _ = t_images.load_image(str(tmp_path / "t_trace.png"), None)
    ja, _ = t_images.load_image(str(tmp_path / "j_trace.png"), None)
    np.testing.assert_array_equal(ta, ja)


def test_plot_functions_without_matplotlib(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert t_viz.plot_final_detections(np.zeros((4, 4)), [], "x.png") is None
    assert t_viz.plot_cascade_trace(np.zeros((4, 4)), [], [], "x.png") is None
    assert capsys.readouterr().out.count("matplotlib unavailable") == 2
    assert not os.path.exists("x.png")
