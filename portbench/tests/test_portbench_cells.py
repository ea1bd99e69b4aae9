"""Whole runs of the harness on the CPU at a tiny size (``portbench_tiny``):
every cell through the port's plain versions; a configuration, a mix and
a metric added by files alone; the control in the program's place; and
faults planted under the timed path, each of which must read as not
correct."""

import json
import os

import pytest
import torch

from portbench import calibrate, core
from portbench import run as R
from portbench_tiny import cells, tiny_copy

SEED = 2 ** 31 + 17


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    torch.set_num_threads(max(1, min(4, os.cpu_count() or 1)))
    return tiny_copy(str(tmp_path_factory.mktemp("portbench")))


def _run(tiny, cell, seconds=3.0, seed=SEED):
    root, bench = tiny
    if "stream" in cell:                # a batch takes seconds on the CPU
        seconds = 2 * seconds + 2
    return R.run(cell, seed, seconds, False, device="cpu", root=root,
                 bench=bench)


@pytest.mark.parametrize("cell", cells())
def test_cell_rehearsal_on_the_cpu(tiny, cell):
    out = _run(tiny, cell)
    assert out["correct"], out["check"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["sample"]["reference_detections"] > 0
    assert "setup_s" in out["metrics"]
    e2e = {m["name"] for m in R.cell_metrics(
        core.load_json(os.path.join(tiny[0], "BENCHMARK.json")), cell,
        "end_to_end")}
    assert set(out["metrics"]) == e2e
    assert list(out)[-1] == "check"


def test_new_config_mix_and_metric_by_files_alone(tiny, tmp_path):
    root, bench = tiny_copy(str(tmp_path))
    cfg = core.load_json(os.path.join(bench, "configs", "shipped.json"))
    cfg.update(name="coarse")
    cfg["detector"]["smallest_face"] = 0.3
    json.dump(cfg, open(os.path.join(bench, "configs", "coarse.json"), "w"))
    mix = core.load_json(os.path.join(bench, "mixes", "single-5faces.json"))
    mix.update(faces=2, side=[80, 90])
    json.dump(mix, open(os.path.join(bench, "mixes", "single-2faces.json"),
                        "w"))
    with open(os.path.join(bench, "metrics", "faces_per_image.py"),
              "w") as f:
        f.write('def read(ctx):\n    return ctx.faces / ctx.images\n')
    limits = core.load_json(os.path.join(bench, "limits",
                                         "shipped.single.json"))
    json.dump(limits, open(os.path.join(bench, "limits",
                                        "coarse.single.json"), "w"))
    man = core.load_json(os.path.join(root, "BENCHMARK.json"))
    man["configs"].append(dict(man["configs"][0], name="coarse",
                               file="portbench/configs/coarse.json"))
    man["workloads"].append(dict(man["workloads"][0], name="coarse.single",
                                 config="coarse", traffic="single-2faces"))
    for m in man["end_to_end"]:
        if "latency" in m["name"]:
            m["workloads"].append("coarse.single")
    man["per_layer"].append(dict(name="faces_per_image", unit="faces/image",
                                 better="higher", source="program_counter",
                                 layer="Drivers", moves="latency_p50_ms",
                                 workloads=["coarse.single"]))
    json.dump(man, open(os.path.join(root, "BENCHMARK.json"), "w"))
    out = R.run("coarse.single", SEED, 3.0, False, device="cpu", root=root,
                bench=bench)
    assert out["correct"] and "latency_p50_ms" in out["metrics"]
    names = [m["name"] for m in R.cell_metrics(man, "coarse.single",
                                                "per_layer")]
    assert names == ["faces_per_image"]
    reader = core.load_module("metrics", "faces_per_image", bench)

    class Ctx:
        faces, images = 6, 3
    assert reader.read(Ctx) == 2.0


@pytest.mark.parametrize("cell", ["shipped.single", "groupphoto.stream16"])
def test_control_is_not_correct(tiny, cell):
    """The reference one precision step below the configuration, in the
    program's place, fails the cell's limits on every seed."""
    root, bench = tiny
    rows, _ = calibrate.readings(cell, [], [SEED, SEED + 1, SEED + 2], 0,
                                 device="cpu", root=root, bench=bench)
    limits = {k: v["limit"] for k, v in core.load_json(os.path.join(
        bench, "limits", cell + ".json"))["numbers"].items()}
    from portbench.reference import compare
    for row in rows:
        numbers = {k: row[k] for k in compare.NUMBERS}
        assert not compare.judge(numbers, limits), row


def _alter_answer(monkeypatch):
    from pyfaceanalysis_torch.engine import detector
    orig = detector.FaceDetector._assemble_batch

    def altered(self, *a, **kw):
        out = orig(self, *a, **kw)
        for dets in out:
            for d in dets:
                d.box = tuple(v + 4.0 for v in d.box)
                d.eye_left = (d.eye_left[0] + 4.0, d.eye_left[1] + 4.0)
                d.eye_right = (d.eye_right[0] + 4.0, d.eye_right[1] + 4.0)
        return out
    monkeypatch.setattr(detector.FaceDetector, "_assemble_batch", altered)


def _drop_half_batch(monkeypatch):
    from pyfaceanalysis_torch.engine import detector
    orig = detector.FaceDetector._finish_fused

    def half(self, *a, **kw):
        out = orig(self, *a, **kw)
        return out[:len(out) // 2] + [[] for _ in out[len(out) // 2:]]
    monkeypatch.setattr(detector.FaceDetector, "_finish_fused", half)


def _half_batch_heads(monkeypatch):
    """The attribute heads of the second half of each batch's slots read
    the image of a slot in the first half."""
    import numpy as np

    from pyfaceanalysis_torch.engine import heads
    orig = heads.estimate_age_race_gender_multi

    def misread(images, rows, img_idx, *a, **kw):
        half = images.shape[0] // 2
        idx = np.where(img_idx >= half, img_idx - half, img_idx)
        return orig(images, rows, idx, *a, **kw)
    monkeypatch.setattr(heads, "estimate_age_race_gender_multi", misread)


def _stale_step(monkeypatch):
    """The Scale stages hand their rows on unchanged."""
    from pyfaceanalysis_torch.engine import cascade
    orig = cascade._stage_rows

    def stale(st, si, shard, r, *a, **kw):
        keep = (r["boxes"], r["angles"], r["mask"])
        orig(st, si, shard, r, *a, **kw)
        if st.kind == "Scale":
            r["boxes"], r["angles"], r["mask"] = keep
    monkeypatch.setattr(cascade, "_stage_rows", stale)


FAULTS = {"altered_answer": _alter_answer, "half_batch": _drop_half_batch,
          "half_batch_heads": _half_batch_heads, "stale_step": _stale_step}


@pytest.mark.parametrize("cell,fault", [
    ("shipped.stream16", "altered_answer"), ("shipped.stream16", "half_batch"),
    ("shipped.stream16", "half_batch_heads"),
    ("shipped.stream16", "stale_step"), ("shipped.single", "altered_answer"),
    ("shipped.single", "stale_step")])
def test_planted_fault_is_not_correct(tiny, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    out = _run(tiny, cell, seconds=4.0)
    assert out["attempted"] >= 1
    assert not out["correct"], out["check"]


def test_no_card_means_no_result(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, bench = tiny
    with pytest.raises(R.Refused):
        R.run("shipped.single", SEED, 1.0, False, device="cuda", root=root,
              bench=bench)
