"""The attribute heads' face buckets and CUDA graphs (``engine/heads.py``).

On the CPU: the bucket rule against the JAX package's (read from its
source, not imported), padded heads against heads over exactly the N
faces on the shipped ``net_age``, padding rows that reach no real face's
output, no faces, and the graph path through a stand-in capture (eager
on a key's first call, captured on its second, replayed after) with the
``graph`` and ``bucket`` counts of ``pfa.heads``. On the card (marker
``cuda``; ``python -m pytest --noconftest -m cuda
tests/test_torch_heads_graph.py`` on the card's machine, which has no
JAX): replayed heads bit-equal to eager heads at the same bucket on both
artifact directories. Imports no JAX.
"""

import contextlib
import os
import re
import types

import numpy as np
import pytest
import torch
from torch_threads import fair_torch_threads  # noqa: F401  (autouse)

from pyfaceanalysis_torch.config import DetectorConfig
from pyfaceanalysis_torch.engine import detector as detector_mod
from pyfaceanalysis_torch.engine import graphs
from pyfaceanalysis_torch.engine import heads
from pyfaceanalysis_torch.parallel.dryrun import _toy_detector
from pyfaceanalysis_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOREVER = 1 << 62


@pytest.fixture(scope="module")
def shipped():
    return detector_mod.DetectionModel.load(
        os.path.join(ROOT, "SavedNetworksTPU"), device="cpu")


def _stack(seed=0, b=2, hw=(300, 360)):
    rng = np.random.RandomState(seed)
    return torch.tensor(rng.rand(b, *hw).astype(np.float32))


def _faces(n, seed=1, b=2):
    """(n, 10) detection rows whose eyes lie inside a (300, 360) image,
    and their image indices."""
    rng = np.random.RandomState(seed)
    cx, cy = rng.uniform(80, 280, n), rng.uniform(80, 220, n)
    d, tilt = rng.uniform(18, 40, n), rng.uniform(-0.2, 0.2, n)
    rows = np.zeros((n, 10))
    rows[:, 0:4] = np.stack([cx - 2 * d, cy - 2 * d, cx + 2 * d,
                             cy + 2 * d], 1)
    rows[:, 5:9] = np.stack([cx - d / 2, cy - d * tilt, cx + d / 2,
                             cy + d * tilt], 1)
    rows[:, 9] = 0.5
    return rows, rng.randint(0, b, n)


def _exact(model, stack, rows, idx, tta):
    """The heads over exactly the N faces (no padding)."""
    centers, angles, sfs = heads._frame_arrays(rows)
    return heads._arg_forward(
        model.nets["net_age"],
        (model.clf_input_dim("Age"), model.clf_input_dim("Race"),
         model.clf_input_dim("Gender")),
        stack, model.classifier("Age"), model.classifier("Race"),
        model.classifier("Gender"), torch.tensor(centers),
        torch.tensor(angles), torch.tensor(sfs), torch.tensor(idx),
        torch.tensor(heads._tta_offsets(tta))).numpy()


def _jax_bucket(n):
    src = open(os.path.join(ROOT, "pyfaceanalysis_tpu", "engine",
                            "heads.py")).read()
    (rule,) = re.findall(r"^\s*bucket = (.+)$", src, re.M)
    return eval(rule, {"n": n})


@pytest.mark.parametrize("n,want", [(1, 4), (4, 4), (5, 8), (8, 8),
                                    (9, 16), (12, 16), (80, 128),
                                    (190, 256)])
def test_the_bucket_is_the_jax_packages(n, want):
    assert heads._bucket(n) == _jax_bucket(n) == want


@pytest.mark.parametrize("tta", [1, 3])
@pytest.mark.parametrize("n", [1, 5, 12, 80])
def test_padded_heads_equal_exact_heads(shipped, n, tta):
    """Every real face's outputs within 1e-5 of each output's scale: the
    CPU's GEMM may order a product otherwise at another row count."""
    stack = _stack()
    rows, idx = _faces(n)
    got = heads.estimate_age_race_gender_multi(stack, rows, idx, shipped,
                                               tta=tta)
    want = _exact(shipped, stack, rows, idx, tta)
    for g, w in zip(got, want):
        assert g.shape == (n,) and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


def test_padding_rows_reach_no_real_face(shipped, monkeypatch):
    stack = _stack()
    rows, idx = _faces(5)
    clean = heads.estimate_age_race_gender_multi(stack, rows, idx, shipped,
                                                 tta=3)
    table = heads._face_table

    def spoiled(rows, img_idx, bucket):
        out = table(rows, img_idx, bucket)
        out[len(rows):, 0] = np.nan                  # NaN centre
        out[len(rows):, 2] = 1e4                     # wild angle
        out[len(rows):, 3] = 1e30                    # huge sf
        return out

    monkeypatch.setattr(heads, "_face_table", spoiled)
    got = heads.estimate_age_race_gender_multi(stack, rows, idx, shipped,
                                               tta=3)
    for g, w in zip(got, clean):
        np.testing.assert_array_equal(g, w)


def test_no_faces_give_empty_results(shipped):
    cache = graphs.GraphCache()
    for kw in ({}, {"graph_cache": cache}):
        out = heads.estimate_age_race_gender_multi(
            _stack(), np.zeros((0, 10)), np.zeros(0, np.int64), shipped,
            **kw)
        assert len(out) == 4 and all(len(a) == 0 for a in out)
    assert len(cache._keys) == 0


class _Recorded:
    """A stand-in for ``graphs.capture`` on the CPU: its "graph" runs the
    captured work again over the static inputs on every replay."""

    def __init__(self):
        self.calls = []

    def __call__(self, inp, work):
        self.calls.append(tuple(tuple(x.shape) for x in inp))
        static_in = tuple(torch.zeros_like(x) for x in inp)
        static_out = work(*static_in)

        class Replay:
            def replay(self):
                static_out.copy_(work(*static_in))

        return graphs.Graph(Replay(), static_in, static_out, (0, 0))


@pytest.fixture
def stand_in(monkeypatch):
    """The stand-in capture, no card context, and spans recorded into a
    fresh log as if a profiler session ran (without its cost)."""
    rec = _Recorded()
    monkeypatch.setattr(graphs, "capture", rec)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    log = profiling.SpanLog()
    monkeypatch.setattr(profiling, "_LOG", log)
    monkeypatch.setattr(profiling, "_autograd_profiler",
                        types.SimpleNamespace(_is_profiler_enabled=True))
    return rec, log


def test_heads_are_captured_on_a_keys_second_call(shipped, stand_in):
    rec, log = stand_in
    stack = _stack()
    calls = [_faces(5, seed=1), _faces(7, seed=2), _faces(5, seed=3),
             _faces(3, seed=4), _faces(6, seed=5)]
    want = [heads.estimate_age_race_gender_multi(stack, r, i, shipped)
            for r, i in calls]
    before = len(log.between(0, FOREVER))
    cache = graphs.GraphCache()
    got = [heads.estimate_age_race_gender_multi(stack, r, i, shipped,
                                                graph_cache=cache)
           for r, i in calls]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert rec.calls == [((2, 300, 360), (8, 5))] and len(cache) == 1
    spans = [s.counts for s in log.between(0, FOREVER)[before:]
             if s.name == "pfa.heads"]
    assert spans == [{"faces": n, "bucket": b, "graph": g} for n, b, g in
                     [(5, 8, 0), (7, 8, 0), (5, 8, 1), (3, 4, 0),
                      (6, 8, 1)]]


def _detections(out):
    return [(d.box, d.angle, d.eye_left, d.eye_right, d.confidence, d.age,
             d.age_std, d.race_value, d.gender_value) for d in out]


def test_the_detectors_heads_through_a_stand_in_graph(stand_in):
    rec, log = stand_in
    torch.manual_seed(0)
    det = _toy_detector(1, device="cpu", mid_compact=32, mid_compact2=16)
    assert det._head_graphs is None                # the CPU stays eager
    rng = np.random.RandomState(1)
    imgs = [rng.rand(96, 112).astype(np.float32) for _ in range(3)]
    want = [_detections(det.detect(im)) for im in imgs]
    assert all(want)
    det._head_graphs = graphs.GraphCache()
    before = len(log.between(0, FOREVER))
    got = [_detections(det.detect(im)) for im in imgs]
    assert got == want
    assert [s.counts["graph"] for s in log.between(0, FOREVER)[before:]
            if s.name == "pfa.heads"] == [0, 0, 1]
    assert len(rec.calls) == 1 and len(det._head_graphs) == 1


# -- on the card --------------------------------------------------------------


CARD_MODELS = [("SavedNetworksTPU", 0.2, 5, [90, 220]),
               ("SavedNetworksTPU_photo", 0.1, 12, [70, 140])]


@pytest.mark.cuda
@pytest.mark.parametrize("artifacts,smallest,faces,side", CARD_MODELS)
def test_replayed_heads_are_bit_equal_to_eager_on_the_card(
        monkeypatch, artifacts, smallest, faces, side):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    from portbench.generators import scenes_v1
    dev = torch.device("cuda")
    model = detector_mod.DetectionModel.load(os.path.join(ROOT, artifacts),
                                             device=dev)
    det = detector_mod.FaceDetector(
        model, DetectorConfig(smallest_face=smallest), device=dev)
    scenes = scenes_v1.render({"width": 1000, "height": 800,
                               "faces": faces, "side": side,
                               "layout": "free"}, 4711, 8, "cuda")
    # The heads' inputs of a single photo and of two fused batches.
    seen = []
    orig = heads.estimate_age_race_gender_multi

    def record(images, rows, img_idx, *a, **kw):
        seen.append((images.clone(), rows.copy(), img_idx.copy()))
        return orig(images, rows, img_idx, *a, **kw)

    monkeypatch.setattr(heads, "estimate_age_race_gender_multi", record)
    det.detect(scenes[0])
    det.detect_batch(scenes[:4])
    det.detect_batch(scenes[4:])
    assert len(seen) == 3 and all(len(r) for _, r, _ in seen)

    for images, rows, idx in seen:
        # A second input of the same key: the faces reversed over the
        # stack rolled by one image.
        other = (torch.roll(images, 1, 0), rows[::-1].copy(),
                 (idx[::-1] + 1) % images.shape[0])
        want = [orig(*x, model) for x in ((images, rows, idx), other)]
        cache = graphs.GraphCache()
        for k in range(4):       # eager, capture, replay, replay
            got = orig(*((images, rows, idx), other)[k % 2], model,
                       graph_cache=cache)
            for a, b in zip(got, want[k % 2]):
                assert np.array_equal(a, b), (artifacts, k)
        assert len(cache) == 1
