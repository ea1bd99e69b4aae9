"""The dispatch's CUDA graphs (``engine/graphs.py``) and the host
round-trips taken out of the dispatch.

On the CPU: which dispatches may go through a graph, that a key is
captured on its second dispatch and replayed after, the cache's bound,
the launch counts of a capture and a replay, the detector's dispatch
through a stand-in graph, the eye pass's per-box select against the host
branch it replaced, and the device tables made once. On the card (marker
``cuda``; ``python -m pytest --noconftest -m cuda tests/test_torch_graphs.py``
on the card's machine, which has no JAX): replayed ``detect`` and fused
``detect_batch`` blocks bit-equal to the eager path on both artifact
directories, with the same kernel launch counts (the layer kernel's
too), and a stream that captures while its helper threads run. Imports no
JAX.
"""

import contextlib
import gc
import os
import sys
import threading
import weakref

import numpy as np
import pytest
import torch
from torch_threads import fair_torch_threads  # noqa: F401  (autouse)

from pyfaceanalysis_torch.config import DetectorConfig, NetGeometry
from pyfaceanalysis_torch.engine import cascade as cascade_mod
from pyfaceanalysis_torch.engine import detector as detector_mod
from pyfaceanalysis_torch.engine import eyes as eyes_mod
from pyfaceanalysis_torch.engine import graphs
from pyfaceanalysis_torch.ops import cuda_crop, cuda_gather, cuda_net_layer
from pyfaceanalysis_torch.ops.patches import (
    extract_patches_rotate,
    sample_patches_pyramid_ref,
)
from pyfaceanalysis_torch.ops.pyramid import build_pyramid, build_pyramid_batch
from pyfaceanalysis_torch.parallel.dryrun import _toy_detector
from pyfaceanalysis_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _images(n, seed=1, hw=(96, 112)):
    rng = np.random.RandomState(seed)
    return [rng.rand(*hw).astype(np.float32) for _ in range(n)]


def _detections(out):
    return [(d.box, d.angle, d.eye_left, d.eye_right, d.confidence, d.age,
             d.race_value, d.gender_value) for d in out]


class _Recorded:
    """A stand-in for ``graphs.capture`` on the CPU: its "graph" runs the
    captured work again over the static input on every replay."""

    def __init__(self):
        self.calls = []

    def __call__(self, inp, work):
        self.calls.append(inp.shape)
        static_in = torch.zeros_like(inp)
        static_out = work(static_in)

        class Replay:
            def replay(self):
                static_out.copy_(work(static_in))

        return graphs.Graph(Replay(), static_in, static_out, (0, 0))


def test_which_dispatches_may_replay(monkeypatch):
    det = _toy_detector(1, device="cpu")
    state, n_real, pyr, _ = det._grid_state(112, 96)
    assert n_real and pyr is not None and det._use_pyramid(pyr)
    assert not det._graphable(pyr)                    # the CPU stays eager
    monkeypatch.setattr(det, "device", torch.device("cuda"))
    assert det._graphable(pyr)
    assert not det._graphable(pyr, track=(0, 0, 10, 10))
    assert not det._graphable(pyr, collect_trace=True)
    assert not det._graphable(None)                   # canvas only
    monkeypatch.setattr(det, "_mesh", object())
    assert not det._graphable(pyr)


def test_a_key_is_captured_on_its_second_dispatch(monkeypatch):
    rec = _Recorded()
    monkeypatch.setattr(graphs, "capture", rec)
    cache = graphs.GraphCache()
    seen = []

    def work(x):
        seen.append(x)
        return x * 2.0

    a, b = torch.ones(3), torch.full((3,), 5.0)
    out, replayed = cache.run("k", a, work)
    assert not replayed and rec.calls == [] and seen == [a]
    assert torch.equal(out, a * 2.0) and len(cache) == 0
    out, replayed = cache.run("k", b, work)        # captured, replayed
    assert not replayed and rec.calls == [(3,)] and len(cache) == 1
    assert torch.equal(out, b * 2.0)
    out2, replayed = cache.run("k", a, work)
    assert replayed and rec.calls == [(3,)]
    assert torch.equal(out2, a * 2.0) and torch.equal(out, b * 2.0)


def test_the_cache_keeps_its_bound_least_recent_out(monkeypatch):
    monkeypatch.setattr(graphs, "capture", _Recorded())
    cache = graphs.GraphCache()
    x = torch.ones(2)
    for key in range(graphs.MAX_GRAPHS):
        cache.run(key, x, torch.neg)
        cache.run(key, x, torch.neg)
    assert len(cache) == graphs.MAX_GRAPHS
    first = weakref.ref(cache._keys[0])
    cache.run(1, x, torch.neg)                     # 0 is now the oldest
    assert cache.run("new", x, torch.neg)[1] is False
    assert len(cache) == graphs.MAX_GRAPHS - 1 and 0 not in cache._keys
    gc.collect()
    assert first() is None                         # its graph is freed
    assert cache.run(0, x, torch.neg)[1] is False  # seen anew: eager
    assert len(cache._keys) == graphs.MAX_GRAPHS


def test_threads_sharing_a_cache_get_their_own_results(monkeypatch):
    monkeypatch.setattr(graphs, "capture", _Recorded())
    cache = graphs.GraphCache()
    wrong, done = [], []

    def client(k):
        x = torch.full((64,), float(k))
        for _ in range(200):
            out, _ = cache.run("k", x, lambda t: t * 2.0)
            if not torch.equal(out, x * 2.0):
                wrong.append(k)
        done.append(k)

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(2 * (os.cpu_count() or 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(before)
    assert not any(t.is_alive() for t in threads)
    assert len(done) == len(threads) and not wrong


def test_a_capture_takes_back_its_launches_and_a_replay_adds_them(
        monkeypatch):
    modes = []

    class Graph:
        def replay(self):
            pass

    class Capture:
        def __init__(self, graph, stream, capture_error_mode):
            modes.append(capture_error_mode)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", Capture)
    monkeypatch.setattr(torch.cuda, "Stream", lambda: None)

    def work(x):
        cuda_crop.KERNEL.launches += 1
        cuda_gather.KERNEL.launches += 7
        cuda_net_layer.KERNEL.launches += 99
        return x + 1.0

    def counts():
        return (cuda_crop.KERNEL.launches, cuda_gather.KERNEL.launches,
                cuda_net_layer.KERNEL.launches)

    before = counts()
    g = graphs.capture(torch.zeros(4), work)
    assert modes == ["thread_local"] and g.launches == (1, 7, 99)
    assert counts() == before
    inp = torch.arange(4.0)
    out = g.replay(inp)
    assert counts() == (before[0] + 1, before[1] + 7, before[2] + 99)
    assert torch.equal(g.static_in, inp) and out is not g.static_out
    assert torch.equal(out, g.static_out)


def test_the_dispatches_through_a_stand_in_graph(monkeypatch, tmp_path):
    torch.manual_seed(0)
    det = _toy_detector(1, device="cpu", mid_compact=32, mid_compact2=16)
    imgs = _images(4)
    want_one = [_detections(det.detect(im)) for im in imgs]
    want_batch = [[_detections(d) for d in det.detect_batch(imgs[:2])],
                  [_detections(d) for d in det.detect_batch(imgs[2:])]]
    assert any(want_one)

    rec = _Recorded()
    monkeypatch.setattr(graphs, "capture", rec)
    monkeypatch.setattr(det, "_graphable", lambda *a, **k: True)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    fresh = profiling.SpanLog()
    monkeypatch.setattr(profiling, "_LOG", fresh)
    with profiling.trace(str(tmp_path)):
        got_one = [_detections(det.detect(im)) for im in imgs]
        got_batch = [[_detections(d) for d in det.detect_batch(b)]
                     for b in (imgs[:2], imgs[2:], imgs[:2])]
    assert got_one == want_one
    assert got_batch == want_batch + want_batch[:1]
    assert rec.calls == [(1000, 1000), (2, 1000, 1000)]
    graph = [s.counts["graph"] for s in fresh.between(0, 1 << 62)
             if s.name == "pfa.dispatch"]
    assert graph == [0, 0, 1, 1, 0, 0, 1]
    assert sum(s.name == "pfa.graph.capture"
               for s in fresh.between(0, 1 << 62)) == 2


def _eye_case(fused, wide):
    torch.manual_seed(3)
    cfg = DetectorConfig(smallest_face=0.3)
    state, n_real, pyr = cascade_mod.make_grid_state(240, 200, NetGeometry(),
                                                     cfg)
    B = 2 if fused else 1
    images = torch.rand(B, 200, 240)
    rng = np.random.RandomState(4)
    n = 12
    x0, y0 = rng.uniform(0, 180, n), rng.uniform(0, 150, n)
    side = rng.uniform(6, 40, n)
    if wide:
        side[5] = 80.0 * max(pyr.scales) + 30.0     # beyond every level
    boxes = torch.tensor(np.stack([x0, y0, x0 + side, y0 + side], 1),
                         dtype=torch.float32)
    angles = torch.tensor(rng.uniform(-15, 15, n), dtype=torch.float32)
    L = len(pyr.scales)
    if fused:
        image = images
        pyramid = build_pyramid_batch(images, pyr.scales, pyr.level_hw)
        scales = torch.tensor(pyr.scales * B, dtype=torch.float32)
        idx = torch.tensor(rng.randint(0, B, n), dtype=torch.int32)
    else:
        image = images[0]
        pyramid = build_pyramid(image, pyr.scales, pyr.level_hw)
        scales = torch.tensor(pyr.scales, dtype=torch.float32)
        idx = None
    return image, boxes, angles, pyramid, scales, idx, L


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("wide", [False, True])
def test_the_eye_select_equals_the_host_branch(fused, wide):
    image, boxes, angles, pyramid, scales, idx, L = _eye_case(fused, wide)
    # The branch it replaced: the flag to the host, the canvas only then.
    bw = torch.abs(boxes[:, 2] - boxes[:, 0]) + 1.0
    if fused:
        levels, no_cover = eyes_mod._eye_levels(scales[:L], bw)
        levels = levels + idx * L
    else:
        levels, no_cover = eyes_mod._eye_levels(scales, bw)
    want = sample_patches_pyramid_ref(pyramid, scales, levels, boxes, angles,
                                      (64, 64), "nearest")
    assert bool(no_cover.any()) == wide
    if bool(no_cover.any()):
        want = torch.where(no_cover[:, None, None], extract_patches_rotate(
            image, boxes, angles, (64, 64), method="nearest",
            image_idx=idx), want)
    got = eyes_mod._eye_patches(image, boxes, angles, (64, 64), pyramid,
                                scales, sample_patches_pyramid_ref, idx,
                                L if fused else 0)
    assert torch.equal(got, want)


def test_scale_tables_and_wire_constants_are_made_once():
    det = _toy_detector(1, device="cpu")
    one = det._grid_state(112, 96)
    assert det._grid_state(112, 96)[3] is one[3]
    assert torch.equal(one[3], torch.tensor(one[2].scales))
    two = det._grid_state(112, 96, batch=3)
    assert det._grid_state(112, 96, batch=3)[3] is two[3]
    assert torch.equal(two[3], torch.tensor(two[2].scales * 3))

    detector_mod._wire_constants.cache_clear()
    block = torch.rand(2, 5, 11) * 900.0
    first = detector_mod._pack_wire(block, 1000)
    assert torch.equal(detector_mod._pack_wire(block, 1000), first)
    info = detector_mod._wire_constants.cache_info()
    assert (info.misses, info.hits) == (1, 1)
    off, scale = detector_mod._wire_affine(11, 16.0)
    assert torch.equal(first, torch.clamp(torch.round(
        (block + torch.as_tensor(off)) * torch.as_tensor(scale)), 0.0,
        65535.0).to(torch.uint16))


# -- on the card --------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _scenes(n, faces, side, seed):
    from portbench.generators import scenes_v1
    mix = {"width": 1000, "height": 800, "faces": faces, "side": side,
           "layout": "free"}
    return scenes_v1.render(mix, seed, n, "cuda")


def _counts():
    return (cuda_crop.KERNEL.launches, cuda_gather.KERNEL.launches,
            cuda_net_layer.KERNEL.launches)


CARD_MODELS = [("SavedNetworksTPU", 0.2, 5, [90, 220]),
               ("SavedNetworksTPU_photo", 0.1, 12, [70, 140])]


@pytest.mark.cuda
@pytest.mark.parametrize("artifacts,smallest,faces,side", CARD_MODELS)
def test_replays_are_bit_equal_to_eager_on_the_card(artifacts, smallest,
                                                    faces, side):
    dev = _card()
    model = detector_mod.DetectionModel.load(os.path.join(ROOT, artifacts),
                                             device=dev)
    cfg = DetectorConfig(smallest_face=smallest)
    det = detector_mod.FaceDetector(model, cfg, device=dev)
    eager = detector_mod.FaceDetector(model, cfg, device=dev)
    eager._graphable = lambda *a, **k: False
    scenes = _scenes(20, faces, side, 4711)

    def same(a, b):
        return torch.equal(a, b) and a.dtype == b.dtype

    # detect: eager, capture, then replays; both detectors per scene.
    for i, img in enumerate(scenes[:5]):
        canvas = det._to_canvas(img)
        c0 = _counts()
        got = det._dispatch_one(canvas, img.shape, False)
        c1 = _counts()
        want = eager._dispatch_one(canvas, img.shape, False)
        c2 = _counts()
        assert same(got, want), f"detect block {i}"
        assert (c1[0] - c0[0], c1[1] - c0[1]) == (
            c2[0] - c1[0], c2[1] - c1[1]) == (1, 7)
        assert c1[2] - c0[2] == c2[2] - c1[2] > 0       # layer kernels
    assert len(det._graphs) == 1
    one = scenes[5]
    assert (_detections(det.detect(one)) == _detections(eager.detect(one))
            and det.detect(one))

    # Fused batches of 2 and 16.
    for B in (2, 16):
        for r in range(4):
            imgs = [scenes[(r * 3 + k) % len(scenes)] for k in range(B)]
            c0 = _counts()
            stack, got = det._dispatch_fused(imgs)
            c1 = _counts()
            _, want = eager._dispatch_fused(imgs, stack=stack)
            c2 = _counts()
            assert same(got, want), f"fused block B={B} round {r}"
            assert (c1[0] - c0[0], c1[1] - c0[1]) == (
                c2[0] - c1[0], c2[1] - c1[1]) == (1, 7)
            assert c1[2] - c0[2] == c2[2] - c1[2] > 0
    assert len(det._graphs) == 3

    # A stream whose second batch captures while the producer converts
    # and copies and the finisher pulls.
    batches = [scenes[k:k + 16] for k in (0, 4, 2, 3, 1, 4)]
    fresh = detector_mod.FaceDetector(model, cfg, device=dev)
    got = [[_detections(d) for d in b] for b in fresh.detect_stream(
        iter(batches), depth=3)]
    want = [[_detections(d) for d in b] for b in eager.detect_stream(
        iter(batches), depth=3)]
    assert got == want and sum(len(d) for b in got for d in b) > 0
    assert len(fresh._graphs) == 1
