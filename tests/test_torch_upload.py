"""The image upload (``engine/upload.py``): host rows to the canvas.

On the CPU: the canvas of one image and of a batch, float32 and float64,
bit-equal to numpy's rounding (``np.clip(x * 255.0, 0, 255)`` truncated to
uint8, over 255 in float32), on values in [-0.5, 1.5], on each k/255 and
its neighbours one ulp away, below the canvas and growing it; other
dtypes and mixed batches rounding on the host; ``detect`` equal to a
dispatch of numpy's canvas; the ``pfa.upload`` span's counts; and the
staging ring's order of copies, events and waits through stand-ins for
the card's streams and events, over more batches than it has slots. On
the card (marker ``cuda``; ``python -m pytest --noconftest -m cuda
tests/test_torch_upload.py`` on the card's machine, which has no JAX):
canvases bit-equal to the benchmark's plain reference, a ``detect_stream``
of depth 3 over ten batches equal to ``detect_batch`` one batch at a
time, pinned staging slots, and ``pinned`` 1 on every upload of a traced
stream. Imports no JAX.
"""

import contextlib
import os
import types

import numpy as np
import pytest
import torch
from torch_threads import fair_torch_threads  # noqa: F401  (autouse)

from pyfaceanalysis_torch.config import DetectorConfig
from pyfaceanalysis_torch.engine import detector as detector_mod
from pyfaceanalysis_torch.engine import upload
from pyfaceanalysis_torch.parallel.dryrun import _toy_detector
from pyfaceanalysis_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOREVER = 1 << 62


def _numpy_canvas(images, H, W):
    """The canvas as numpy rounds it: the detector's conversion before the
    upload rounded on the device, and the reference's."""
    u8 = np.stack([np.clip(np.asarray(im) * 255.0, 0, 255).astype(np.uint8)
                   for im in images])
    h, w = u8.shape[-2:]
    canvas = torch.zeros((len(images), H, W), dtype=torch.uint8)
    canvas[:, :h, :w] = torch.from_numpy(u8)
    return canvas.to(torch.float32) / 255.0


def _values(dtype, n, seed):
    """``n`` values: every k/255 and its neighbours one ulp away, then
    uniform draws in [-0.5, 1.5], shuffled."""
    k = np.arange(256, dtype=dtype) / dtype(255)
    edges = np.concatenate([k, np.nextafter(k, dtype(2)),
                            np.nextafter(k, dtype(-1))])
    rng = np.random.RandomState(seed)
    rest = rng.uniform(-0.5, 1.5, max(0, n - len(edges))).astype(dtype)
    out = np.concatenate([edges, rest])[:n]
    rng.shuffle(out)
    return out


def _batch(dtype, b, hw, seed=0):
    return [_values(dtype, hw[0] * hw[1], seed + i).reshape(hw)
            for i in range(b)]


@pytest.fixture(scope="module")
def toy():
    return _toy_detector(1, device="cpu")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("b,hw", [(1, (96, 112)), (3, (96, 112)),
                                  (1, (40, 990)), (2, (990, 40))])
def test_the_canvas_is_numpy_rounding_bit_for_bit(toy, dtype, b, hw):
    images = _batch(dtype, b, hw)
    got = (toy._to_canvas(images[0])[None] if b == 1
           else toy._to_canvas_batch(images))
    H, W = toy._canvas_hw
    assert got.shape == (b, H, W) == (b, 1000, 1000)
    assert got.dtype == torch.float32
    assert torch.equal(got, _numpy_canvas(images, H, W))


def test_a_larger_image_grows_the_canvas():
    det = _toy_detector(1, device="cpu", image_prescaling=False)
    small, big = _batch(np.float32, 1, (64, 64))[0], np.float32(0.5)
    assert det._to_canvas(small).shape == (2048, 2048)
    big = np.full((2100, 30), big, dtype=np.float32)
    got = det._to_canvas_batch([big, big])
    assert got.shape == (2, 2560, 2560) and det._canvas_hw == (2560, 2560)
    assert torch.equal(got, _numpy_canvas([big, big], 2560, 2560))
    assert torch.equal(det._to_canvas(small)[None],
                       _numpy_canvas([small], 2560, 2560))


@pytest.mark.parametrize("images", [
    [np.arange(0, 256, dtype=np.uint8).reshape(16, 16)],
    [np.linspace(-0.5, 1.5, 256).astype(np.float16).reshape(16, 16)],
    [np.arange(-8, 248, dtype=np.int32).reshape(16, 16)],
    [_values(np.float32, 256, 1).reshape(16, 16),
     _values(np.float64, 256, 2).reshape(16, 16)],
], ids=["uint8", "float16", "int32", "mixed"])
def test_other_dtypes_round_on_the_host(toy, images):
    rows = upload.host_rows(images)
    assert rows.dtype == np.uint8
    got = upload.canvas_from_rows(torch.from_numpy(rows), 32, 48)
    assert torch.equal(got, _numpy_canvas(images, 32, 48))
    H, W = toy._canvas_hw
    assert torch.equal(toy._to_canvas_batch(images),
                       _numpy_canvas(images, H, W))


def test_detect_equals_a_dispatch_of_the_numpy_canvas(toy):
    rng = np.random.RandomState(1)
    images = [rng.rand(96, 112).astype(np.float32) for _ in range(4)]

    def dets(out):
        return [(d.box, d.angle, d.eye_left, d.eye_right, d.confidence)
                for d in out]

    H, W = toy._canvas_hw
    got, want = [], []
    for im in images:
        got.append(dets(toy.detect(im, estimate_attributes=False)))
        canvas = _numpy_canvas([im], H, W)[0]
        block = toy._dispatch_one(canvas, im.shape, False)
        want.append(dets(toy._finish_one(canvas, block, False)))
    assert got == want and any(got)


def test_the_upload_span_counts_on_the_cpu(toy, monkeypatch, tmp_path):
    fresh = profiling.SpanLog()
    monkeypatch.setattr(profiling, "_LOG", fresh)
    images = _batch(np.float32, 2, (96, 112))
    with profiling.trace(str(tmp_path)):
        toy._to_canvas(images[0])
        toy._to_canvas_batch(images, request=7)
    spans = [s for s in fresh.between(0, FOREVER) if s.name == "pfa.upload"]
    assert [s.counts for s in spans] == [{"bytes": 0, "pinned": 0}] * 2
    assert spans[1].request == 7


# -- the staging ring through stand-ins for the card ---------------------------


class _Event:
    def __init__(self, log, name):
        self.log, self.name, self.pending = log, name, False

    def record(self, stream):          # the work before it ends at once
        self.log.append(("record", self.name, stream.name))

    def query(self):
        return not self.pending

    def synchronize(self):
        self.log.append(("synchronize", self.name))
        self.pending = False


class _Stream:
    def __init__(self, log, name):
        self.log, self.name = log, name

    def wait_event(self, event):
        self.log.append(("wait", self.name, event.name))

    def wait_stream(self, other):
        self.log.append(("wait_stream", self.name, other.name))


def _stand_in_card(monkeypatch, log):
    """The uploader's card calls on the CPU: events and streams that log
    what they are asked, pinned and device buffers as plain CPU tensors,
    the copy as a logged CPU copy."""
    events = iter(range(1 << 20))
    default, side = _Stream(log, "default"), _Stream(log, "upload")
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda: _Event(log, f"e{next(events)}"))
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: side)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: default)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    empty = torch.empty

    def fake_empty(*a, pin_memory=False, device=None, **kw):
        if pin_memory or device is not None:
            log.append(("alloc", "pinned" if pin_memory else "device", a[0]))
        return empty(*a, **kw)

    monkeypatch.setattr(upload.torch, "empty", fake_empty)
    copy = torch.Tensor.copy_

    def fake_copy(dst, src, non_blocking=False):
        log.append(("copy", non_blocking))
        return copy(dst, src)

    monkeypatch.setattr(torch.Tensor, "copy_", fake_copy)


def test_the_ring_orders_copies_and_reuse_by_events(monkeypatch, tmp_path):
    log = []
    _stand_in_card(monkeypatch, log)
    up = upload.Uploader(torch.device("cuda"), slots=3)
    fresh = profiling.SpanLog()
    monkeypatch.setattr(profiling, "_LOG", fresh)
    shapes = [(2, (30, 40)), (2, (30, 40)), (1, (30, 40)), (4, (30, 40)),
              (2, (30, 40)), (2, (50, 60)), (2, (30, 40))]
    with profiling.trace(str(tmp_path)):
        for i, (b, hw) in enumerate(shapes):
            images = _batch(np.float64 if i == 4 else np.float32, b, hw, i)
            if i == 4:       # slot 1's copy of upload 1 is still running
                up._ring[1].copied.pending = True
            if i == 5:       # slot 2's conversion of upload 2 has not run
                up._ring[2].read.pending = True
            del log[:]
            got = up.canvas(images, 64, 64, request=i)
            assert torch.equal(got, _numpy_canvas(images, 64, 64)), i
            slot = i % 3
            e_copied, e_read = f"e{2 * slot}", f"e{2 * slot + 1}"
            nbytes = b * hw[0] * hw[1] * (8 if i == 4 else 4)
            grows = {0: True, 1: True, 2: True, 3: True, 4: True,
                     5: True, 6: False}[i]
            want = ([("synchronize", e_copied)] if i == 4 else [])
            want += [("alloc", "pinned", nbytes)] if grows else []
            want += ([("alloc", "device", nbytes),
                      ("wait_stream", "upload", "default")] if grows else [])
            want += [("wait", "upload", e_read)] if i == 5 else []
            want += [("copy", True), ("record", e_copied, "upload"),
                     ("wait", "default", e_copied)]
            assert log[:len(want)] == want, (i, log)
            assert log[-1] == ("record", e_read, "default"), (i, log)
    spans = fresh.between(0, FOREVER)
    ups = [s for s in spans if s.name == "pfa.upload"]
    assert [s.counts["pinned"] for s in ups] == [1] * len(shapes)
    assert [s.counts["bytes"] for s in ups] == [
        b * hw[0] * hw[1] * (8 if i == 4 else 4)
        for i, (b, hw) in enumerate(shapes)]
    waits = [s for s in spans if s.name == "pfa.upload.wait"]
    assert len(waits) == 1 and waits[0].parent == ups[4].id
    # Each slot grew to the largest batch it met.
    assert [s.host.numel() for s in up._ring] == [
        4 * 30 * 40 * 4, 2 * 30 * 40 * 8, 2 * 50 * 60 * 4]


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


CARD_MODELS = [("SavedNetworksTPU", 0.2, 5, [90, 220]),
               ("SavedNetworksTPU_photo", 0.1, 12, [70, 140])]


def _detections(out):
    return [(d.box, d.angle, d.eye_left, d.eye_right, d.confidence, d.age,
             d.race_value, d.gender_value) for d in out]


@pytest.mark.cuda
def test_canvases_equal_the_reference_on_the_card():
    from portbench.reference.detect import ReferenceDetector
    dev = _card()
    det = detector_mod.FaceDetector(
        detector_mod.DetectionModel.load(
            os.path.join(ROOT, "SavedNetworksTPU"), device=dev),
        DetectorConfig(), device=dev)
    ref = types.SimpleNamespace(device=dev, s=types.SimpleNamespace(
        prescale_size=det.config.prescale_size, image_prescaling=True))
    scenes = _scenes(8, 5, [90, 220], 2718)
    edges = _batch(np.float32, 3, (800, 1000), 5)
    images = scenes + edges + [im.astype(np.float64) for im in edges]
    for k, im in enumerate(images):
        assert torch.equal(det._to_canvas(im),
                           ReferenceDetector.canvas(ref, im)), k
    for batch in (scenes, edges, [im.astype(np.float64) for im in edges]):
        stack = det._to_canvas_batch(batch)
        for k, im in enumerate(batch):
            assert torch.equal(stack[k], ReferenceDetector.canvas(ref, im))
    ring = det._upload._ring
    assert len(ring) == det.config.stream_depth + 1
    assert all(s.host.is_pinned() and s.dev.is_cuda for s in ring)


@pytest.mark.cuda
@pytest.mark.parametrize("artifacts,smallest,faces,side", CARD_MODELS)
def test_a_stream_over_the_ring_equals_batch_by_batch(
        monkeypatch, tmp_path, artifacts, smallest, faces, side):
    dev = _card()
    model = detector_mod.DetectionModel.load(os.path.join(ROOT, artifacts),
                                             device=dev)
    det = detector_mod.FaceDetector(
        model, DetectorConfig(smallest_face=smallest), device=dev)
    scenes = _scenes(12, faces, side, 31)
    batches = [[scenes[(3 * j + k) % len(scenes)] for k in range(4)]
               for j in range(10)]
    want = [[_detections(d) for d in det.detect_batch(b)] for b in batches]
    fresh = profiling.SpanLog()
    monkeypatch.setattr(profiling, "_LOG", fresh)
    with profiling.trace(str(tmp_path)):
        got = [[_detections(d) for d in out]
               for out in det.detect_stream(iter(batches), depth=3)]
    assert got == want and sum(len(d) for b in got for d in b) > 0
    ups = [s for s in fresh.between(0, FOREVER) if s.name == "pfa.upload"]
    assert len(ups) == 10 > len(det._upload._ring)
    assert all(s.counts == {"bytes": 4 * 800 * 1000 * 4, "pinned": 1}
               for s in ups)
    assert all(s.host.is_pinned() for s in det._upload._ring)
