"""Spans of the PyTorch port's serving path (``utils.profiling.annotate``).

The span API off and on, on the session's thread and on a helper thread;
the log's bound and its count of dropped spans; a span's times against
the profiler's event of the same region; and on the toy
production-shaped detector (``parallel.dryrun``), every span of
``detect`` and of a prefetching ``detect_stream`` on the thread that
makes it, the spans of every thread in the exported Chrome trace, and
the same detections with and without a session. CPU only; imports no
JAX.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch_draws import fair_torch_threads  # noqa: F401  (autouse)

from pyfaceanalysis_torch.parallel.dryrun import _toy_detector
from pyfaceanalysis_torch.utils import profiling

FOREVER = 1 << 62
STAGES = [f"pfa.stage.{i:02d}.{k}" for i, k in enumerate(
    ["Disc", "PosX", "PosY", "PAng", "Scale"] * 3 + ["Disc", "Disc"])]


@pytest.fixture
def log(monkeypatch):
    """A fresh span log in the module's place."""
    fresh = profiling.SpanLog()
    monkeypatch.setattr(profiling, "_LOG", fresh)
    return fresh


def _session():
    return profile(activities=[ProfilerActivity.CPU])


def test_annotate_off_is_the_shared_no_op(log, monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock with tracing off")

    monkeypatch.setattr(profiling.time, "time_ns", no_clock)
    first = profiling.annotate("pfa.nms", rows_in=3)
    assert first is profiling.annotate("pfa.pull")
    with first as span:
        span.update(kept=1)
    assert log.between(0, FOREVER) == [] and log.dropped == 0


def test_spans_on_two_threads_with_parents_requests_and_counts(log):
    def helper():
        with profiling.annotate("h.outer"):
            with profiling.annotate("h.inner", rows=4):
                pass

    with _session():
        with profiling.annotate("m.outer", request="r7", images=2):
            with profiling.annotate("m.inner", rows_in=5) as span:
                span.update(kept=3)
            th = threading.Thread(target=helper, name="pfa-helper")
            th.start()
            th.join(timeout=10.0)
    assert not th.is_alive()
    by = {s.name: s for s in log.between(0, FOREVER)}
    assert set(by) == {"m.outer", "m.inner", "h.outer", "h.inner"}
    mo, mi, ho, hi = (by[k] for k in ("m.outer", "m.inner", "h.outer",
                                      "h.inner"))
    assert mo.parent is None and mi.parent == mo.id
    assert mo.request == mi.request == "r7"
    assert mo.counts == {"images": 2}
    assert mi.counts == {"rows_in": 5, "kept": 3}
    assert mo.thread == mi.thread == threading.current_thread().name
    # A helper thread keeps a stack of its own; its root is its request.
    assert ho.thread == hi.thread == "pfa-helper"
    assert ho.parent is None and hi.parent == ho.id
    assert ho.request == hi.request == ho.id and hi.counts == {"rows": 4}
    # Only the session's thread enters record_function.
    assert mo.traced and mi.traced and not ho.traced and not hi.traced
    for s in by.values():
        assert s.start_ns <= s.end_ns
    assert mo.start_ns <= mi.start_ns and mi.end_ns <= mo.end_ns


def test_the_log_is_bounded_and_counts_what_it_dropped(monkeypatch):
    small = profiling.SpanLog(4)
    monkeypatch.setattr(profiling, "_LOG", small)
    with _session():
        for i in range(6):
            with profiling.annotate(f"s{i}"):
                pass
    held = small.between(0, FOREVER)
    assert [s.name for s in held] == ["s2", "s3", "s4", "s5"]
    assert small.dropped == profiling.dropped() == 2
    assert 0 < small.dropped_until <= held[0].start_ns     # s1's end
    # A window that a dropped span reached cannot be read; a later one can.
    assert profiling.spans(0, FOREVER) is None
    later = profiling.spans(held[0].start_ns, FOREVER)
    assert [s.name for s in later] == ["s2", "s3", "s4", "s5"]
    assert profiling.spans(held[-1].end_ns + 1, FOREVER) == []


def test_span_times_lie_within_1ms_of_the_profilers_event(log):
    with _session() as prof:
        with profiling.annotate("pfa.clock"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    (span,) = log.between(0, FOREVER)
    (event,) = [e for e in prof.profiler.kineto_results.events()
                if e.name() == "pfa.clock"]
    start = event.start_ns()
    end = start + event.duration_ns()
    assert abs(span.start_ns - start) < 1_000_000
    assert abs(span.end_ns - end) < 1_000_000


def _detections(out):
    return [(d.box, d.angle, d.eye_left, d.eye_right, d.confidence, d.age)
            for d in out]


def test_detect_and_stream_spans_on_their_threads(log, tmp_path):
    torch.manual_seed(0)
    # Rungs at 32 and 16 rows, so that both fire on the toy grids.
    det = _toy_detector(1, device="cpu", mid_compact=32, mid_compact2=16)
    rng = np.random.RandomState(1)
    imgs = [rng.rand(96, 112).astype(np.float32) for _ in range(4)]
    batches = [imgs[:2], imgs[2:]]

    off_one = det.detect(imgs[0])
    off_stream = list(det.detect_stream(iter(batches), depth=2))
    assert log.between(0, FOREVER) == []
    with profiling.trace(str(tmp_path)):
        one = det.detect(imgs[0])
        windows = det.windows_scanned
        stream = list(det.detect_stream(iter(batches), depth=2))
    assert _detections(one) == _detections(off_one) and one
    assert ([[_detections(d) for d in b] for b in stream]
            == [[_detections(d) for d in b] for b in off_stream])

    got = log.between(0, FOREVER)
    main = threading.current_thread().name
    (top,) = [s for s in got if s.name == "pfa.detect"]
    mine = [s for s in got
            if s.request == top.id and s.end_ns <= top.end_ns]
    assert {s.thread for s in mine} == {main}
    names = sorted(s.name for s in mine)
    assert names == sorted(
        ["pfa.detect", "pfa.upload", "pfa.dispatch", "pfa.grid",
         "pfa.pyramid", "pfa.rung", "pfa.rung", "pfa.eyes", "pfa.finish",
         "pfa.pull", "pfa.pull", "pfa.nms", "pfa.heads", "pfa.assemble"]
        + STAGES)
    by = {s.name: s for s in mine}
    assert {by[k].parent for k in ("pfa.upload", "pfa.dispatch",
                                   "pfa.finish")} == {top.id}
    assert by["pfa.grid"].counts["real"] == windows
    assert by["pfa.grid"].counts["rows"] == 64
    assert by["pfa.finish"].counts == {"images": 1}
    rungs = [s.counts for s in mine if s.name == "pfa.rung"]
    assert rungs == [{"rows_in": 64, "rows_out": 32},
                     {"rows_in": 32, "rows_out": 16}]
    assert by["pfa.nms"].counts["kept"] == len(one)
    assert by["pfa.heads"].counts == {"faces": len(one), "bucket": max(
        4, 1 << (len(one) - 1).bit_length()), "graph": 0}
    assert by["pfa.assemble"].counts == {"detections": len(one)}

    rest = [s for s in got if s.start_ns >= top.end_ns]
    for j, batch in enumerate(stream):
        spans = [s for s in rest if s.request == j]
        on = {(s.name, s.thread) for s in spans}
        assert {("pfa.upload", "pfa-stream-push"),
                ("pfa.stream.producer_wait", "pfa-stream-push"),
                ("pfa.dispatch", main), ("pfa.grid", main),
                ("pfa.pyramid", main), ("pfa.eyes", main),
                ("pfa.finish", "pfa-stream-finish"),
                ("pfa.pull", "pfa-stream-finish"),
                ("pfa.nms", "pfa-stream-finish"),
                ("pfa.heads", "pfa-stream-finish"),
                ("pfa.assemble", "pfa-stream-finish")} <= on
        assert {(k, main) for k in STAGES} <= on
        grid = [s for s in spans if s.name == "pfa.grid"][0]
        assert grid.counts == {"rows": 128, "real": 2 * windows}
        finish = [s for s in spans if s.name == "pfa.finish"][0]
        assert finish.counts == {"images": 2}
        assert sum(s.parent == finish.id for s in spans
                   if s.name == "pfa.pull") == 1           # the block
        assert sum(len(d) for d in batch) == sum(
            s.counts["detections"] for s in spans
            if s.name == "pfa.assemble")
    waits = {(s.name, s.thread) for s in rest
             if s.name.startswith("pfa.stream.")}
    assert {("pfa.stream.wait_input", main),
            ("pfa.stream.wait_result", main),
            ("pfa.stream.finisher_wait", "pfa-stream-finish")} <= waits

    # The exported trace holds every span once: the session thread's as
    # its record_function regions, the helpers' appended.
    (path,) = os.listdir(tmp_path)
    events = json.load(open(os.path.join(tmp_path, path)))["traceEvents"]
    count = {}
    for e in events:
        if e.get("ph") == "X" and e["name"].startswith("pfa."):
            count[e["name"]] = count.get(e["name"], 0) + 1
    assert count["pfa.dispatch"] == 3 and count["pfa.finish"] == 3
    assert count["pfa.upload"] == 3 and count["pfa.detect"] == 1
    assert count["pfa.stream.finisher_wait"] == sum(
        s.name == "pfa.stream.finisher_wait" for s in got)

