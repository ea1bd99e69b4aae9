"""The readers of the program's spans (``metrics/*`` over
``portbench/spans.py``) on a hand-built trace and span log: each gives
its hand-computed value, and nothing when the log dropped spans in the
window, when the window holds none of its spans, or when the program
keeps no span log (a commit before it)."""

from types import SimpleNamespace

import pytest

from portbench import run as R
from portbench.trace import Trace
from pyfaceanalysis_torch.utils import profiling

WINDOW = (1000, 11000)
IMAGES = 2
# (id, parent, name, thread, start, end, counts)
SPANS = [
    (1, None, "pfa.stream.wait_input", "main", 500, 2000, {}),
    (2, None, "pfa.dispatch", "main", 2000, 6000, {}),
    (3, 2, "pfa.grid", "main", 2100, 2200, {"rows": 8192, "real": 4160}),
    (4, 2, "pfa.pull", "main", 3000, 3500, {}),    # a sharded rung's
    (5, None, "pfa.stream.wait_result", "main", 6000, 9000, {}),
    (6, None, "pfa.dispatch", "main", 9000, 12000, {}),
    (7, 6, "pfa.grid", "main", 9100, 9200, {"rows": 8192, "real": 4160}),
    (10, None, "pfa.finish", "finish", 1500, 7000, {"images": 2}),
    (11, 10, "pfa.pull", "finish", 1600, 4000, {}),
    (12, 10, "pfa.heads", "finish", 5000, 6000, {"faces": 3}),
    (13, 12, "pfa.pull", "finish", 5500, 5900, {}),
    (14, None, "pfa.finish", "finish", 10000, 13000, {"images": 2}),
    (15, 14, "pfa.pull", "finish", 10500, 12000, {}),
]
DEVICE = [("k", 1000, 1500), ("k", 2500, 4000), ("k", 3500, 5000),
          ("k", 8000, 8500), ("k", 10000, 11500)]
# Hand counts, in ms per image (ns / 1e6 / 2 images):
WANT = {
    # 4000 + 2000 (the second clipped at the window's end)
    "dispatch_host_ms_per_image.stream": 6000 / 1e6 / IMAGES,
    # finish 5500 + 1000, less its nested pulls 2400 + 400 + 500
    "finish_host_ms_per_image.single": 3200 / 1e6 / IMAGES,
    # every pull: 500 + 2400 + 400 + 500
    "result_wait_ms_per_image.stream": 3800 / 1e6 / IMAGES,
    # idle [1500, 2500], [5000, 8000], [8500, 10000] against the waits
    # [1000, 2000], [6000, 9000]: 500 + 2000 + 500
    "idle_blocked_ms_per_image.stream": 3000 / 1e6 / IMAGES,
    "grid_padding_share.stream": 100.0 * (1 - 8320 / 16384),
}


def _ctx():
    busy = 1000 + 500 + 500 + 2500 + 500
    return SimpleNamespace(trace=Trace(DEVICE, [], WINDOW, busy, True),
                           images=IMAGES)


def _fill(log, spans=SPANS):
    for i, parent, name, thread, a, b, counts in spans:
        log.add(profiling.Span(i, parent, 0, name, thread, 0, a, b, counts,
                               False))


@pytest.fixture
def log(monkeypatch):
    fresh = profiling.SpanLog()
    monkeypatch.setattr(profiling, "_LOG", fresh)
    return fresh


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_gives_the_hand_count(log, name):
    _fill(log)
    assert R.metric_reader(name).read(_ctx()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_gives_nothing_on_a_dropped_or_empty_log(monkeypatch, name):
    reader = R.metric_reader(name)
    small = profiling.SpanLog(len(SPANS) - 1)
    monkeypatch.setattr(profiling, "_LOG", small)
    _fill(small)                 # the first span, ending at 2000, dropped
    assert small.dropped == 1 and reader.read(_ctx()) is None
    monkeypatch.setattr(profiling, "_LOG", profiling.SpanLog())
    assert reader.read(_ctx()) is None
    # Spans of other names only.
    _fill(profiling._LOG, [s for s in SPANS if s[2] == "pfa.stream.x"]
          + [(99, None, "pfa.other", "main", 1000, 2000, {})])
    assert reader.read(_ctx()) is None
    monkeypatch.delattr(profiling, "spans")      # a program without a log
    assert reader.read(_ctx()) is None


def test_a_span_outside_the_window_is_not_counted(log):
    _fill(log, SPANS + [(30, None, "pfa.dispatch", "main", 11000, 12000,
                         {}),
                        (31, None, "pfa.grid", "main", 0, 900,
                         {"rows": 100, "real": 0})])
    ctx = _ctx()
    assert R.metric_reader("dispatch_host_ms_per_image.single").read(
        ctx) == pytest.approx(WANT["dispatch_host_ms_per_image.stream"])
    assert R.metric_reader("grid_padding_share.single").read(
        ctx) == pytest.approx(WANT["grid_padding_share.stream"])
