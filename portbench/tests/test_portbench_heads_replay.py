"""The reader of the heads' graph count (``metrics/heads_replay_share.py``)
on a hand-built span log: it gives its hand count, counts a call that
overlaps the window, and gives nothing when the heads' spans carry no
``graph`` count (a program whose heads replay no graph), when the window
holds no heads, when the log dropped spans there, or when the program
keeps no span log."""

from types import SimpleNamespace

import pytest

from portbench import run as R
from portbench.trace import Trace
from pyfaceanalysis_torch.utils import profiling

WINDOW = (1000, 11000)
HEADS = {"faces": 5, "bucket": 8}
# (id, parent, name, thread, start, end, counts)
SPANS = [
    (1, None, "pfa.finish", "finish", 1500, 9000, {"images": 1}),
    (2, 1, "pfa.heads", "finish", 2000, 3000, dict(HEADS, graph=0)),  # eager
    (3, 1, "pfa.heads", "finish", 4000, 5000, dict(HEADS, graph=0)),  # capture
    (4, 3, "pfa.graph.capture", "finish", 4100, 4900, {}),
    (5, 1, "pfa.heads", "finish", 6000, 7000, dict(HEADS, graph=1)),
    (6, 1, "pfa.heads", "finish", 10500, 11500, dict(HEADS, graph=1)),  # clip
    (7, 1, "pfa.heads", "finish", 11500, 12000, dict(HEADS, graph=0)),  # out
    (8, None, "pfa.dispatch", "main", 2000, 3000, {"graph": 1}),
]
# Four heads' calls overlap the window, two of them replays.
WANT = 100.0 * 2 / 4


def _ctx():
    return SimpleNamespace(
        trace=Trace([("k", 2000, 3000)], [], WINDOW, 1000, True), images=4)


def _fill(log, spans):
    for i, parent, name, thread, a, b, counts in spans:
        log.add(profiling.Span(i, parent, 0, name, thread, 0, a, b, counts,
                               False))


@pytest.fixture
def log(monkeypatch):
    fresh = profiling.SpanLog()
    monkeypatch.setattr(profiling, "_LOG", fresh)
    return fresh


@pytest.mark.parametrize("name", ["heads_replay_share.single",
                                  "heads_replay_share.stream"])
def test_reader_gives_the_hand_count(log, name):
    _fill(log, SPANS)
    assert R.metric_reader(name).read(_ctx()) == pytest.approx(WANT)


def test_every_replay_reads_100(log):
    _fill(log, [(i, p, n, t, a, b, dict(c, graph=1) if n == "pfa.heads"
                 else c) for i, p, n, t, a, b, c in SPANS])
    assert R.metric_reader("heads_replay_share.single").read(
        _ctx()) == pytest.approx(100.0)


def test_reader_gives_nothing_without_the_graph_count(log):
    # The parent's heads: ``faces`` only; its dispatches do replay.
    _fill(log, [(i, p, n, t, a, b, {"faces": 5} if n == "pfa.heads" else c)
                for i, p, n, t, a, b, c in SPANS])
    assert R.metric_reader("heads_replay_share.single").read(_ctx()) is None


def test_reader_gives_nothing_on_a_dropped_or_empty_log(monkeypatch):
    reader = R.metric_reader("heads_replay_share.stream")
    small = profiling.SpanLog(len(SPANS) - 1)
    monkeypatch.setattr(profiling, "_LOG", small)
    _fill(small, SPANS)          # the first span, ending at 9000, dropped
    assert small.dropped == 1 and reader.read(_ctx()) is None
    monkeypatch.setattr(profiling, "_LOG", profiling.SpanLog())
    assert reader.read(_ctx()) is None
    _fill(profiling._LOG, [s for s in SPANS if s[2] != "pfa.heads"])
    assert reader.read(_ctx()) is None
    monkeypatch.delattr(profiling, "spans")      # a program without a log
    assert reader.read(_ctx()) is None
