"""The share of the dispatches that replayed a captured CUDA graph: 100 x
the ``pfa.dispatch`` spans whose ``graph`` count is 1 over all
``pfa.dispatch`` spans of the traced window (``engine/detector.py``,
``engine/graphs.py``), in percent. A dispatch that ran eagerly or
captured its graph counts 0. Nothing without the count (a program that
replays no graph)."""

from portbench import spans


def read(ctx):
    got = spans.named(ctx, "pfa.dispatch")
    if not got or not any("graph" in s.counts for s in got):
        return None
    return 100.0 * sum(s.counts.get("graph", 0) for s in got) / len(got)
