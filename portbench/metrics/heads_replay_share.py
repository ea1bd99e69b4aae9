"""The share of the attribute heads' calls that replayed a captured CUDA
graph: 100 x the ``pfa.heads`` spans whose ``graph`` count is 1 over all
``pfa.heads`` spans of the traced window (``engine/heads.py``,
``engine/graphs.py``), in percent. A call that ran eagerly or captured
its graph counts 0. Nothing without the count (a program whose heads
replay no graph)."""

from portbench import spans


def read(ctx):
    got = spans.named(ctx, "pfa.heads")
    if not got or not any("graph" in s.counts for s in got):
        return None
    return 100.0 * sum(s.counts.get("graph", 0) for s in got) / len(got)
