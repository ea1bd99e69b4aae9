"""The share of the cascade's first rows that are bucket padding: 100 x
(1 - windows / rows) summed over the ``pfa.grid`` spans of the traced
window (``engine/detector.py``, ``_grid_state``: ``rows`` the grid's
bucket rows, ``real`` its windows over all images), in percent. Every
padding row runs the stages before the first rung."""

from portbench import spans


def read(ctx):
    got = spans.named(ctx, "pfa.grid")
    rows = sum(s.counts.get("rows", 0) for s in got or ())
    if not rows:
        return None
    real = sum(s.counts.get("real", 0) for s in got)
    return 100.0 * (1.0 - real / rows)
