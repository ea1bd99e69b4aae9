"""What the readers of the program's spans share (``metrics/
dispatch_host_ms_per_image.py`` and the others that import this module):
the spans of ``pyfaceanalysis_torch.utils.profiling`` that overlap the
traced window, and their time inside it.

The spans and the profiler's records share one clock (epoch
nanoseconds), so a span is clipped to the trace's window as it stands. A
program without the span log (a commit before it), a log that dropped
spans in the window, and a window without the spans asked for read as
nothing, and the metric is left out of the result line.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple


def in_window(ctx) -> Optional[list]:
    """Every span of the program that overlaps ``ctx.trace.window``, or
    None when the program keeps no span log or the log dropped spans
    there."""
    try:
        from pyfaceanalysis_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return None if read is None else read(*ctx.trace.window)


def named(ctx, *names: str) -> Optional[list]:
    """The spans of the window whose name is one of ``names``; None when
    there is none (or no log, see :func:`in_window`)."""
    got = [s for s in in_window(ctx) or () if s.name in names]
    return got or None


def clipped(spans: Iterable, window: Tuple[int, int]
            ) -> List[Tuple[int, int]]:
    """Each span's interval inside ``window``, in ns."""
    lo, hi = window
    return [(max(s.start_ns, lo), min(s.end_ns, hi)) for s in spans
            if s.end_ns > lo and s.start_ns < hi]


def total_ms(spans: Iterable, window: Tuple[int, int]) -> float:
    """The summed time of the spans inside the window, in ms."""
    return sum(b - a for a, b in clipped(spans, window)) / 1e6


def union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merged intervals, in order."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap_ns(xs: List[Tuple[int, int]], ys: List[Tuple[int, int]]) -> int:
    """The time two lists of disjoint, ordered intervals share."""
    i = j = 0
    out = 0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        out += max(0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def per_image(ms: float, ctx) -> Optional[float]:
    return ms / ctx.images if ctx.images else None
