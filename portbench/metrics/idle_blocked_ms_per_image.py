"""Device idle time spent while the stream's caller was blocked, per
image: the part of the traced window in which no device record ran (the
window less the union of ``ctx.trace.device``) that lies inside the
caller's ``pfa.stream.wait_input`` and ``pfa.stream.wait_result`` spans
(``engine/detector.py``, ``detect_stream``), over the images completed in
the window, in ms. What the card loses because the caller has nothing to
dispatch."""

from portbench import spans
from portbench import trace as trace_mod


def read(ctx):
    got = spans.named(ctx, "pfa.stream.wait_input",
                      "pfa.stream.wait_result")
    if got is None:
        return None
    window = ctx.trace.window
    idle = trace_mod._gaps(trace_mod._union(ctx.trace.device, window),
                           window)
    blocked = spans.union(spans.clipped(got, window))
    return spans.per_image(spans.overlap_ns(idle, blocked) / 1e6, ctx)
