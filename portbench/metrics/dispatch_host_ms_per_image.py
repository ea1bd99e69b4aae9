"""The caller's time in the program's dispatch per image: the summed
``pfa.dispatch`` spans (``engine/detector.py``: grid, pyramid, the 17
stages, the rungs and the eye pass enqueued, up to the result block)
inside the traced window, over the images completed in it, in ms. Host
work of the launching thread, and any wait on the device it meets."""

from portbench import spans


def read(ctx):
    got = spans.named(ctx, "pfa.dispatch")
    if got is None:
        return None
    return spans.per_image(spans.total_ms(got, ctx.trace.window), ctx)
