"""Device records (kernels, copies, sets) that start inside the traced
window, per image completed in it: the GPU launches the drivers make for
one image (``engine/detector.py``)."""


def read(ctx):
    return len(ctx.trace.in_window()) / ctx.images if ctx.images else None
