"""The host's time finishing results per image: the summed ``pfa.finish``
spans (``engine/detector.py``: the result pull, NMS, the attribute heads
and the ``Detection`` lists) inside the traced window, less the
``pfa.pull`` spans nested in them (the waits on the device), over the
images completed in the window, in ms."""

from portbench import spans


def read(ctx):
    got = spans.in_window(ctx)
    finish = [s for s in got or () if s.name == "pfa.finish"]
    if not finish:
        return None
    ids = {s.id for s in finish}
    parent = {s.id: s.parent for s in got}

    def nested(s):
        p = s.parent
        while p is not None and p not in ids:
            p = parent.get(p)
        return p is not None

    pulls = [s for s in got if s.name == "pfa.pull" and nested(s)]
    window = ctx.trace.window
    return spans.per_image(spans.total_ms(finish, window)
                           - spans.total_ms(pulls, window), ctx)
