"""The host waiting on the device per image: the summed ``pfa.pull``
spans (every blocking device-to-host copy of the serving path: the
result block, the heads' output, the eye pass's flag, a sharded rung's
indices) of every thread inside the traced window, over the images
completed in it, in ms."""

from portbench import spans


def read(ctx):
    got = spans.named(ctx, "pfa.pull")
    if got is None:
        return None
    return spans.per_image(spans.total_ms(got, ctx.trace.window), ctx)
