"""The HiGSFA layer kernel (``ops/cuda_net_layer.py`` + ``csrc/
net_layer.cu``): the device time of its ``net_layer_kernel`` records that
start inside the traced window, per image completed in it, in
milliseconds. None where the trace holds no such record (a program
without the kernel) or the window no image."""

from portbench.trace import is_kernel


def read(ctx):
    if not ctx.images:
        return None
    lo, hi = ctx.trace.window
    spent = [b - a for name, a, b in ctx.trace.device
             if lo <= a < hi and is_kernel(name, "net_layer_kernel")]
    if not spent:
        return None
    return sum(spent) / 1e6 / ctx.images
