"""Share of the traced window in which no device record ran: 1 - (union
of the device intervals) / (window), in percent. How far the host holds
the card back."""


def read(ctx):
    return (1.0 - ctx.trace.busy_s / ctx.trace.window_s) * 100.0
