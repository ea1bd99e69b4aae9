"""The union of the device's record intervals inside the traced window,
per image completed in it, in milliseconds: the model step's device time
per image."""


def read(ctx):
    return ctx.trace.busy_s * 1e3 / ctx.images if ctx.images else None
