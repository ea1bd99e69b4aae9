"""The model's operations for the images completed in the traced window
(``work.flops_per_image``: the networks' products and the Gaussian forms
at the plan's row counts, then the eye and head networks of the faces
returned), over the window, as a share of the card's dense bf16 peak
(the configuration's operand precision), in percent. Not reported for a
card without a row in ``peaks.json``."""


def read(ctx):
    if ctx.peaks is None or not ctx.images:
        return None
    rate = ctx.flops / ctx.trace.window_s
    return rate / ctx.peaks["bf16_flops_per_s"] * 100.0
