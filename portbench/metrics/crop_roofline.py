"""The crop kernel (``ops/cuda_crop.py`` + ``csrc/crop.cu``) on the fused
batch: its least time per call (``work.crop_bytes``: distinct texels read
once, outputs written once, the crop table; over the card's HBM rate)
over its device time per call (the ``crop_kernel`` records of the
trace), in percent."""


def read(ctx):
    recs = ctx.trace.records("crop_kernel")
    if ctx.peaks is None or ctx.crop_bytes is None or not recs:
        return None
    least = ctx.crop_bytes / ctx.peaks["hbm_bytes_per_s"]
    spent = sum(b - a for _, a, b in recs) / 1e9
    return len(recs) * least / spent * 100.0
