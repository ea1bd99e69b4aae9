"""The rotated pyramid gather (``ops/cuda_gather.py`` + ``csrc/gather.cu``)
on the fused batch: its least time per call over its device time per
call, in percent. The least time of each of a batch's calls (six
refinement extractions, then the eye pass) is ``work.gather_bytes`` over
the card's HBM rate, with the distinct texels per image that the
reference counted on the run's sampled images; the device time is that
of the ``gather_kernel`` and ``coeffs_kernel`` records of the trace."""


def read(ctx):
    recs = ctx.trace.records("gather_kernel", "coeffs_kernel")
    if ctx.peaks is None or ctx.gather_bytes is None or not recs:
        return None
    mean_bytes = sum(ctx.gather_bytes) / len(ctx.gather_bytes)
    least = mean_bytes / ctx.peaks["hbm_bytes_per_s"]
    spent = sum(b - a for _, a, b in recs) / 1e9
    return len(recs) * least / spent * 100.0
