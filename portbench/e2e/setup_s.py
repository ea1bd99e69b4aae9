"""Seconds from the start of the benchmark's process (its first module)
to the start of the measured window: imports, scene pool, model load,
kernel builds on a cold checkout, and the warm-up of the cell's shapes."""


def read(window, setup_s):
    return setup_s
