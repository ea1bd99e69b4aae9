"""Parallelism: the multi-process batch sweep (parallel.multihost).

Images are independent until their own NMS, so processes take disjoint
slices of a batch file and need no collective at all.
"""

from pyfaceanalysis_torch.parallel import multihost

__all__ = ["multihost"]
