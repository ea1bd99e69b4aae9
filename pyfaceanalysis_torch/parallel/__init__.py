"""Parallelism: device meshes, sharded inference and training, and the
multi-process batch sweep.

The work is data parallel over windows (all windows are independent until
the survivor ranking) and over images in batch mode; training is data
parallel over samples and model parallel over receptive fields:

- ``parallel.mesh``: ``make_mesh``, ``shard_batch``, ``replicate`` and
  ``sharded_cascade``, one process looping over the devices of a mesh;
- ``parallel.train_step``: the sharded GSFA step and the mesh trainer;
- ``parallel.multihost``: processes take disjoint slices of a batch file
  and need no collective at all.
"""

from pyfaceanalysis_torch.parallel import multihost
from pyfaceanalysis_torch.parallel.mesh import (
    make_mesh,
    shard_batch,
    sharded_cascade,
)

__all__ = ["make_mesh", "multihost", "shard_batch", "sharded_cascade"]
