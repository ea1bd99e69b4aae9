"""Multi-process batch sweep: embarrassingly parallel image batches.

Port of ``pyfaceanalysis_tpu.parallel.multihost`` on ``torch.distributed``.
SURVEY.md section 2.4: the reference's only throughput amortization is
single-process batch mode; scale-out is IMAGE parallelism over hosts or
processes -- images are independent until their own NMS, so no collective
is needed in the detection path at all; processes simply take disjoint
slices of the batch file and write disjoint outputs. The process group
(``gloo`` backend) only serves the rendezvous: it tells every process its
rank and the world size.

Usage (one process per host or per card):

    python -m pyfaceanalysis_torch.apps.detect --batch=big.txt \
        --distributed=1 --coordinator=HOST:PORT --num_processes=N \
        --process_id=K

Single-process invocations degrade to the identity split, so the same code
path runs everywhere (and in CI).
"""

from __future__ import annotations

import datetime
from typing import List, Optional, Sequence, Tuple

# How long a process waits for the others at the rendezvous.
RENDEZVOUS_TIMEOUT_S = 120.0


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout_s: float = RENDEZVOUS_TIMEOUT_S) -> Tuple[int, int]:
    """Brings up ``torch.distributed`` (gloo, TCP rendezvous at
    ``coordinator`` = "HOST:PORT") and returns (process_id, num_processes).
    With neither a coordinator nor a process count it initializes nothing
    and returns the rank and world size of a group that is already up, else
    (0, 1). The rendezvous raises after ``timeout_s`` seconds."""
    import torch.distributed as dist

    if coordinator is None and num_processes is None:
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
        return 0, 1
    if not coordinator or num_processes is None or process_id is None:
        raise ValueError("a distributed run needs --coordinator=HOST:PORT, "
                         "--num_processes and --process_id")
    dist.init_process_group(
        backend="gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank(), dist.get_world_size()


def shard_work(items: Sequence, process_id: int, num_processes: int
               ) -> List:
    """Deterministic contiguous-strided split of a work list: process k
    takes items k, k+N, k+2N, ... (keeps per-process batches spread across
    the file so early/late images balance)."""
    return list(items[process_id::num_processes])


def shard_batch_files(image_filenames: Sequence[str],
                      output_filenames: Sequence[str],
                      process_id: int, num_processes: int
                      ) -> Tuple[List[str], List[str]]:
    """Splits a batch-mode work list across processes; outputs are disjoint
    so no coordination is needed at write time."""
    return (shard_work(image_filenames, process_id, num_processes),
            shard_work(output_filenames, process_id, num_processes))
