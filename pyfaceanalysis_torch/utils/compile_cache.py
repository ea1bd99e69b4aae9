"""Cold-start cost of the CLI entry points: the kernels' build.

Counterpart of ``pyfaceanalysis_tpu.utils.compile_cache``, under the same
function name. The reference amortizes model-load cost with batch mode
(README.md:45-57). This package compiles no programs at run time; its
cold-start cost is the ``nvcc`` build of the two CUDA kernels, which
``ops.cuda_build`` keeps on disk under ``pyfaceanalysis_torch/_build/``,
named by a hash of source and flags, so every process after the first only
loads the libraries. Building both up front (one ``nvcc`` each, in
parallel) keeps that cost out of the first detection.
"""

from __future__ import annotations

from typing import Union

import torch

from pyfaceanalysis_torch.config import resolve_device


def enable_persistent_compilation_cache(
        device: Union[str, torch.device, None] = None) -> bool:
    """On ``cuda`` (the default) builds and loads both kernels and returns
    True; on ``cpu`` does nothing and returns False."""
    if resolve_device(device).type != "cuda":
        return False
    from pyfaceanalysis_torch.ops import cuda_crop, cuda_gather
    from pyfaceanalysis_torch.ops.cuda_build import build_all

    build_all([cuda_crop.KERNEL, cuda_gather.KERNEL])
    return True
