"""The port tests' share of the CPU cores under pytest-xdist.

Imports no JAX, so that the files that run with ``--noconftest`` on the
card's machine (``test_torch_graphs.py``, ``test_torch_heads_graph.py``)
take it as every other port test file does.
"""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def fair_torch_threads():
    """Under pytest-xdist, run a module's torch work on its worker's share
    of the CPU cores. Torch's default of one thread per core in every
    worker oversubscribes the machine several times over, and its small
    parallel regions then crawl (the tiny training pipeline of
    test_torch_training_pipeline.py took 477 s under six workers on an
    8-core machine, 12 s alone). One process alone keeps the default.
    A test module takes it with ``from torch_threads import
    fair_torch_threads``."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, min(before, (os.cpu_count() or 1)
                                     // workers)))
    yield
    torch.set_num_threads(before)
