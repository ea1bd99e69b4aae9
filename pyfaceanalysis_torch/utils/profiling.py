"""Profiling facade: phase timers (utils.benchmark) + torch.profiler traces.

Port of ``pyfaceanalysis_tpu.utils.profiling``. The reference's
observability is the label-keyed ``Benchmark`` timer table
(benchmarking.py:11-108). The interesting time is on the DEVICE, which host
timers cannot attribute -- this module adds the torch.profiler hooks:

    with trace("pfa-trace"):                # Chrome trace under pfa-trace/
        detector.detect(image)

    with annotate("cascade"):               # named region inside a trace
        ...

A trace records CPU activity and, where a card is present, CUDA activity,
and is written as ``trace_<pid>_<n>.json`` under the given directory; open
it in ``chrome://tracing`` or Perfetto.
"""

from __future__ import annotations

import contextlib
import itertools
import os
from typing import Iterator, Optional

_trace_ids = itertools.count()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """torch.profiler.profile wrapper. A profiler that cannot start is
    reported and the body runs unprofiled; an exception of the body itself
    always propagates."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        os.makedirs(log_dir, exist_ok=True)
        prof = profile(activities=activities)
        prof.start()
    except Exception as e:        # any failure to start: run unprofiled
        print(f"[profiling] trace unavailable ({e}); running unprofiled")
        yield
        return
    try:
        yield
    finally:
        try:
            prof.stop()
            prof.export_chrome_trace(os.path.join(
                log_dir, f"trace_{os.getpid()}_{next(_trace_ids)}.json"))
        except Exception as e:    # a lost trace never fails the traced run
            print(f"[profiling] trace not written ({e})")


def annotate(name: str):
    """Named trace region (record_function); usable as context manager."""
    from torch.profiler import record_function

    return record_function(name)


@contextlib.contextmanager
def maybe_trace(log_dir: Optional[str]) -> Iterator[None]:
    """trace(log_dir) when a directory is given, else a no-op."""
    if log_dir:
        with trace(log_dir):
            yield
    else:
        yield
