"""The traced window: a ``torch.profiler`` session (CPU and CUDA) around a
steady sub-window of the cell's own loop, read in memory.

What it yields (:class:`Trace`): every device record (kernels, copies,
sets) by name with its interval, the union of those intervals inside the
window (the device's busy time: the stream keeps work of several batches
in flight, so records are merged rather than summed), the window's length
from its own marker, the CPU ops, and the breakdown the result line
carries.

A profiler session on the card now and then hands back only part of its
device records. A trace is whole when the records of each counted kernel
match the launches that the program counted in the same session; a
trace that is not whole is taken again, ``ATTEMPTS`` times in all, and
its per-layer metrics are left out when no attempt was whole.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

MARKER = "portbench.window"
ATTEMPTS = 4
TOP = 10
SLACK = 0.15


@dataclasses.dataclass
class Trace:
    device: List[Tuple[str, int, int]]      # (name, start_ns, end_ns)
    cpu: List[Tuple[str, int, int]]
    window: Tuple[int, int]                 # the marker's interval, ns
    busy_ns: int
    whole: bool

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return self.busy_ns / 1e9

    def in_window(self) -> List[Tuple[str, int, int]]:
        """Device records that start inside the window."""
        lo, hi = self.window
        return [r for r in self.device if lo <= r[1] < hi]

    def records(self, *kernels: str) -> List[Tuple[str, int, int]]:
        """Device records of the named kernels."""
        return [r for r in self.device
                if any(is_kernel(r[0], k) for k in kernels)]

    def breakdown(self) -> dict:
        """The device operations with the most time, and the longest idle
        gaps of the device inside the window summed by the CPU op the host
        was in at each gap's middle ("python" where it was in none)."""
        by_op: Dict[str, int] = {}
        for name, a, b in self.device:
            by_op[name] = by_op.get(name, 0) + (b - a)
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = _gaps(_union(self.device, self.window), self.window)
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        host = [c for c in self.cpu if c[0] != MARKER
                and not c[0].startswith("cuda")]
        host.sort(key=lambda c: c[1])
        starts = [c[1] for c in host]
        by_host: Dict[str, int] = {}
        for a, b in gaps[:2000]:
            mid = (a + b) // 2
            label = "python"
            best = None
            i = bisect.bisect_right(starts, mid) - 1
            # The innermost op holding the middle: the latest start.
            for j in range(i, max(i - 400, -1), -1):
                if host[j][2] >= mid:
                    best = host[j]
                    break
            if best is not None:
                label = best[0]
            by_host[label] = by_host.get(label, 0) + (b - a)
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, t / 1e9] for n, t in ops],
                "idle_gaps": [[n, t / 1e9] for n, t in idle]}


def is_kernel(record: str, kernel: str) -> bool:
    """Whether a device record's name is ``kernel``'s, demangled (``void
    (anonymous namespace)::gather_kernel<false>(float const*, ...)``) or
    mangled."""
    if record.startswith("_Z"):
        return kernel in record
    head = record.replace("(anonymous namespace)::", "").split("(")[0]
    return head.split("<")[0].split(" ")[-1].split("::")[-1] == kernel


def _union(records, window) -> List[Tuple[int, int]]:
    """Merged device intervals, clipped to ``window``."""
    lo, hi = window
    spans = sorted((max(a, lo), min(b, hi)) for _, a, b in records
                   if b > lo and a < hi)
    out: List[List[int]] = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _gaps(union, window) -> List[Tuple[int, int]]:
    lo, hi = window
    out, cur = [], lo
    for a, b in union:
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        out.append((cur, hi))
    return out


def _read(prof) -> Tuple[list, list, Optional[Tuple[int, int]]]:
    from torch.autograd import DeviceType
    device, cpu, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            # The marker's span on the device's timeline is an
            # annotation, not work.
            if e.name() != MARKER and not getattr(
                    e, "is_user_annotation", lambda: False)():
                device.append((e.name(), a, b))
        else:
            if e.name() == MARKER:
                window = (a, b)
            cpu.append((e.name(), a, b))
    return device, cpu, window


def traced(run: Callable, counters: Callable[[], Dict[str, int]],
           kernels: Dict[str, Tuple[str, ...]], sync: Callable,
           log: Callable[[str], None]):
    """Runs ``run(span)`` under the profiler until a trace is whole:
    ``run`` returns the window and enters ``span()`` around the interval
    whose requests the window counts, which the trace takes as its
    window. ``counters()`` reads the program's launch counters
    by kernel, ``kernels`` maps each to the kernels it launches.
    Returns ``(window, trace)``; the trace is the last one read (with
    ``whole`` False) when no attempt was whole, and None when no attempt
    gave any device record."""
    from torch.profiler import ProfilerActivity, profile, record_function
    last = None
    win = None
    for attempt in range(1, ATTEMPTS + 1):
        c0 = counters()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            win = run(lambda: record_function(MARKER))
            sync()
        c1 = counters()
        device, cpu, window = _read(prof)
        if not device or window is None:
            log(f"profiler: attempt {attempt} of {ATTEMPTS} gave no device "
                f"records")
            continue
        last = Trace(device, cpu, window,
                     sum(b - a for a, b in _union(device, window)), False)
        short = {k: (c1[k] - c0[k], len(last.records(*names)))
                 for k, names in kernels.items()}
        # Batches in flight when the session starts or ends make a few
        # records more or fewer than the launches; a lost trace misses
        # far more.
        last.whole = all(abs(n - seen) <= max(2, SLACK * n)
                         for n, seen in short.values())
        if last.whole:
            return win, last
        log(f"profiler: attempt {attempt} of {ATTEMPTS}: launches counted "
            f"/ device records {short}; taken again")
    return win, last
