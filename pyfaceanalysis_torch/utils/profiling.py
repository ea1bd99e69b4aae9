"""Profiling facade: phase timers (utils.benchmark), torch.profiler traces
and the serving path's spans.

Port of ``pyfaceanalysis_tpu.utils.profiling``. The reference's
observability is the label-keyed ``Benchmark`` timer table
(benchmarking.py:11-108). The interesting time is on the DEVICE, which host
timers cannot attribute -- this module adds the torch.profiler hooks:

    with trace("pfa-trace"):                # Chrome trace under pfa-trace/
        detector.detect(image)

    with annotate("pfa.nms", rows_in=n) as span:   # a span, with counts
        ...
        span.update(kept=k)

A trace records CPU activity and, where a card is present, CUDA activity,
and is written as ``trace_<pid>_<n>.json`` under the given directory; open
it in ``chrome://tracing`` or Perfetto. It carries the spans of every
thread.

**Spans.** :func:`annotate` is off while no ``torch.profiler`` session runs
in the process: it then returns one shared no-op context, which reads no
clock and allocates nothing. While a session runs, each span records its
name, its thread, its start and end on ``time.time_ns()`` (the epoch clock
of the profiler's own events, so spans and device records share one
timeline), its parent (the span open on the same thread when it started),
the request it serves (given, or its parent's, or for a root span its own
id) and its counts. On the thread that started the session the span also
enters ``record_function(name)``, so it shows in the trace's CPU events.
Spans go to a bounded in-memory log; :func:`spans` reads it.

The serving path's spans (``engine/detector.py``, ``engine/upload.py``,
``engine/cascade.py``, ``engine/eyes.py``, ``engine/heads.py``), with
their counts in brackets:

- ``pfa.detect``: one ``FaceDetector.detect`` call;
- ``pfa.upload`` [bytes, pinned]: a canvas (batch) to the device
  (``engine/upload.py``); ``bytes`` the host sent to the card, ``pinned``
  1 when they left from a pinned staging slot without blocking, 0 on the
  host's rounding (the CPU, dtypes other than float32 and float64);
- ``pfa.upload.wait``: the host waiting for a staging slot's earlier copy
  to complete before it writes the slot again;
- ``pfa.dispatch`` [graph]: from the grid to the enqueued result block;
  ``graph`` is 1 when the block came from a replay of the dispatch's
  CUDA graph (``engine/graphs.py``), else 0;
- ``pfa.graph.capture``: the capture of a dispatch's or the heads' CUDA
  graph;
- ``pfa.grid`` [rows, real]: the window grid, cached or tracking;
- ``pfa.pyramid``: the scale pyramid;
- ``pfa.stage.NN.<Kind>`` [rows]: cascade stage NN (00-16) of its kind;
- ``pfa.rung`` [rows_in, rows_out]: a compaction rung that fires;
- ``pfa.eyes`` [rows]: ranking, the eye passes and the output block;
- ``pfa.finish`` [images]: after the block is enqueued: pull, NMS,
  heads, ``Detection`` assembly;
- ``pfa.pull``: a blocking device-to-host copy;
- ``pfa.nms`` [rows_in, kept]: host NMS of the pulled rows;
- ``pfa.heads`` [faces, bucket, graph]: the attribute heads' device
  program over ``faces`` faces padded to ``bucket`` rows; ``graph`` is 1
  when it came from a replay of the heads' CUDA graph
  (``engine/heads.py``), else 0;
- ``pfa.assemble`` [detections]: the ``Detection`` lists;
- ``pfa.stream.wait_input`` / ``pfa.stream.wait_result``:
  ``detect_stream``'s caller waiting for the producer's next batch / for
  the finisher's next result;
- ``pfa.stream.producer_wait`` / ``pfa.stream.finisher_wait``: the
  producer blocked on a full queue / the finisher waiting for a
  dispatched batch.

``rows`` are bucket rows (padding included), ``real`` the grid's windows
over all images of the grid; a stream batch's spans carry its index as
their request. The pyramid, stage, rung and eye spans are made while the
host enqueues that work: eagerly, or once while a graph is captured. A
replayed dispatch holds only ``pfa.grid`` (and ``pfa.upload`` where it
copies its batch itself).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

_trace_ids = itertools.count()
_span_ids = itertools.count(1)
# Spans the log holds; the oldest are dropped beyond it (a traced detect
# makes about 30, a traced stream batch about 35).
LOG_SPANS = 1 << 17


class Span(NamedTuple):
    """One closed span; times are ``time.time_ns()``."""

    id: int
    parent: Optional[int]
    request: object
    name: str
    thread: str
    tid: int
    start_ns: int
    end_ns: int
    counts: Dict[str, int]
    traced: bool            # also a record_function region of the trace


class SpanLog:
    """A bounded log of closed spans that counts the spans it dropped and
    remembers the latest end among them."""

    def __init__(self, size: int = LOG_SPANS):
        self._spans: deque = deque(maxlen=size)
        self._lock = threading.Lock()
        self.dropped = 0
        self.dropped_until = -1

    def add(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                old = self._spans[0]
                self.dropped += 1
                self.dropped_until = max(self.dropped_until, old.end_ns)
            self._spans.append(span)

    def between(self, t0_ns: int, t1_ns: int) -> List[Span]:
        """The held spans that overlap ``[t0_ns, t1_ns)``."""
        with self._lock:
            held = list(self._spans)
        return [s for s in held if s.end_ns > t0_ns and s.start_ns < t1_ns]


_LOG = SpanLog()
_local = threading.local()


class _Off:
    """The shared context of a span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def update(self, **counts) -> None:
        pass


_OFF = _Off()


class _On:
    __slots__ = ("name", "request", "counts", "id", "parent", "start",
                 "region")

    def __init__(self, name: str, request, counts: dict):
        self.name, self.request, self.counts = name, request, counts

    def update(self, **counts) -> None:
        """Adds counts known only inside the span."""
        self.counts.update(counts)

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_span_ids)
        parent = stack[-1] if stack else None
        self.parent = parent.id if parent is not None else None
        if self.request is None:
            self.request = (parent.request if parent is not None
                            else self.id)
        self.region = None
        if torch._C._autograd._profiler_enabled():  # the session's thread
            self.region = record_function(self.name)
            self.region.__enter__()
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _local.stack.pop()
        if self.region is not None:
            self.region.__exit__(*exc)
        thread = threading.current_thread()
        _LOG.add(Span(self.id, self.parent, self.request, self.name,
                      thread.name, thread.native_id or 0, self.start, end,
                      self.counts, self.region is not None))
        return False


def annotate(name: str, request=None, **counts):
    """A span named ``name`` with integer ``counts`` (more through the
    context's ``update``), serving ``request`` (default: its parent's);
    the shared no-op while no profiler session runs. See the module's
    docstring for the names the serving path uses."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _On(name, request, counts)


def spans(t0_ns: int, t1_ns: int) -> Optional[List[Span]]:
    """The logged spans that overlap ``[t0_ns, t1_ns)`` (epoch ns), in the
    order they closed; None when the log dropped a span that ended after
    ``t0_ns``, as it can no longer tell what that interval held."""
    if _LOG.dropped_until > t0_ns:
        return None
    return _LOG.between(t0_ns, t1_ns)


def dropped() -> int:
    """Spans the log has dropped since the process started."""
    return _LOG.dropped


def _add_spans(path: str, t0_ns: int, t1_ns: int) -> None:
    """Appends to an exported Chrome trace the spans of ``[t0_ns, t1_ns)``
    that are not in it already: those of every thread but the session's
    (whose spans are its ``record_function`` regions)."""
    extra = [s for s in _LOG.between(t0_ns, t1_ns) if not s.traced]
    if not extra:
        return
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = doc.setdefault("traceEvents", [])
    for tid, name in {s.tid: s.thread for s in extra}.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": name}})
    for s in extra:
        events.append({
            "ph": "X", "cat": "pfa_span", "name": s.name, "pid": pid,
            "tid": s.tid, "ts": (s.start_ns - base) / 1e3,
            "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": dict(s.counts, span=s.id, parent=s.parent,
                         request=str(s.request))})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """torch.profiler.profile wrapper. A profiler that cannot start is
    reported and the body runs unprofiled; an exception of the body itself
    always propagates. The exported trace holds the spans of every
    thread."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        os.makedirs(log_dir, exist_ok=True)
        prof = profile(activities=activities)
        t0 = time.time_ns()
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
            path = os.path.join(
                log_dir, f"trace_{os.getpid()}_{next(_trace_ids)}.json")
            prof.export_chrome_trace(path)
            _add_spans(path, t0, time.time_ns())
        except Exception as e:    # a lost trace never fails the traced run
            print(f"[profiling] trace not written ({e})")


@contextlib.contextmanager
def maybe_trace(log_dir: Optional[str]) -> Iterator[None]:
    """trace(log_dir) when a directory is given, else a no-op."""
    if log_dir:
        with trace(log_dir):
            yield
    else:
        yield
