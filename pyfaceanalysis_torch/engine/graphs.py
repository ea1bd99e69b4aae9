"""A dispatch's device work as one CUDA graph per shape: captured once,
replayed after.

``FaceDetector._dispatch_one`` and ``_dispatch_fused`` enqueue the same
device work whenever the shapes are the same: the pyramid, the 17 stages
with both CUDA kernels, the rungs, the eye pass and the output block,
about 2,700 launches for one image. :class:`GraphCache` runs that work
eagerly on the first dispatch of a key (which warms every lazy
initialisation), captures it into a ``torch.cuda.CUDAGraph`` on the
second, and replays the graph on every later one. The key is whatever
fixes the shapes (the detector's: canvas shape, grid key, output width);
a shape met once is never captured.

A graph reads its input from, and writes its output to, fixed tensors: a
replay copies the caller's canvas (stack) into the static input on the
current stream and returns a clone of the static output, so that several
results can be in flight at once. Everything else the work reads (the
weights, the grid state, the scale table, the wire constants) is made
before the capture and lives as long as the detector.

The crop and gather wrappers count their launches when they are called;
a capture calls them without running anything, so a capture takes its
counts back and every replay adds them again.

A cache runs one dispatch at a time: the static input and output are
shared, so the copy, the replay and the clone of one call are enqueued
before another call's. Callers make the detector's card the current
device.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Hashable, Tuple

import torch

from pyfaceanalysis_torch.ops import cuda_crop, cuda_gather
from pyfaceanalysis_torch.utils.profiling import annotate

# Keys a cache remembers, captured or seen once, least recently used
# dropped first; a dropped graph frees its memory pool.
MAX_GRAPHS = 4

_COUNTED = (cuda_crop.KERNEL, cuda_gather.KERNEL)

Work = Callable[[torch.Tensor], torch.Tensor]


class Graph:
    """A captured dispatch: the graph, its static input and output, and
    the kernel launches one replay makes (per counted kernel)."""

    def __init__(self, graph, static_in: torch.Tensor,
                 static_out: torch.Tensor, launches: Tuple[int, ...]):
        self.graph, self.static_in, self.static_out = (graph, static_in,
                                                       static_out)
        self.launches = launches

    def replay(self, inp: torch.Tensor) -> torch.Tensor:
        self.static_in.copy_(inp)
        self.graph.replay()
        for kernel, n in zip(_COUNTED, self.launches):
            kernel.launches += n
        return self.static_out.clone()


def capture(inp: torch.Tensor, work: Work) -> Graph:
    """Captures ``work`` over a static copy of ``inp``'s shape. Other
    threads may use the card meanwhile (``thread_local`` mode)."""
    static_in = torch.empty_like(inp)
    graph = torch.cuda.CUDAGraph()
    before = [k.launches for k in _COUNTED]
    with torch.cuda.graph(graph, stream=torch.cuda.Stream(),
                          capture_error_mode="thread_local"):
        static_out = work(static_in)
    launches = tuple(k.launches - n for k, n in zip(_COUNTED, before))
    for k, n in zip(_COUNTED, before):
        k.launches = n                  # nothing ran
    return Graph(graph, static_in, static_out, launches)


class GraphCache:
    """The graphs of one detector, at most :data:`MAX_GRAPHS` keys."""

    def __init__(self):
        self._keys: OrderedDict = OrderedDict()   # key -> Graph | None
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return sum(g is not None for g in self._keys.values())

    def run(self, key: Hashable, inp: torch.Tensor, work: Work
            ) -> Tuple[torch.Tensor, bool]:
        """``work(inp)``: eagerly on the key's first call, through a
        capture on its second, by a replay after. Returns the result and
        whether it came from a replay of an earlier capture."""
        with self._lock:
            return self._run(key, inp, work)

    def _run(self, key, inp, work):
        if key not in self._keys:
            self._keys[key] = None
            if len(self._keys) > MAX_GRAPHS:
                self._keys.popitem(last=False)
            return work(inp), False
        self._keys.move_to_end(key)
        graph = self._keys[key]
        if graph is None:
            with annotate("pfa.graph.capture"):
                graph = self._keys[key] = capture(inp, work)
            return graph.replay(inp), False
        return graph.replay(inp), True
