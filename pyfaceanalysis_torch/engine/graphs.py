"""A dispatch's device work as one CUDA graph per shape: captured once,
replayed after.

``FaceDetector._dispatch_one`` and ``_dispatch_fused`` enqueue the same
device work whenever the shapes are the same: the pyramid, the 17 stages
with the CUDA kernels, the rungs, the eye pass and the output block,
about 1,300 launches for one image. :class:`GraphCache` runs that work
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

The attribute heads (``engine/heads.py``) use a cache of their own, keyed
by canvas stack shape, face bucket and crop count, whose work takes a
tuple of inputs (the stack and the face table): each is copied into its
own static tensor, and the work is called with them in order.

The crop, gather and layer kernels' wrappers count their launches when
they are called; a capture calls them without running anything, so a
capture takes its counts back and every replay adds them again.

A cache runs one dispatch at a time: the static input and output are
shared, so the copy, the replay and the clone of one call are enqueued
before another call's. Callers make the detector's card the current
device.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Hashable, Tuple, Union

import torch

from pyfaceanalysis_torch.ops import cuda_crop, cuda_gather, cuda_net_layer
from pyfaceanalysis_torch.utils.profiling import annotate

# Keys a cache remembers, captured or seen once, least recently used
# dropped first; a dropped graph frees its memory pool.
MAX_GRAPHS = 4

_COUNTED = (cuda_crop.KERNEL, cuda_gather.KERNEL, cuda_net_layer.KERNEL)

# One tensor (a dispatch's canvas) or a tuple of them (the heads' inputs).
Inputs = Union[torch.Tensor, Tuple[torch.Tensor, ...]]
Work = Callable[..., torch.Tensor]


def _each(inp: Inputs) -> Tuple[torch.Tensor, ...]:
    return inp if isinstance(inp, tuple) else (inp,)


class Graph:
    """A captured dispatch (or heads' program): the graph, its static
    input(s) and output, and the kernel launches one replay makes (per
    counted kernel)."""

    def __init__(self, graph, static_in: Inputs,
                 static_out: torch.Tensor, launches: Tuple[int, ...]):
        self.graph, self.static_in, self.static_out = (graph, static_in,
                                                       static_out)
        self.launches = launches

    def replay(self, inp: Inputs) -> torch.Tensor:
        for static, x in zip(_each(self.static_in), _each(inp)):
            static.copy_(x)
        self.graph.replay()
        for kernel, n in zip(_COUNTED, self.launches):
            kernel.launches += n
        return self.static_out.clone()


def capture(inp: Inputs, work: Work) -> Graph:
    """Captures ``work`` over a static copy of ``inp``'s shape (of each
    tensor of a tuple). Other threads may use the card meanwhile
    (``thread_local`` mode)."""
    static_in = (tuple(torch.empty_like(x) for x in inp)
                 if isinstance(inp, tuple) else torch.empty_like(inp))
    graph = torch.cuda.CUDAGraph()
    before = [k.launches for k in _COUNTED]
    with torch.cuda.graph(graph, stream=torch.cuda.Stream(),
                          capture_error_mode="thread_local"):
        static_out = work(*_each(static_in))
    launches = tuple(k.launches - n for k, n in zip(_COUNTED, before))
    for k, n in zip(_COUNTED, before):
        k.launches = n                  # nothing ran
    return Graph(graph, static_in, static_out, launches)


class GraphCache:
    """The graphs of one detector's dispatches (or of its heads), at most
    :data:`MAX_GRAPHS` keys."""

    def __init__(self):
        self._keys: OrderedDict = OrderedDict()   # key -> Graph | None
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return sum(g is not None for g in self._keys.values())

    def run(self, key: Hashable, inp: Inputs, work: Work
            ) -> Tuple[torch.Tensor, bool]:
        """``work(inp)`` (``work(*inp)`` for a tuple): eagerly on the key's
        first call, through a capture on its second, by a replay after.
        Returns the result and whether it came from a replay of an earlier
        capture."""
        with self._lock:
            return self._run(key, inp, work)

    def _run(self, key, inp, work):
        if key not in self._keys:
            self._keys[key] = None
            if len(self._keys) > MAX_GRAPHS:
                self._keys.popitem(last=False)
            return work(*_each(inp)), False
        self._keys.move_to_end(key)
        graph = self._keys[key]
        if graph is None:
            with annotate("pfa.graph.capture"):
                graph = self._keys[key] = capture(inp, work)
            return graph.replay(inp), False
        return graph.replay(inp), True
