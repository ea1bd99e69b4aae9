"""Closed-loop bulk traffic through ``FaceDetector.detect_stream``.

One client feeds an endless iterator of batches of ``batch`` pool scenes,
in the run's order, to one stream with ``depth`` batches in flight; each
image of a yielded batch is one completed request. The stream runs from
the warm-up on, so the pipeline is full and steady when a window starts:
the window opens at the first yield of the run and holds every batch the
stream yields after it, up to and including the first yield past
``seconds``. A traced run's span covers the same interval, so that what
the trace counts and the images it is divided by agree.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, List

import numpy as np

from portbench.core import Request, Window


class Loop:
    def __init__(self, det, pool: List[np.ndarray], order: List[int],
                 mix: dict):
        self.pool, self.order = pool, order
        self.batch = int(mix["batch"])
        self.warm_batches = int(mix["warm_batches"])
        self._gen = det.detect_stream(
            self._batches(), estimate_attributes=bool(mix["attributes"]),
            depth=int(mix["depth"]))
        self._yielded = 0
        self._t_last = time.perf_counter()

    def _scenes(self, j: int) -> List[int]:
        n = len(self.order)
        return [self.order[(j * self.batch + k) % n]
                for k in range(self.batch)]

    def _batches(self) -> Iterator[List[np.ndarray]]:
        j = 0
        while True:
            yield [self.pool[i] for i in self._scenes(j)]
            j += 1

    def _next(self):
        out = next(self._gen)
        self._t_last = time.perf_counter()
        scenes = self._scenes(self._yielded)
        self._yielded += 1
        return scenes, out

    def warm(self) -> None:
        """Fills the pipeline and runs every shape of the cell."""
        for _ in range(self.warm_batches):
            self._next()

    def run(self, seconds: float, span=contextlib.nullcontext) -> Window:
        # The window opens and closes at a yield, so it holds whole batches.
        self._next()
        t0 = self._t_last
        deadline = t0 + seconds
        reqs: List[Request] = []
        with span():
            while self._t_last <= deadline:
                scenes, out = self._next()
                reqs.extend(Request(s, d, None, self._t_last)
                            for s, d in zip(scenes, out))
        return Window(t0, reqs)

    def close(self) -> None:
        self._gen.close()
