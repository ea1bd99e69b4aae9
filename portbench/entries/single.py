"""Closed-loop single photos through ``FaceDetector.detect``.

One client calls ``detect`` on one pool scene after another, in the run's
order, with no think time; the call returns after the result pull, so
each request's host-clock span is its whole latency, copy in included.
"""

from __future__ import annotations

import contextlib
import time
from typing import List

import numpy as np

from portbench.core import Request, Window


class Loop:
    def __init__(self, det, pool: List[np.ndarray], order: List[int],
                 mix: dict):
        self.det, self.pool, self.order = det, pool, order
        self.attributes = bool(mix["attributes"])
        self.warm_requests = int(mix["warm_requests"])
        self._i = 0

    def _call(self) -> Request:
        scene = self.order[self._i % len(self.order)]
        self._i += 1
        t = time.perf_counter()
        dets = self.det.detect(self.pool[scene],
                               estimate_attributes=self.attributes)
        return Request(scene, dets, t, time.perf_counter())

    def warm(self) -> None:
        for _ in range(self.warm_requests):
            self._call()

    def run(self, seconds: float, span=contextlib.nullcontext) -> Window:
        reqs: List[Request] = []
        with span():
            t0 = time.perf_counter()
            deadline = t0 + seconds
            while time.perf_counter() < deadline:
                reqs.append(self._call())
        return Window(t0, reqs)

    def close(self) -> None:
        pass
