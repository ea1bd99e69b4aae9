"""Phase-timer facade -- port of the reference's ``benchmarking.Benchmark``.

Reference: benchmarking.py:11-108 -- label-keyed cumulative timers with named
reference clocks, an ``add_task_from_previous_time`` phase boundary API and a
``display()`` table; instantiated disabled in production
(FaceDetectUpdated.py:129). The label set is kept compatible so perf diffs
against the reference are comparable. For kernel-level profiling use
``utils.profiling.trace``; this class times the host-visible phase
boundaries (which include the device only where the caller waits for its
results).
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple


class Benchmark:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._order: List[str] = []
        self._refs: Dict[str, float] = {"a": time.time()}
        self._default_ref = "a"

    def update_start_time(self, reference: str = None) -> None:
        if not self.enabled:
            return
        self._refs[reference or self._default_ref] = time.time()

    def set_default_reference(self, reference: str) -> None:
        self._default_ref = reference
        self._refs.setdefault(reference, time.time())

    def add_task_from_previous_time(self, label: str,
                                    reference: str = None) -> None:
        """Accumulates the elapsed time since the reference clock and resets
        it (the reference's phase-boundary idiom)."""
        if not self.enabled:
            return
        ref = reference or self._default_ref
        now = time.time()
        dt = now - self._refs.get(ref, now)
        self._refs[ref] = now
        if label not in self._totals:
            self._totals[label] = 0.0
            self._counts[label] = 0
            self._order.append(label)
        self._totals[label] += dt
        self._counts[label] += 1

    def items(self) -> List[Tuple[str, float, int]]:
        return [(lb, self._totals[lb], self._counts[lb]) for lb in self._order]

    def display(self) -> str:
        if not self.enabled:
            return "(benchmark disabled)"
        lines = ["%-60s %10s %10s %8s" % ("task", "total[s]", "avg[ms]",
                                          "count")]
        for lb, tot, cnt in self.items():
            lines.append("%-60s %10.3f %10.2f %8d"
                         % (lb[:60], tot, 1000.0 * tot / max(cnt, 1), cnt))
        out = "\n".join(lines)
        print(out)
        return out


if __name__ == "__main__":
    # Self-test, mirroring the reference module's __main__ exercise
    # (benchmarking.py:111-141).
    b = Benchmark(enabled=True)
    for i in range(3):
        b.update_start_time()
        time.sleep(0.01)
        b.add_task_from_previous_time("sleep 10ms")
    b.set_default_reference("networks")
    time.sleep(0.02)
    b.add_task_from_previous_time("network phase", reference="networks")
    b.display()
    disabled = Benchmark(enabled=False)
    disabled.add_task_from_previous_time("ignored")
    assert disabled.display() == "(benchmark disabled)"
    print("Benchmark self-test OK")
