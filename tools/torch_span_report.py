#!/usr/bin/env python3
"""What the serving path's spans read in a traced window of a benchmark
cell, on the card.

    python3 tools/torch_span_report.py --workload CELL --seed N
        [--workload CELL --seed N ...] [--out FILE] [--costs]

Runs each cell as ``python3 -m portbench.run --trace 1`` does (the pool
from the seed, the detector, the warmed loop, a ``torch.profiler``
session around the mix's ``trace_seconds``, taken again until whole) and
reads the spans of ``pyfaceanalysis_torch.utils.profiling`` against the
trace:

- ``metrics``: the benchmark's span metrics (``source`` ``program_span``
  or ``program_counter`` in ``BENCHMARK.json``), through their readers;
- ``spans_per_request``: spans that lie in the window, by name, per
  ``detect`` call or per stream batch;
- ``span_ms_per_image``: the summed duration of those spans, by name, per
  image (ms; nested spans count in each of their names);
- ``coverage``: in a single cell the share of each ``pfa.detect`` that its
  ``pfa.upload``, ``pfa.dispatch`` and ``pfa.finish`` cover (least,
  median); in a stream cell the share of the window that each thread's
  spans cover;
- ``idle_in_launcher_spans``: the share of the device's idle time in the
  window that lies inside a span of the launching (caller's) thread;
- ``clock``: each ``record_function`` span's start and end against its
  event in the trace, and in a stream each result pull's end against the
  end of its device-to-host copy (us);
- ``device_span_records``: device records named ``pfa.*`` (annotations,
  which the benchmark's trace reader must drop: 0);
- ``idle_by_thread``: for each thread, the device's idle time in the
  window by the innermost span that thread was in (``-`` for none), in
  seconds: what every thread did while the card waited.

``--costs`` also times a span with tracing off (the flag test and the
shared no-op context) and on (the session's thread and a helper
thread), and whether a host-to-device copy waits for the work queued
before it. Prints one JSON line per cell (and one of the costs) and
writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from collections import Counter, defaultdict
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CHILDREN = ("pfa.upload", "pfa.dispatch", "pfa.finish")


def _traced_cell(workload: str, seed: int):
    import torch

    from portbench import run as R
    from portbench import trace as T

    files = R.cell_files(workload)
    config, mix = files["config"], files["mix"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    threads = config.get("assumed", {}).get("torch_threads")
    if threads:
        torch.set_num_threads(int(threads))
    dev = torch.device("cuda")
    pool, order = R.make_pool(mix, seed, dev)
    det = R.make_detector(config, dev)
    loop = R.make_loop(det, mix, pool, order)
    seconds = float(mix["trace_seconds"])
    win, tr = T.traced(lambda span: loop.run(seconds, span),
                       R._launch_counters(), R.KERNELS,
                       torch.cuda.synchronize, R.log)
    loop.close()
    return files["manifest"], mix, win, tr


def _quantiles(xs):
    xs = sorted(xs)
    if not xs:
        return None
    return {"n": len(xs), "min": xs[0], "median": statistics.median(xs),
            "max": xs[-1]}


def _clock(tr, got):
    """Offsets of the traced spans against their trace events (us)."""
    events = defaultdict(list)
    for name, a, b in tr.cpu:
        events[name].append((a, b))
    for v in events.values():
        v.sort()
    starts, ends = [], []
    for s in got:
        if not s.traced or s.name not in events:
            continue
        ev = events[s.name]
        i = bisect.bisect_right(ev, (s.start_ns, 1 << 62)) - 1
        if i < 0:
            continue
        a, b = ev[i]
        starts.append((s.start_ns - a) / 1e3)
        ends.append((b - s.end_ns) / 1e3)
    return {"span_start_after_event_us": _quantiles(starts),
            "event_end_after_span_us": _quantiles(ends)}


def _pull_offsets(tr, got):
    """Every ``pfa.pull`` of the window matched, in order, to the
    device-to-host copies (one copy each, enqueued at the pull's start,
    run in the order enqueued on one stream; 2 ms of slack for the
    clocks): each finisher result pull's end minus its copy's end (us),
    and each copy's start minus its pull's start (us), in the order of
    the window, which shows how the device records' clock drifts against
    the host's."""
    lo, hi = tr.window
    by_id = {s.id: s for s in got}
    pulls = sorted((s for s in got if s.name == "pfa.pull"
                    and lo <= s.start_ns < hi), key=lambda s: s.start_ns)
    copies = sorted((a, b) for name, a, b in tr.device if "DtoH" in name)
    slack = 2_000_000
    ends, starts, j = [], [], 0
    for s in pulls:
        while j < len(copies) and copies[j][1] < s.start_ns - slack:
            j += 1
        if j == len(copies) or copies[j][0] > s.end_ns + slack:
            continue
        a, b = copies[j]
        j += 1
        starts.append(round((a - s.start_ns) / 1e3, 1))
        parent = by_id.get(s.parent)
        if parent is not None and parent.name == "pfa.finish":
            ends.append(round((s.end_ns - b) / 1e3, 1))
    return {"result_pull_minus_copy_end_us": ends,
            "copy_minus_pull_start_us": starts, "pulls": len(pulls)}


def _innermost(spans):
    """Disjoint ``(start, end, name)`` pieces of one thread's nested spans,
    each named by the innermost span open over it."""
    out, stack, cur = [], [], None
    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        while stack and stack[-1].end_ns <= s.start_ns:
            top = stack.pop()
            out.append((cur, top.end_ns, top.name))
            cur = top.end_ns
        if stack:
            out.append((cur, s.start_ns, stack[-1].name))
        cur = s.start_ns
        stack.append(s)
    while stack:
        top = stack.pop()
        out.append((cur, top.end_ns, top.name))
        cur = top.end_ns
    return [p for p in out if p[1] > p[0]]


def _idle_by_thread(got, idle):
    """Seconds of the idle gaps ``idle`` by each thread's innermost span."""
    total = sum(b - a for a, b in idle)
    out = {}
    for thread in sorted({s.thread for s in got}):
        by = defaultdict(int)
        pieces = _innermost([s for s in got if s.thread == thread])
        i = 0
        for a, b, name in pieces:
            while i < len(idle) and idle[i][1] <= a:
                i += 1
            j = i
            while j < len(idle) and idle[j][0] < b:
                by[name] += min(b, idle[j][1]) - max(a, idle[j][0])
                j += 1
        by["-"] = total - sum(by.values())
        top = sorted(by.items(), key=lambda kv: -kv[1])[:8]
        out[thread] = {k: round(v / 1e9, 4) for k, v in top}
    return out


def report(workload: str, seed: int) -> dict:
    from portbench import run as R
    from portbench import spans as S
    from portbench import trace as T
    from pyfaceanalysis_torch.utils import profiling

    manifest, mix, win, tr = _traced_cell(workload, seed)
    if tr is None:
        return {"workload": workload, "seed": seed, "error": "no trace"}
    lo, hi = tr.window
    ctx = SimpleNamespace(trace=tr, images=len(win.requests), window=win)
    got = profiling.spans(lo, hi) or []
    inside = [s for s in got if s.start_ns >= lo and s.end_ns <= hi]
    out = {"workload": workload, "seed": seed, "whole": tr.whole,
           "window_s": tr.window_s, "images": ctx.images,
           "busy_s": tr.busy_s, "dropped": profiling.dropped(),
           "metrics": {}}
    for m in R.cell_metrics(manifest, workload, "per_layer"):
        if m["source"] in ("program_span", "program_counter"):
            out["metrics"][m["name"]] = R.metric_reader(m["name"]).read(ctx)
    stream = mix["entry"] == "stream"
    requests = ctx.images / int(mix.get("batch", 1))
    names = Counter(s.name for s in inside)
    out["requests_in_window"] = requests
    out["spans_per_request"] = {
        k: round(v / max(requests, 1), 3) for k, v in sorted(names.items())}
    out["spans_per_request_total"] = round(len(inside) / max(requests, 1),
                                           3)
    ms = defaultdict(int)
    for s in inside:
        ms[s.name] += s.end_ns - s.start_ns
    out["span_ms_per_image"] = {
        k: round(v / 1e6 / max(ctx.images, 1), 4) for k, v in sorted(
            ms.items())}
    window = tr.window
    idle = T._gaps(T._union(tr.device, window), window)
    idle_ns = sum(b - a for a, b in idle)
    launcher = {s.thread for s in got if s.name == "pfa.dispatch"}
    launch_spans = S.union(S.clipped(
        [s for s in got if s.thread in launcher], window))
    out["idle_s"] = idle_ns / 1e9
    out["idle_in_launcher_spans"] = (
        S.overlap_ns(idle, launch_spans) / idle_ns if idle_ns else None)
    if stream:
        threads = sorted({s.thread for s in got})
        out["coverage"] = {
            t: sum(b - a for a, b in S.union(S.clipped(
                [s for s in got if s.thread == t], window))) / (hi - lo)
            for t in threads}
        out["pull_clock"] = _pull_offsets(tr, got)
    else:
        kids = defaultdict(int)
        for s in got:
            if s.name in CHILDREN:
                kids[s.parent] += s.end_ns - s.start_ns
        shares = [kids[s.id] / (s.end_ns - s.start_ns) for s in inside
                  if s.name == "pfa.detect"]
        out["coverage"] = {"detect_children": _quantiles(shares)}
    out["clock"] = _clock(tr, got)
    out["device_span_records"] = sum(1 for r in tr.device
                                     if r[0].startswith("pfa."))
    out["idle_by_thread"] = _idle_by_thread(got, idle)
    return out


def costs() -> dict:
    """A span's cost off and on, and whether a host-to-device copy waits
    for the queue."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pyfaceanalysis_torch.utils import profiling

    n = 200_000
    flag = torch.autograd.profiler

    def per_call(body, k=n):
        t = time.perf_counter()
        body(k)
        return (time.perf_counter() - t) / k * 1e9

    def empty(k):
        for _ in range(k):
            pass

    def test_flag(k):
        for _ in range(k):
            flag._is_profiler_enabled

    def span(k):
        for _ in range(k):
            with profiling.annotate("pfa.pull"):
                pass

    base = per_call(empty)
    out = {"off_flag_ns": per_call(test_flag) - base,
           "off_span_ns": per_call(span) - base}
    res = {}
    with profile(activities=[ProfilerActivity.CPU]):
        out["on_session_thread_ns"] = per_call(span, 20_000) - base
        th = threading.Thread(
            target=lambda: res.update(ns=per_call(span, 20_000) - base))
        th.start()
        th.join()
    out["on_helper_thread_ns"] = res["ns"]
    x = torch.randn(8192, 8192, device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(10):
        x @ x
    queued = time.perf_counter() - t
    t = time.perf_counter()
    torch.as_tensor(np.zeros(4, np.float32), device="cuda")
    out["h2d_copy_s_behind_queue"] = time.perf_counter() - t
    out["enqueue_s"] = queued
    t = time.perf_counter()
    torch.cuda.synchronize()
    out["sync_after_copy_s"] = time.perf_counter() - t
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", action="append", default=[])
    ap.add_argument("--seed", type=int, action="append", default=[])
    ap.add_argument("--out", default=None)
    ap.add_argument("--costs", action="store_true")
    args = ap.parse_args()
    import torch
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    lines = [{"torch": torch.__version__, "cuda": torch.version.cuda,
              "card": card.strip()}]
    if args.costs:
        lines.append({"costs": costs()})
    for w, seed in zip(args.workload, args.seed):
        lines.append(report(w, seed))
    for line in lines:
        print(json.dumps(line), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
