"""A copy of the benchmark at a size the CPU runs in seconds, for the tests
of ``portbench/tests``: the same files, with every mix cut to a few small
scenes and every configuration sampling through the kernels' plain
versions (``pallas_refine="ref"``, the route the card takes with the
kernels)."""

from __future__ import annotations

import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
TINY = dict(width=320, height=256, pool=4, batch=2, warm_batches=1,
            warm_requests=1, trace_seconds=1)
# One face per scene, or a 2x1 grid of cells for the cell layouts.
FACES = {"free": dict(faces=1, side=[110, 120]),
         "cells": dict(faces=2, side=[100, 110], cells=[2, 1])}


def tiny_copy(tmp: str) -> tuple:
    """``(root, bench)`` of a tiny copy of the benchmark under ``tmp``."""
    root = os.path.join(tmp, "checkout")
    bench = os.path.join(root, "portbench")
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "out", ".cache", "__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    for fn in os.listdir(os.path.join(bench, "mixes")):
        path = os.path.join(bench, "mixes", fn)
        mix = json.load(open(path))
        mix.update(TINY, **FACES[mix.get("layout", "free")])
        mix["layout"] = mix.get("layout", "free")
        json.dump(mix, open(path, "w"))
    for fn in os.listdir(os.path.join(bench, "configs")):
        path = os.path.join(bench, "configs", fn)
        cfg = json.load(open(path))
        cfg["detector"]["pallas_refine"] = "ref"
        json.dump(cfg, open(path, "w"))
    return root, bench


def cells() -> list:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]
