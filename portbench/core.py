"""What every part of the benchmark shares: where its files are, how a file
is found by its name, and the records of a measured window."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from types import ModuleType
from typing import Any, List, Optional

BENCH = os.path.dirname(os.path.abspath(__file__))


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def find(kind: str, name: str, suffix: str, bench: str = BENCH) -> str:
    """The file of ``name`` under ``<bench>/<kind>/``; raises naming it
    when it is not there."""
    path = os.path.join(bench, kind, name + suffix)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{kind} {name!r}: no file {path}")
    return path


def load_module(kind: str, name: str, bench: str = BENCH) -> ModuleType:
    """The Python file of ``name`` under ``<bench>/<kind>/``, imported by
    its path (names may hold dots)."""
    path = find(kind, name, ".py", bench)
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Request:
    """One completed request: the pool scene it carried, the program's
    detections of it, and host-clock times of its call (None where the
    loop cannot see a request's own start, as in a stream) and of its
    result."""

    scene: int
    dets: list
    start: Optional[float]
    end: float


@dataclasses.dataclass
class Window:
    """A measured window: its host-clock start and the requests (images)
    completed in it, in order."""

    t0: float
    requests: List[Request]

    @property
    def t_last(self) -> float:
        return self.requests[-1].end if self.requests else self.t0
