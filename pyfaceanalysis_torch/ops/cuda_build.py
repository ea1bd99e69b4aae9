"""Builds the CUDA kernels of ``ops/csrc`` and loads them with ctypes.

Each ``.cu`` source has a plain C interface (no PyTorch headers), so
``nvcc`` compiles it in seconds into a shared library under
``pyfaceanalysis_torch/_build/`` (listed in ``.gitignore``), named by a
hash of the source and the flags: an unchanged source is never rebuilt.
The wrapper modules (ops.cuda_crop, ops.cuda_gather) pass tensor pointers
and PyTorch's current stream as integers.

Nothing is built or imported at module import time; a kernel is built at
its first launch, or ahead of time by :func:`build_all`, which starts one
``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

# Hopper only: sm_90a (wgmma and setmaxnreg exist only for that target).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME/bin``, else from ``PATH``, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


class CudaLibrary:
    """One kernel source, its build, its loaded library and its count of
    launches.

    ``functions`` maps each exported C function to its ctypes argument
    types; every function returns an int (a ``cudaError_t``). The wrapper
    that launches the kernel adds one to ``launches`` per launch, so a run
    can show that it went through the kernel.
    """

    def __init__(self, source: str, functions: Dict[str, Sequence],
                 flags: Sequence[str] = NVCC_FLAGS):
        self.source = CSRC_DIR / source
        self.functions = dict(functions)
        self.flags = tuple(flags)
        self.build_log = ""
        self.launches = 0
        self._lib: Optional[ctypes.CDLL] = None

    @property
    def path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(self.flags).encode())
        return BUILD_DIR / f"lib{self.source.stem}_{h.hexdigest()[:16]}.so"

    def start_build(self) -> Optional[Tuple[subprocess.Popen, Path]]:
        """Starts ``nvcc`` in the background (None when already built).
        The output goes to a temporary name and is renamed on success, so
        a concurrent or interrupted build never leaves a partial library."""
        if self.path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *self.flags, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp

    def finish_build(self,
                     started: Optional[Tuple[subprocess.Popen, Path]]) -> None:
        if started is None:
            return
        proc, tmp = started
        self.build_log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"(exit {proc.returncode}):\n{self.build_log}")
        os.replace(tmp, self.path)

    def lib(self) -> ctypes.CDLL:
        """The loaded library, built first if needed."""
        if self._lib is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.path))
            for name, argtypes in self.functions.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib


def build_all(libraries: List[CudaLibrary]) -> None:
    """Builds every library in parallel (one nvcc each), then loads them."""
    started = [lib.start_build() for lib in libraries]
    errors = []
    for lib, st in zip(libraries, started):
        try:
            lib.finish_build(st)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for lib in libraries:
        lib.lib()


def check_launch(rc: int, name: str) -> None:
    """Raises on a refused launch (the C side returns cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
