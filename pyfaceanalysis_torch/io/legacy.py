"""File discovery helper of the reference's ``object_cache``.

Only :func:`find_filenames_beginning_with` is needed by the port (pipeline
discovery in ``engine.detector.DetectionModel.load``); the legacy pickle
converter of the JAX package is not ported yet.
"""

from __future__ import annotations

import os
from typing import List


def find_filenames_beginning_with(base_dir: str, prefix: str,
                                  recursion: bool = False,
                                  extension: str = ".txt") -> List[str]:
    """Sorted listing of files starting with ``prefix`` and ending with
    ``extension`` (mirror of ``object_cache.find_filenames_beginning_with``,
    used by pipeline discovery at FaceDetectUpdated.py:153)."""
    out = []
    if recursion:
        for root, _dirs, files in os.walk(base_dir):
            for fn in files:
                if fn.startswith(prefix) and fn.endswith(extension):
                    out.append(os.path.join(root, fn))
    else:
        if os.path.isdir(base_dir):
            for fn in os.listdir(base_dir):
                if fn.startswith(prefix) and fn.endswith(extension):
                    out.append(os.path.join(base_dir, fn))
    return sorted(out)
