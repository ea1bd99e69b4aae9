"""Converter for the reference's Python-2 classifier pickles.

The reference ships 20 trained ``mdp.nodes.GaussianClassifier`` pickles in
``SavedClassifiers/`` (schema verified in SURVEY.md section 2.2: ``means``,
``inv_covs``, ``_sqrt_def_covs``, ``p``, ``labels``, ``avg_labels``,
``_input_dim``). This module unpickles them WITHOUT requiring mdp/cuicuilco
(class definitions are stubbed) and converts them into
:class:`~pyfaceanalysis_torch.ops.gaussian.GaussianRegressor` modules
(port of ``pyfaceanalysis_tpu.io.legacy``).

The reference resolves pickles through ``cuicuilco.object_cache`` with
hash-stamped filenames (face_analysis.py:451-487); here a plain
prefix-matching loader stands in (:func:`find_filenames_beginning_with`
mirrors ``object_cache.find_filenames_beginning_with``).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, List

import numpy as np

from pyfaceanalysis_torch.ops.gaussian import GaussianRegressor


class _StubUnpickler(pickle.Unpickler):
    """Unpickler that substitutes plain attribute-bag classes for any class
    whose module is unavailable (mdp, cuicuilco, numpy legacy paths)."""

    def find_class(self, module: str, name: str):
        try:
            return super().find_class(module, name)
        except (ModuleNotFoundError, AttributeError):
            return type(name, (object,), {"__module__": module})


def load_legacy_pickle(path: str) -> Any:
    """Loads a Python-2 pickle with stubbed classes (latin-1 strings)."""
    with open(path, "rb") as f:
        return _StubUnpickler(f, encoding="latin1").load()


def gaussian_regressor_from_legacy(path: str) -> GaussianRegressor:
    """Converts a ``SavedClassifiers/*.pckl`` into a GaussianRegressor.

    The stored attributes map 1:1 (SURVEY.md section 2.2):
    ``means`` (list of C (D,) vectors), ``inv_covs`` (C, D, D),
    ``_sqrt_def_covs`` (C,) = sqrt(det(cov_c)), ``p`` (C,) priors,
    ``avg_labels`` (C,) per-class regression targets.
    """
    obj = load_legacy_pickle(path)
    d = obj.__dict__
    means = np.asarray(d["means"], dtype=np.float64)
    inv_covs = np.asarray(d["inv_covs"], dtype=np.float64)
    sqrt_det = np.asarray(d["_sqrt_def_covs"], dtype=np.float64)
    priors = np.asarray(d["p"], dtype=np.float64)
    avg_labels = np.asarray(d["avg_labels"], dtype=np.float64)
    if means.ndim != 2 or inv_covs.shape != means.shape + (means.shape[1],):
        raise ValueError(f"unexpected classifier schema in {path}: "
                         f"means {means.shape}, inv_covs {inv_covs.shape}")
    return GaussianRegressor.create(means, inv_covs, sqrt_det, priors,
                                    avg_labels)


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
