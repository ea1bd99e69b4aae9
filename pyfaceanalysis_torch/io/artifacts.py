"""Artifact store: trained networks + classifiers as .npz files.

Port of ``pyfaceanalysis_tpu.io.artifacts``. The archive format is the same,
so a directory written by either package loads in the other: ``idx_i``,
``mean_i``, ``W_i`` and a JSON ``meta`` per network; Gaussian fields
``means``, ``inv_covs``, ``log_norm``, ``avg_labels`` or ridge fields ``w``,
``b``, ``clip_lo``, ``clip_hi``, ``resid_std`` per classifier;
``manifest.json`` with geometry headers and calibration.

:func:`from_jax_params` builds the same modules from the JAX package's
in-memory parameters passed as numpy arrays, so tests can run both packages
with identical weights.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Sequence, Tuple, Union

import numpy as np

from pyfaceanalysis_torch.config import NetGeometry
from pyfaceanalysis_torch.models.expansion import Expansion
from pyfaceanalysis_torch.models.network import HierarchicalNetwork, LayerSpec
from pyfaceanalysis_torch.models.sfa import LinearNode
from pyfaceanalysis_torch.ops.gaussian import GaussianRegressor
from pyfaceanalysis_torch.ops.ridge import RidgeRegressor

_GAUSSIAN_FIELDS = ("means", "inv_covs", "log_norm", "avg_labels")
_RIDGE_FIELDS = ("w", "b", "clip_lo", "clip_hi", "resid_std")


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_network(path: str, net: HierarchicalNetwork) -> None:
    arrays = {}
    meta = {"input_hw": list(net.input_hw), "layers": []}
    for i, (spec, node) in enumerate(zip(net.specs, net.params)):
        arrays[f"idx_{i}"] = spec.indices_array()
        arrays[f"mean_{i}"] = _np(node.mean)
        arrays[f"W_{i}"] = _np(node.W)
        meta["layers"].append({
            "expansion": spec.expansion.name,
            "exponent": spec.expansion.exponent,
            "out_dim": spec.out_dim,
            "node": spec.node,
            "slow_dim": spec.slow_dim,
            "clip": spec.clip,
        })
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_network(path: str) -> HierarchicalNetwork:
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        specs, params = [], []
        for i, lm in enumerate(meta["layers"]):
            idx = z[f"idx_{i}"]
            specs.append(LayerSpec(
                tuple(tuple(int(v) for v in row) for row in idx),
                Expansion(lm["expansion"], lm.get("exponent", 0.8)),
                lm["out_dim"], node=lm["node"], slow_dim=lm.get("slow_dim"),
                clip=lm.get("clip", 4.0)))
            params.append(LinearNode(z[f"mean_{i}"], z[f"W_{i}"]))
    return HierarchicalNetwork(specs, params, tuple(meta["input_hw"]))


def save_classifier(path: str, clf: Union[GaussianRegressor, RidgeRegressor],
                    input_dim: int) -> None:
    """``input_dim`` is the feature-truncation width (classifier.input_dim in
    the reference, FaceDetectUpdated.py:709). Either head type."""
    if input_dim != clf.input_dim:
        raise ValueError(f"input_dim {input_dim} is not the classifier's "
                         f"{clf.input_dim}")
    if isinstance(clf, GaussianRegressor):
        np.savez_compressed(
            path, **{k: _np(getattr(clf, k)) for k in _GAUSSIAN_FIELDS})
    else:
        np.savez_compressed(
            path, head=np.asarray("ridge"),
            **{k: _np(getattr(clf, k)) for k in _RIDGE_FIELDS})


def load_classifier(path: str) -> Union[GaussianRegressor, RidgeRegressor]:
    """Either head type, told apart by the archive's fields."""
    with np.load(path) as z:
        if "w" in z.files:
            return RidgeRegressor(*(z[k] for k in _RIDGE_FIELDS))
        return GaussianRegressor(*(z[k] for k in _GAUSSIAN_FIELDS))


def save_manifest(dirpath: str, face_geom: NetGeometry,
                  eye_geom: NetGeometry, age_geom: NetGeometry,
                  calibration: dict = None) -> None:
    with open(os.path.join(dirpath, "manifest.json"), "w") as f:
        json.dump({
            "face_geom": dataclasses.asdict(face_geom),
            "eye_geom": dataclasses.asdict(eye_geom),
            "age_geom": dataclasses.asdict(age_geom),
            "calibration": calibration or {},
        }, f, indent=2)


def load_calibration(dirpath: str) -> dict:
    path = os.path.join(dirpath, "manifest.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f).get("calibration", {})


def load_manifest(dirpath: str) -> Tuple[NetGeometry, NetGeometry,
                                         NetGeometry]:
    with open(os.path.join(dirpath, "manifest.json")) as f:
        m = json.load(f)
    return (NetGeometry(**m["face_geom"]), NetGeometry(**m["eye_geom"]),
            NetGeometry(**m["age_geom"]))


def from_jax_params(layers: Sequence[dict] = (), input_hw=(64, 64),
                    gaussian: dict = None, ridge: dict = None):
    """Port modules from the JAX package's parameters as numpy arrays.

    ``layers``: one dict per layer with ``field_indices`` ((F, k) ints, as
    ``LayerSpec.field_indices``), ``expansion`` (name), ``exponent``,
    ``out_dim``, ``clip``, ``mean`` and ``W`` (``LinearNode`` fields);
    returns a :class:`HierarchicalNetwork`. ``gaussian``: a dict with the
    ``GaussianRegressor`` fields ``means``, ``inv_covs``, ``log_norm`` and
    ``avg_labels``; returns a :class:`GaussianRegressor`. ``ridge``: a dict
    with the ``RidgeRegressor`` fields ``w``, ``b``, ``clip_lo``,
    ``clip_hi`` and ``resid_std``; returns a :class:`RidgeRegressor`.
    Exactly one of the three must be given.
    """
    if (bool(layers) + (gaussian is not None) + (ridge is not None)) != 1:
        raise ValueError("give exactly one of layers, gaussian and ridge")
    if gaussian is not None:
        return GaussianRegressor(*(np.asarray(gaussian[k], np.float32)
                                   for k in _GAUSSIAN_FIELDS))
    if ridge is not None:
        return RidgeRegressor(*(np.asarray(ridge[k], np.float32)
                                for k in _RIDGE_FIELDS))
    specs, params = [], []
    for lm in layers:
        specs.append(LayerSpec(
            tuple(tuple(int(v) for v in row) for row in lm["field_indices"]),
            Expansion(lm.get("expansion", "identity"),
                      lm.get("exponent", 0.8)),
            int(lm["out_dim"]), node=lm.get("node", "sfa"),
            slow_dim=lm.get("slow_dim"), clip=lm.get("clip", 4.0)))
        params.append(LinearNode(np.asarray(lm["mean"], np.float32),
                                 np.asarray(lm["W"], np.float32)))
    return HierarchicalNetwork(specs, params, tuple(input_hw))
