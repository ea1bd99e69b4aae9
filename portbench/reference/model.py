"""The plain reference's model: pipeline file, HiGSFA networks and Gaussian
regressors, loaded from an artifact directory's ``.npz`` archives.

A frozen, trimmed copy of the plain operations the detector runs (the
reference is held apart from the program it judges and imports nothing
of it). Every product rounds its operands to the precision it is given
and multiplies in float32:

- ``"f32"``: float32 operands (the reference turns TF32 off);
- ``"bf16"``: operands rounded to bfloat16, float32 accumulation -- the
  cascade networks' precision in the default configuration;
- ``"tf32"``: operands rounded to TF32's 10 mantissa bits (the control's
  step below float32);
- ``"fp8"``: operands scaled into float8 e4m3 (per tensor for weights, per
  row for activations) and back (the control's step below bfloat16).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

_HEAD_TYPES = ("EyeLX", "EyeLY", "Age", "Race", "Gender")
_FP8_MAX = 448.0


def round_operand(x: torch.Tensor, precision: str,
                  per_row: bool = False) -> torch.Tensor:
    """``x`` (float32) rounded to ``precision``, returned as float32."""
    if precision == "f32":
        return x
    if precision == "bf16":
        return x.to(torch.bfloat16).float()
    if precision == "tf32":
        bits = x.contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF
        return bits.view(torch.float32)
    if precision == "fp8":
        if per_row:
            amax = x.abs().reshape(x.shape[0], -1).amax(dim=1)
            amax = amax.reshape((-1,) + (1,) * (x.dim() - 1))
        else:
            amax = x.abs().amax()
        scale = torch.clamp(amax, min=1e-30) / _FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown precision {precision!r}")


def product(x: torch.Tensor, w: torch.Tensor, equation: str,
            precision: str) -> torch.Tensor:
    """``einsum(equation, x, w)`` with both operands rounded first."""
    return torch.einsum(equation, round_operand(x, precision, per_row=True),
                        round_operand(w, precision))


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One pipeline header line (``face_analysis.py:383-432``)."""

    Dx: float
    Dy: float
    Dang: float
    mins: float
    maxs: float
    subimage_width: int
    subimage_height: int
    regression_width: int
    regression_height: int


@dataclasses.dataclass(frozen=True)
class Stage:
    raw_type: str
    network_name: str
    classifier_name: str

    @property
    def kind(self) -> str:
        return self.raw_type if self.raw_type in _HEAD_TYPES \
            else self.raw_type[:-1]

    @property
    def serial(self) -> int:
        return 0 if self.raw_type in _HEAD_TYPES else int(self.raw_type[-1])

    @property
    def reuses_features(self) -> bool:
        return self.network_name.startswith("None")


def _geometry(fields: List[str], has_dang: bool) -> Geometry:
    if has_dang:
        dx, dy, dang, mins, maxs, sw, sh, rw, rh = fields[:9]
    else:
        dx, dy, mins, maxs, sw, sh, rw, rh = fields[:8]
        dang = "0"
    return Geometry(float(dx), float(dy), float(dang), float(mins),
                    float(maxs), int(sw), int(sh), int(rw), int(rh))


def parse_pipeline(path: str) -> Tuple[Geometry, Geometry, List[Stage]]:
    """(face geometry, eye geometry, stages) of a pipeline text file."""
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f]
    n = int(lines[0].strip())
    face = _geometry(lines[1].split(), True)
    eye = _geometry(lines[2].split(), False)
    stages = []
    for i in range(n):
        t, net, clf = (lines[4 + 3 * i + k].strip() for k in range(3))
        stages.append(Stage(t, re.sub(r"\.pckl$", "", net),
                            re.sub(r"\.pckl$", "", clf)))
    return face, eye, stages


def _tensor(value: np.ndarray, device) -> torch.Tensor:
    """float32 tensor that keeps the archive's strides (the weights are
    stored Fortran-ordered, and the layout picks the product's kernel)."""
    value = np.asarray(value)
    if any(st < 0 for st in value.strides):
        value = value.copy()
    return torch.tensor(value, dtype=torch.float32).to(device)


class Network:
    """A HiGSFA network: per layer a switchboard gather, an expansion, an
    affine projection per receptive field and a clip."""

    def __init__(self, path: str, device):
        self.layers = []
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            for i, lm in enumerate(meta["layers"]):
                self.layers.append((
                    torch.as_tensor(np.asarray(z[f"idx_{i}"], np.int64),
                                    device=device),
                    lm["expansion"], float(lm.get("exponent", 0.8)),
                    _tensor(z[f"mean_{i}"], device),
                    _tensor(z[f"W_{i}"], device), lm.get("clip", 4.0)))

    def __call__(self, x: torch.Tensor, precision: str) -> torch.Tensor:
        for idx, expansion, exponent, mean, W, clip in self.layers:
            f = _expand(x[:, idx], expansion, exponent)
            y = product(f - mean[None], W, "bfd,fdo->bfo", precision)
            if clip is not None:
                y = torch.clamp(y, -clip, clip)
            x = y.reshape(y.shape[0], -1)
        return x

    def products(self) -> List[Tuple[int, int, int]]:
        """(fields, expanded inputs, outputs) of each layer's product."""
        return [tuple(W.shape) for _, _, _, _, W, _ in self.layers]


def _expand(x: torch.Tensor, name: str, exponent: float) -> torch.Tensor:
    if name == "identity":
        return x
    if name == "spow":
        # |x|^e in float64, rounded once (as the detector computes it).
        p = torch.abs(x).double() ** float(np.float32(exponent))
        return torch.cat([x, torch.sign(x) * p.to(x.dtype)], dim=-1)
    if name.startswith("qt"):
        k = min(int(name[2:]), x.shape[-1])
        head = x[..., :k]
        iu, ju = torch.triu_indices(k, k, device=x.device)
        return torch.cat([x, head[..., iu] * head[..., ju]], dim=-1)
    raise ValueError(f"unknown expansion {name!r}")


class Gaussian:
    """Per-class Gaussians as a soft regressor:
    ``sum_c P(c | x) * avg_labels_c`` (and the posterior label std)."""

    def __init__(self, path: str, device):
        with np.load(path) as z:
            if "w" in z.files:
                raise ValueError(f"{path}: only Gaussian heads are "
                                 f"supported by the reference")
            self.means = _tensor(z["means"], device)
            self.inv_covs = _tensor(z["inv_covs"], device)
            self.log_norm = _tensor(z["log_norm"], device)
            self.avg_labels = _tensor(z["avg_labels"], device)

    @property
    def input_dim(self) -> int:
        return self.means.shape[1]

    def regression(self, x: torch.Tensor, precision: str,
                   estimate_std: bool = False):
        diff = x[:, None, :] - self.means[None]
        dA = product(diff, self.inv_covs, "bcd,cde->bce", precision)
        maha = torch.clamp(torch.einsum("bce,bce->bc", dA, diff), 0.0,
                           3.0e37)
        logp = self.log_norm[None] - 0.5 * maha
        logp = logp - logp.max(dim=-1, keepdim=True).values
        p = torch.exp(torch.clamp(logp, min=-80.0))
        p = p / p.sum(dim=-1, keepdim=True)
        reg = p @ self.avg_labels
        if not estimate_std:
            return reg
        var = torch.clamp(p @ (self.avg_labels ** 2) - reg ** 2, min=0.0)
        return reg, torch.sqrt(var)

    def flops_per_row(self) -> int:
        """Operations of one row's quadratic forms (the products)."""
        C, D = self.means.shape
        return C * (2 * D * D + 3 * D)


@dataclasses.dataclass
class Model:
    face: Geometry
    eye: Geometry
    stages: List[Stage]
    nets: Dict[str, Network]
    clfs: List[Gaussian]
    calibration: dict

    def stage_index(self, raw_type: str) -> int:
        return next(i for i, s in enumerate(self.stages)
                    if s.raw_type == raw_type)

    def clf(self, raw_type: str) -> Gaussian:
        return self.clfs[self.stage_index(raw_type)]

    def net_of(self, raw_type: str) -> Network:
        """The network whose features a stage reads (``None*`` stages walk
        back to the last stage with a network)."""
        i = self.stage_index(raw_type)
        while self.stages[i].reuses_features:
            i -= 1
        return self.nets[self.stages[i].network_name]


def load_model(artifact_dir: str, device="cpu",
               pipeline_file: Optional[str] = None) -> Model:
    """Loads an artifact directory: the first ``Pipeline*.txt``, every
    ``.npz`` it names and the manifest's calibration."""
    if pipeline_file is None:
        found = sorted(fn for fn in os.listdir(artifact_dir)
                       if fn.startswith("Pipeline") and fn.endswith(".txt"))
        if not found:
            raise FileNotFoundError(f"no Pipeline*.txt in {artifact_dir!r}")
        pipeline_file = os.path.join(artifact_dir, found[0])
    face, eye, stages = parse_pipeline(pipeline_file)
    nets: Dict[str, Network] = {}
    clfs = []
    for st in stages:
        if not st.reuses_features and st.network_name not in nets:
            nets[st.network_name] = Network(
                os.path.join(artifact_dir, st.network_name + ".npz"), device)
        clfs.append(Gaussian(
            os.path.join(artifact_dir, st.classifier_name + ".npz"), device))
    calibration = {}
    manifest = os.path.join(artifact_dir, "manifest.json")
    if os.path.exists(manifest):
        with open(manifest) as f:
            calibration = json.load(f).get("calibration", {})
    return Model(face, eye, stages, nets, clfs, calibration)
