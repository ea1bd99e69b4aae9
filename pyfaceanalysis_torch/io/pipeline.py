"""Pipeline configuration: the text format describing a cascade.

Format (parsed at face_analysis.py:374-493; example
``Pipelines/Pipeline_experimental.txt``):

    line 1:  num_networks
    line 2:  face header  "Dx Dy Dang mins maxs sub_w sub_h reg_w reg_h"
    line 3:  eye header   "Dx Dy mins maxs sub_w sub_h reg_w reg_h"
    line 4:  age header   "Dx Dy mins maxs sub_w sub_h reg_w reg_h"
    then per network, three lines: type+serial (e.g. ``Disc1``, ``PosX0``,
    ``EyeLX``, ``Age``), network artifact name (``None0.pckl`` = reuse the
    previous stage's features), classifier artifact name.

The trailing digit of detection-stage types is the "serial" indexing the
cut-off ladder and interpolation formats (FaceDetectUpdated.py:669-672).
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Tuple

from pyfaceanalysis_torch.config import NetGeometry

# Stage types without a serial digit (the last five stages).
_HEAD_TYPES = ("EyeLX", "EyeLY", "Age", "Race", "Gender")


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One network/classifier pair in a pipeline."""

    raw_type: str                 # e.g. "Disc1", "PosX0", "EyeLX"
    network_name: str             # artifact name; "None0" = reuse features
    classifier_name: str

    @property
    def kind(self) -> str:
        """Type with the serial digit stripped: Disc/PosX/PosY/PAng/Scale or
        one of the head types."""
        if self.raw_type in _HEAD_TYPES:
            return self.raw_type
        return self.raw_type[:-1]

    @property
    def serial(self) -> int:
        """Cut-off/interpolation index (0 for head types)."""
        if self.raw_type in _HEAD_TYPES:
            return 0
        return int(self.raw_type[-1])

    @property
    def reuses_features(self) -> bool:
        return self.network_name.startswith("None")


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """Parsed pipeline: geometry headers + ordered stage list."""

    face_geom: NetGeometry
    eye_geom: NetGeometry
    age_geom: NetGeometry
    stages: Tuple[StageSpec, ...]

    @property
    def num_networks(self) -> int:
        return len(self.stages)

    @property
    def detection_stages(self) -> Tuple[StageSpec, ...]:
        """The first num_networks-5 stages (the face-detection cascade,
        FaceDetectUpdated.py:665)."""
        return self.stages[: len(self.stages) - 5]

    def stage_index(self, raw_type: str) -> int:
        for i, s in enumerate(self.stages):
            if s.raw_type == raw_type:
                return i
        raise KeyError(raw_type)


def _parse_geom(fields: List[str], has_dang: bool) -> NetGeometry:
    if has_dang:
        dx, dy, dang, mins, maxs, sw, sh, rw, rh = fields[:9]
    else:
        dx, dy, mins, maxs, sw, sh, rw, rh = fields[:8]
        dang = "0"
    return NetGeometry(Dx=float(dx), Dy=float(dy), Dang=float(dang),
                       mins=float(mins), maxs=float(maxs),
                       subimage_width=int(sw), subimage_height=int(sh),
                       regression_width=int(rw), regression_height=int(rh))


def parse_pipeline(path: str) -> PipelineSpec:
    """Parses a pipeline text file (reference format, see module docstring)."""
    with open(path, "r") as f:
        lines = [ln.rstrip("\n") for ln in f]
    num_networks = int(lines[0].strip())
    face_geom = _parse_geom(lines[1].split(), has_dang=True)
    eye_geom = _parse_geom(lines[2].split(), has_dang=False)
    age_geom = _parse_geom(lines[3].split(), has_dang=False)

    stages = []
    pos = 4
    for _ in range(num_networks):
        raw_type = lines[pos].strip()
        # Reference strips the ".pckl" suffix (5 chars, face_analysis.py:440).
        network_name = re.sub(r"\.pckl$", "", lines[pos + 1].strip())
        classifier_name = re.sub(r"\.pckl$", "", lines[pos + 2].strip())
        stages.append(StageSpec(raw_type, network_name, classifier_name))
        pos += 3
    return PipelineSpec(face_geom, eye_geom, age_geom, tuple(stages))


def write_pipeline(path: str, spec: PipelineSpec) -> None:
    """Serializes a PipelineSpec back to the reference text format."""
    g = spec.face_geom
    e = spec.eye_geom
    a = spec.age_geom
    lines = [str(spec.num_networks)]
    lines.append(f"{g.Dx:g} {g.Dy:g} {g.Dang:g} {g.mins:g} {g.maxs:g} "
                 f"{g.subimage_width} {g.subimage_height} "
                 f"{g.regression_width} {g.regression_height}")
    for gg in (e, a):
        lines.append(f"{gg.Dx:g} {gg.Dy:g} {gg.mins:g} {gg.maxs:g} "
                     f"{gg.subimage_width} {gg.subimage_height} "
                     f"{gg.regression_width} {gg.regression_height}")
    for s in spec.stages:
        lines.append(s.raw_type)
        lines.append(s.network_name + ".pckl")
        lines.append(s.classifier_name + ".pckl")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
