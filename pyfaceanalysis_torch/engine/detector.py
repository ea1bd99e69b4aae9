"""FaceDetector: the top-level per-image driver.

Port of the single-image path of ``pyfaceanalysis_tpu.engine.detector``:
canvas -> pyramid -> all-scales grid -> masked cascade (engine.cascade) ->
survivor ranking -> approximate eye boxes -> eye localization
(engine.eyes) -> host NMS (engine.nms) -> :class:`Detection` rows.

Host/device split as in the JAX package: grid construction, NMS and
bookkeeping are host numpy; everything per window runs on the model's
device, and one (k_out, 11) block crosses back to the host per image.
The attribute heads, batch and stream modes are not ported yet:
``detect`` raises when asked for attributes.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from pyfaceanalysis_torch import geometry
from pyfaceanalysis_torch.config import (
    DESIRED_SAMPLING,
    EYE_SAMPLING,
    DetectorConfig,
    resolve_device,
)
from pyfaceanalysis_torch.engine import cascade as cascade_mod
from pyfaceanalysis_torch.engine import eyes as eyes_mod
from pyfaceanalysis_torch.engine import nms as nms_mod
from pyfaceanalysis_torch.io import artifacts
from pyfaceanalysis_torch.io.legacy import find_filenames_beginning_with
from pyfaceanalysis_torch.io.pipeline import PipelineSpec, parse_pipeline
from pyfaceanalysis_torch.models.network import HierarchicalNetwork
from pyfaceanalysis_torch.ops.gaussian import GaussianRegressor
from pyfaceanalysis_torch.ops.pyramid import build_pyramid


@dataclasses.dataclass
class Detection:
    """One detected face, in the frame of the (prescaled) input image."""

    box: Tuple[float, float, float, float]
    angle: float
    eye_left: Tuple[float, float]
    eye_right: Tuple[float, float]
    confidence: float
    age: Optional[float] = None
    age_std: Optional[float] = None
    race_value: Optional[float] = None
    gender_value: Optional[float] = None

    @property
    def race(self) -> Optional[str]:
        """-2 -> Black, +2 -> White (face_analysis.py:354-371)."""
        if self.race_value is None:
            return None
        return "Black" if self.race_value <= 0 else "White"

    @property
    def gender(self) -> Optional[str]:
        """-1 -> Male, +1 -> Female (face_analysis.py:333-351)."""
        if self.gender_value is None:
            return None
        return "Male" if self.gender_value <= 0 else "Female"


class DetectionModel:
    """Loaded pipeline artifacts on one device: networks, classifiers, the
    stage plan and the manifest's calibration."""

    def __init__(self, spec: PipelineSpec,
                 nets: Dict[str, HierarchicalNetwork],
                 classifiers: List[GaussianRegressor]):
        self.spec = spec
        self.nets = nets
        self.classifiers = classifiers          # one per stage
        self.calibration: dict = {}
        det_stages = spec.detection_stages
        names = []
        for st in det_stages:
            if not st.reuses_features and st.network_name not in names:
                names.append(st.network_name)
        self.det_net_names = names
        net_ids = {n: i for i, n in enumerate(names)}
        input_dims = [classifiers[i].input_dim for i in range(len(det_stages))]
        self.plan = cascade_mod.build_detection_plan(spec, net_ids, input_dims)
        self.det_nets = tuple(nets[n] for n in names)
        self.det_clfs = tuple(classifiers[: len(det_stages)])

    @property
    def device(self) -> torch.device:
        return self.classifiers[0].means.device

    def to(self, device) -> "DetectionModel":
        for net in self.nets.values():
            net.to(device)
        for clf in self.classifiers:
            clf.to(device)
        return self

    def stage(self, raw_type: str) -> int:
        return self.spec.stage_index(raw_type)

    def classifier(self, raw_type: str) -> GaussianRegressor:
        return self.classifiers[self.stage(raw_type)]

    def clf_input_dim(self, raw_type: str) -> int:
        return self.classifier(raw_type).input_dim

    @staticmethod
    def load(artifact_dir: str, pipeline_file: Optional[str] = None,
             device: Union[str, torch.device, None] = None
             ) -> "DetectionModel":
        """Loads a pipeline directory onto ``device`` (default ``cuda``)."""
        device = resolve_device(device)
        if pipeline_file is None:
            # Pipeline discovery like the reference (first Pipeline*.txt).
            found = find_filenames_beginning_with(artifact_dir, "Pipeline",
                                                  extension=".txt")
            if not found:
                raise FileNotFoundError(
                    f"no Pipeline*.txt in {artifact_dir!r}")
            pipeline_file = found[0]
        spec = parse_pipeline(pipeline_file)
        nets: Dict[str, HierarchicalNetwork] = {}
        classifiers: List[GaussianRegressor] = []
        for st in spec.stages:
            if not st.reuses_features and st.network_name not in nets:
                nets[st.network_name] = artifacts.load_network(
                    os.path.join(artifact_dir, st.network_name + ".npz"))
            classifiers.append(artifacts.load_classifier(
                os.path.join(artifact_dir, st.classifier_name + ".npz")))
        model = DetectionModel(spec, nets, classifiers)
        model.nets.setdefault(
            "net_eye", nets[spec.stages[model.stage("EyeLX")].network_name])
        model.calibration = artifacts.load_calibration(artifact_dir)
        return model.to(device)


def _pad_convert(u8: np.ndarray, H: int, W: int,
                 device: torch.device) -> torch.Tensor:
    """Ships the true image extent as uint8 and pads/converts on the
    device: (h, w) uint8 -> (H, W) float32 in [0, 1], zeros outside."""
    h, w = u8.shape
    canvas = torch.zeros((H, W), dtype=torch.uint8, device=device)
    canvas[:h, :w] = torch.from_numpy(np.ascontiguousarray(u8)).to(device)
    return canvas.to(torch.float32) / 255.0


def _block_rows(block: np.ndarray) -> np.ndarray:
    """Valid rows of a detection block: (n, 10) NMS rows [box, angle,
    PASS-1 eyes, conf], with the refined eye centres appended as cols
    10:14 when the block carries them (config.eye_iters > 1)."""
    rows = block[block[:, 10] > 0.5]
    if block.shape[-1] > 11:
        return np.concatenate([rows[:, :10], rows[:, 11:15]], axis=1)
    return rows[:, :10]


def _row_eyes(r, cfg=None) -> Tuple[Tuple[float, float], Tuple[float, float]]:
    """REPORTED eye centres of a purged row: the refined pass when present
    (cols 10:14), else the pass-1 positions (cols 5:9);
    ``config.eye_report == "pass1"`` reports pass 1 regardless."""
    report_refined = (len(r) >= 14 and
                      (cfg is None or
                       getattr(cfg, "eye_report", "refined") == "refined"))
    e = r[10:14] if report_refined else r[5:9]
    return (float(e[0]), float(e[1])), (float(e[2]), float(e[3]))


def _detect_core(model: DetectionModel, cfg: DetectorConfig, k_out: int,
                 image: torch.Tensor, state: cascade_mod.CascadeState,
                 pyramid: Optional[torch.Tensor] = None,
                 crops: Optional[torch.Tensor] = None,
                 pyr_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cascade + survivor ranking + eye localization on the device.

    Returns a (k_out, 11) block [x0, y0, x1, y1, angle, elx, ely, erx, ery,
    conf, valid]; with config.eye_iters > 1 a (k_out, 15) block whose cols
    11-14 are the refined eye centres (cols 5-8 stay pass 1, which the
    too-far gate and NMS use).
    """
    geom = model.spec.face_geom
    eye_geom = model.spec.eye_geom
    out = cascade_mod.run_cascade(
        model.plan, model.det_nets, geom, cfg,
        (geom.subimage_height, geom.subimage_width),
        image, model.det_clfs, state, pyramid=pyramid, crops=crops,
        pyr_scales=pyr_scales)

    # Alive rows first, best (lowest) Disc confidence first within them.
    # The eye sub-cascade runs on at most eye_max_faces rows; rows beyond
    # the cap keep the geometric eye prior and skip the too-far gate.
    k_out = min(k_out, out.mask.shape[0])
    eye_cap = min(k_out, max(cfg.eye_max_faces, 8))
    rank = torch.where(out.mask, out.conf, torch.full_like(out.conf, 2.0))
    idx = torch.argsort(rank, stable=True)[:k_out]
    boxes = out.boxes[idx]
    angles = out.angles[idx]
    conf = out.conf[idx]
    valid = out.mask[idx]

    _, l_boxes, r_boxes = geometry.compute_approximate_eye_boxes_coordinates(
        boxes, angles, face_sampling=DESIRED_SAMPLING,
        eye_sampling=EYE_SAMPLING)
    eye_boxes = torch.cat([l_boxes[:eye_cap], r_boxes[:eye_cap]], dim=0)
    both_angles = torch.cat([angles[:eye_cap], angles[:eye_cap]], dim=0)
    samplers = (cascade_mod.level_samplers(cfg, image.device)
                if pyramid is not None else None)
    eye_kw = dict(pyramid=pyramid, pyr_scales=pyr_scales,
                  level_sampler=None if samplers is None else samplers[1])
    eye_net = model.nets["net_eye"]
    eye_args = (eye_net, model.clf_input_dim("EyeLX"),
                model.clf_input_dim("EyeLY"),
                (eye_geom.subimage_height, eye_geom.subimage_width), image,
                model.classifier("EyeLX"), model.classifier("EyeLY"))
    pass1_boxes, max_reg = eyes_mod.localize_eyes(
        *eye_args, eye_boxes, both_angles, **eye_kw)
    # Optional refinement passes: a pure OUTPUT refinement (config.eye_iters).
    new_boxes = pass1_boxes
    for _ in range(cfg.eye_iters - 1):
        new_boxes, _ = eyes_mod.localize_eyes(
            *eye_args, new_boxes, both_angles, **eye_kw)
    l_new = torch.cat([pass1_boxes[:eye_cap], l_boxes[eye_cap:]], dim=0)
    r_new = torch.cat([pass1_boxes[eye_cap:], r_boxes[eye_cap:]], dim=0)
    too_far = max_reg >= cfg.tolerance_xy_eye
    bad = too_far[:eye_cap] | too_far[eye_cap:]
    bad = torch.cat([bad, torch.zeros(k_out - eye_cap, dtype=torch.bool,
                                      device=bad.device)], dim=0)
    valid = valid & torch.logical_not(bad)
    l_c = (l_new[:, 0:2] + l_new[:, 2:4]) / 2.0
    r_c = (r_new[:, 0:2] + r_new[:, 2:4]) / 2.0
    cols = [boxes, angles[:, None], l_c, r_c, conf[:, None],
            valid[:, None].to(torch.float32)]
    if cfg.eye_iters > 1:
        l_ref = torch.cat([new_boxes[:eye_cap], l_boxes[eye_cap:]], dim=0)
        r_ref = torch.cat([new_boxes[eye_cap:], r_boxes[eye_cap:]], dim=0)
        cols += [(l_ref[:, 0:2] + l_ref[:, 2:4]) / 2.0,
                 (r_ref[:, 0:2] + r_ref[:, 2:4]) / 2.0]
    return torch.cat(cols, dim=1)


class FaceDetector:
    """End-to-end single-image detector with the reference's behaviour."""

    def __init__(self, model: DetectionModel,
                 config: DetectorConfig = DetectorConfig(),
                 device: Union[str, torch.device, None] = None):
        """Runs on ``device`` (default ``cuda``); the model is moved there.
        Calibrated values from the model's manifest fill every config
        field the caller left at "model decides"."""
        self.device = resolve_device(device)
        calib = getattr(model, "calibration", {}) or {}
        if (config.last_cut_off_face < 0
                and "last_cut_off_face" in calib):
            config = dataclasses.replace(
                config, last_cut_off_face=float(calib["last_cut_off_face"]))
        if config.cut_offs_face is None and "cut_offs_face" in calib:
            config = dataclasses.replace(
                config, cut_offs_face=tuple(
                    float(v) for v in calib["cut_offs_face"]))
        if config.detection_contrast_normalize is None:
            config = dataclasses.replace(
                config, detection_contrast_normalize=bool(
                    calib.get("detection_contrast_normalize", False)))
        if config.pang_gain < 0 and "pang_gain" in calib:
            config = dataclasses.replace(
                config, pang_gain=float(calib["pang_gain"]))
        if config.pos_gain < 0 and "pos_gain" in calib:
            config = dataclasses.replace(
                config, pos_gain=float(calib["pos_gain"]))
        if config.scale_gain < 0 and "scale_gain" in calib:
            config = dataclasses.replace(
                config, scale_gain=float(calib["scale_gain"]))
        if config.tolerance_xy_eye < 0:
            config = dataclasses.replace(
                config, tolerance_xy_eye=float(
                    calib.get("tolerance_xy_eye", 9.0)))
        self.model = model.to(self.device)
        self.config = config
        self.face_has_been_found = False
        self.tracked_face: Optional[Tuple] = None
        self.windows_scanned = 0
        self.last_trace = None
        # Fixed canvas: every input of the same prescaled size shares it.
        side = config.prescale_size if config.image_prescaling else 2048
        self._canvas_hw = (side, side)
        # The grid is a pure function of the image size for a fixed config
        # (tracking grids depend on the last detection and bypass this).
        self._grid_cache: dict = {}

    def _grid_state(self, im_w: int, im_h: int):
        key = (im_w, im_h)
        hit = self._grid_cache.get(key)
        if hit is None:
            hit = cascade_mod.make_grid_state(
                im_w, im_h, self.model.spec.face_geom, self.config,
                device=self.device)
            self._grid_cache[key] = hit
        return hit

    def _to_canvas(self, image: np.ndarray) -> torch.Tensor:
        """Pads into the fixed canvas on the device. Inputs larger than the
        canvas (possible only with image_prescaling off) grow it to the
        next multiple of 512."""
        H, W = self._canvas_hw
        if image.shape[0] > H or image.shape[1] > W:
            side = int(-(-max(image.shape) // 512) * 512)
            self._canvas_hw = (side, side)
            H = W = side
        u8 = np.clip(np.asarray(image) * 255.0, 0, 255).astype(np.uint8)
        return _pad_convert(u8, H, W, self.device)

    def detect(self, image: np.ndarray, estimate_attributes: bool = True,
               collect_trace: bool = False) -> List[Detection]:
        """Detects faces in a grayscale (H, W) image with values in [0, 1]
        (already prescaled); coordinates are in this frame.

        The attribute heads are not ported yet: pass
        ``estimate_attributes=False``."""
        if estimate_attributes:
            raise NotImplementedError(
                "the attribute heads are not ported yet; "
                "pass estimate_attributes=False")
        cfg = self.config
        model = self.model
        im_h, im_w = image.shape
        geom = model.spec.face_geom
        device_image = self._to_canvas(image)

        track = self.tracked_face if (cfg.track_single_face and
                                      self.face_has_been_found) else None
        if track is None:
            state, n_real, pyr = self._grid_state(im_w, im_h)
        else:
            state, n_real, pyr = cascade_mod.make_grid_state(
                im_w, im_h, geom, cfg, track, device=self.device)
        self.windows_scanned = n_real
        if n_real == 0:
            return []
        # Pyramid path for the iter-0 extraction (nearest interp only).
        pyramid = crops = scales_arr = None
        if (pyr is not None and
                cfg.interpolation_formats[model.plan[0].serial] == "nearest"):
            pyramid = build_pyramid(device_image, pyr.scales, pyr.level_hw)
            crops = pyr.crops
            scales_arr = torch.tensor(pyr.scales, dtype=torch.float32,
                                      device=self.device)

        self.last_trace = None
        if collect_trace:
            # Per-stage attribution only (compaction off); the detections
            # always come from the production run below.
            _, trace = cascade_mod.run_cascade(
                model.plan, model.det_nets, geom, cfg,
                (geom.subimage_height, geom.subimage_width),
                device_image, model.det_clfs, state, pyramid=pyramid,
                crops=crops, pyr_scales=scales_arr, collect_trace=True)
            self.last_trace = [tuple(t.cpu().numpy() for t in snap)
                               for snap in trace]
        block = _detect_core(model, cfg, cfg.max_detections, device_image,
                             state, pyramid, crops, scales_arr)
        block = block.cpu().numpy()                 # the one result pull
        rows = _block_rows(block)
        if len(rows) == 0:
            self._update_tracking(rows)
            return []

        purged = nms_mod.purge_detections(rows, cfg.purge_threshold)
        self._update_tracking(purged)
        det_list: List[Detection] = []
        for r in purged:
            el, er = _row_eyes(r, cfg)
            det_list.append(Detection(
                box=tuple(float(v) for v in r[0:4]), angle=float(r[4]),
                eye_left=el, eye_right=er, confidence=float(r[9])))
        return det_list

    def _update_tracking(self, purged: np.ndarray) -> None:
        if not self.config.track_single_face:
            return
        if len(purged) > 0:
            self.tracked_face = tuple(purged[0][0:4])
            self.face_has_been_found = True
        else:
            self.face_has_been_found = False
