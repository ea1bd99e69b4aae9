"""FaceDetector: the top-level entry for one image, a batch or a stream.

Port of ``pyfaceanalysis_tpu.engine.detector``: canvas -> pyramid ->
all-scales grid -> masked cascade (engine.cascade) -> survivor ranking ->
approximate eye boxes -> eye localization (engine.eyes) -> host NMS
(engine.nms) -> age/race/gender heads (engine.heads) ->
:class:`Detection` rows.

Host/device split as in the JAX package: grid construction, NMS and
bookkeeping are host numpy; everything per window runs on the model's
device. One (k_out, 11) block crosses back to the host per image
(``detect``), or one (B, k, 11) block per batch (``detect_batch`` in its
fused mode: ONE cascade over the windows of every image of the batch), plus
one (4, N) block of attributes. ``detect_stream`` keeps several batches in
flight. With ``config.data_mesh`` above 1 the window batch of ``detect``
and of the fused batch is sharded over a data mesh of that many devices
(``parallel.mesh``); the ranking, the eye pass and the heads run on the
first device over all survivors.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

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
from pyfaceanalysis_torch.engine import heads as heads_mod
from pyfaceanalysis_torch.engine import nms as nms_mod
from pyfaceanalysis_torch.io import artifacts
from pyfaceanalysis_torch.io.legacy import find_filenames_beginning_with
from pyfaceanalysis_torch.io.pipeline import PipelineSpec, parse_pipeline
from pyfaceanalysis_torch.models.network import HierarchicalNetwork
from pyfaceanalysis_torch.ops.gaussian import GaussianRegressor
from pyfaceanalysis_torch.ops.pyramid import build_pyramid, build_pyramid_batch
from pyfaceanalysis_torch.ops.ridge import RidgeRegressor
from pyfaceanalysis_torch.parallel import mesh as mesh_mod
from pyfaceanalysis_torch.utils.profiling import annotate

Classifier = Union[GaussianRegressor, RidgeRegressor]


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
        if self.race_value is None:
            return None
        return heads_mod.race_strings([self.race_value])[0]

    @property
    def gender(self) -> Optional[str]:
        if self.gender_value is None:
            return None
        return heads_mod.gender_strings([self.gender_value])[0]


class DetectionModel:
    """Loaded pipeline artifacts on one device: networks, classifiers, the
    stage plan and the manifest's calibration."""

    def __init__(self, spec: PipelineSpec,
                 nets: Dict[str, HierarchicalNetwork],
                 classifiers: List[Classifier]):
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
        # Any head type: a Gaussian head holds ``means``, a ridge head ``w``.
        return next(self.classifiers[0].buffers()).device

    def to(self, device) -> "DetectionModel":
        for net in self.nets.values():
            net.to(device)
        for clf in self.classifiers:
            clf.to(device)
        return self

    def stage(self, raw_type: str) -> int:
        return self.spec.stage_index(raw_type)

    def classifier(self, raw_type: str) -> Classifier:
        return self.classifiers[self.stage(raw_type)]

    def clf_input_dim(self, raw_type: str) -> int:
        return self.classifier(raw_type).input_dim

    def network_for(self, raw_type: str) -> HierarchicalNetwork:
        """Network whose features the stage consumes; ``None*`` stages walk
        back to the most recent stage with a real network (the reference's
        feature-reuse rule)."""
        i = self.stage(raw_type)
        while i >= 0 and self.spec.stages[i].reuses_features:
            i -= 1
        if i < 0:
            raise KeyError(f"stage {raw_type} reuses features of nothing")
        return self.nets[self.spec.stages[i].network_name]

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
        classifiers: List[Classifier] = []
        for st in spec.stages:
            if not st.reuses_features and st.network_name not in nets:
                nets[st.network_name] = artifacts.load_network(
                    os.path.join(artifact_dir, st.network_name + ".npz"))
            classifiers.append(artifacts.load_classifier(
                os.path.join(artifact_dir, st.classifier_name + ".npz")))
        model = DetectionModel(spec, nets, classifiers)
        # Aliases used by the heads and eyes paths.
        model.nets.setdefault(
            "net_age", nets[spec.stages[model.stage("Age")].network_name])
        model.nets.setdefault(
            "net_eye", nets[spec.stages[model.stage("EyeLX")].network_name])
        model.calibration = artifacts.load_calibration(artifact_dir)
        return model.to(device)


def _pad_convert(u8: np.ndarray, H: int, W: int,
                 device: torch.device) -> torch.Tensor:
    """Ships the true image extent as uint8 in one host-to-device copy and
    pads/converts on the device: (h, w) or (B, h, w) uint8 -> the same with
    the trailing two dims padded to (H, W), float32 in [0, 1], zeros
    outside."""
    h, w = u8.shape[-2:]
    canvas = torch.zeros(u8.shape[:-2] + (H, W), dtype=torch.uint8,
                         device=device)
    canvas[..., :h, :w] = torch.from_numpy(
        np.ascontiguousarray(u8)).to(device)
    return canvas.to(torch.float32) / 255.0


def _to_u8(image: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(image) * 255.0, 0, 255).astype(np.uint8)


def _wire_coord_scale(side: int) -> float:
    """Coordinate scale of the u16 wire encoding as a function of the
    device-canvas side: 1/16 px while the canvas fits the 16x range (max
    coord (65535/16)-1024 = 3071.9 px), 1/8 px for grown canvases up to
    7167 px. Pack (device) and unpack (host) both derive the scale from the
    canvas shape, so they always agree."""
    return 16.0 if side <= 3071 else 8.0


def _wire_affine(ncols: int, coord_scale: float = 16.0):
    """Per-column (offset, scale) of the u16 fixed-point wire encoding:
    pixel/degree columns at 1/coord_scale with a +1024 offset (coords may
    run negative after refinement drift), confidence at 1/16384 (NMS
    ranks on it -- coarse granularity could reorder ties), validity
    at 1."""
    off = np.full(ncols, 1024.0, np.float32)
    scale = np.full(ncols, coord_scale, np.float32)
    off[9], scale[9] = 0.0, 16384.0        # confidence
    off[10], scale[10] = 0.0, 1.0          # validity flag
    return off, scale


# Largest canvas side the u16 wire encoding represents (at the 1/8-px
# fallback scale; see _wire_coord_scale).
_WIRE_U16_MAX_CANVAS = 7167


def _check_wire_range(cfg: DetectorConfig, side: int) -> None:
    if cfg.wire_format == "u16" and side > _WIRE_U16_MAX_CANVAS:
        raise ValueError(
            f"canvas {side} px exceeds the u16 wire encoding's "
            f"{_WIRE_U16_MAX_CANVAS} px range; rerun with "
            f"wire_format='f32' (or enable image prescaling)")


def _pack_wire(block: torch.Tensor, canvas_side: int) -> torch.Tensor:
    """Device-side u16 pack of a (..., ncols) float32 block: round half to
    even, clip to [0, 65535] (see _wire_affine)."""
    off, scale = _wire_affine(block.shape[-1], _wire_coord_scale(canvas_side))
    off = torch.as_tensor(off, device=block.device)
    scale = torch.as_tensor(scale, device=block.device)
    return torch.clamp(torch.round((block + off) * scale), 0.0,
                       65535.0).to(torch.uint16)


def _unpack_wire(block: np.ndarray, canvas_side: int) -> np.ndarray:
    """Host-side inverse of the u16 wire pack (see _wire_affine)."""
    off, scale = _wire_affine(block.shape[-1], _wire_coord_scale(canvas_side))
    return block.astype(np.float32) / scale - off


def _pull(block: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    """The device-to-host copy of a result block (waits for the device);
    None passes through (the empty-grid sentinel)."""
    if block is None:
        return None
    with annotate("pfa.pull"):
        return block.cpu().numpy()


def _block_rows(block: np.ndarray) -> np.ndarray:
    """Valid rows of a detection block: (n, 10) NMS rows [box, angle,
    PASS-1 eyes, conf], with the refined eye centres appended as cols
    10:14 when the block carries them (config.eye_iters > 1)."""
    rows = block[block[:, 10] > 0.5]
    if block.shape[-1] > 11:
        return np.concatenate([rows[:, :10], rows[:, 11:15]], axis=1)
    return rows[:, :10]


def _arg_rows(rows: np.ndarray, cfg) -> np.ndarray:
    """Rows as the attribute heads should see them.

    Default: the rows themselves (heads read the pass-1 eyes in cols 5:9,
    like the gate and NMS). With ``config.arg_eyes == "refined"`` and a
    block that carries refined centers (eye_iters > 1, cols 10:14 of the
    host row layout), the refined eyes replace cols 5:9 so the Z-frame
    normalization of the heads starts from the better eye estimate. The
    returned array is a copy; detection rows are never mutated.
    """
    if getattr(cfg, "arg_eyes", "pass1") != "refined" or rows.shape[-1] < 14:
        return rows
    out = np.array(rows[:, :10])
    out[:, 5:9] = rows[:, 10:14]
    return out


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
                 pyr_scales: Optional[torch.Tensor] = None,
                 shards: Optional[List[cascade_mod.Shard]] = None
                 ) -> torch.Tensor:
    """Cascade + survivor ranking + eye localization on the device.

    With ``shards`` (``FaceDetector._apply_mesh``) the cascade runs sharded
    and its survivors come back to ``image``'s device, where the rest
    runs.

    Returns a (k_out, 11) block [x0, y0, x1, y1, angle, elx, ely, erx, ery,
    conf, valid]; with config.eye_iters > 1 a (k_out, 15) block whose cols
    11-14 are the refined eye centres (cols 5-8 stay pass 1, which the
    too-far gate and NMS use).
    """
    geom = model.spec.face_geom
    eye_geom = model.spec.eye_geom
    patch_hw = (geom.subimage_height, geom.subimage_width)
    if shards is None:
        shards = [cascade_mod.Shard(state, crops, model.det_nets,
                                    model.det_clfs, image, pyramid,
                                    pyr_scales)]
    out = cascade_mod.run_cascade_shards(model.plan, geom, cfg, patch_hw,
                                         shards)

    with annotate("pfa.eyes") as span:
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

        _, l_boxes, r_boxes = \
            geometry.compute_approximate_eye_boxes_coordinates(
                boxes, angles, face_sampling=DESIRED_SAMPLING,
                eye_sampling=EYE_SAMPLING)
        eye_boxes = torch.cat([l_boxes[:eye_cap], r_boxes[:eye_cap]], dim=0)
        span.update(rows=int(eye_boxes.shape[0]))
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
        # Optional refinement passes: a pure OUTPUT refinement
        # (config.eye_iters).
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


def _detect_core_batch(model: DetectionModel, cfg: DetectorConfig,
                       k_out: int, n_images: int, n_per_image: int,
                       n_levels: int, images: torch.Tensor,
                       state: cascade_mod.CascadeState,
                       pyramid: Optional[torch.Tensor] = None,
                       crops: Optional[torch.Tensor] = None,
                       pyr_scales: Optional[torch.Tensor] = None,
                       shards: Optional[List[cascade_mod.Shard]] = None
                       ) -> torch.Tensor:
    """FUSED multi-image detection: ONE cascade over the windows of all
    ``n_images`` same-sized images plus one eye sub-cascade.

    The per-image path runs B cascades whose per-stage products are only a
    few hundred rows after compaction; fusing makes every stage product
    B times taller for the same total work and divides the launches per
    image by B.

    Args mirror ``_detect_core`` with: ``images`` a (B, H, W) stack;
    ``state`` from ``cascade.make_batched_grid_state`` (tiled grid +
    img_idx); ``pyramid`` the stacked per-image pyramids ((B * L, lh, lw));
    ``pyr_scales`` the single-image ladder tiled B times; ``n_levels`` = L;
    ``shards`` as in ``_detect_core``.

    Returns (B, k, 11) detection blocks (k = min(k_out, rows per image
    after compaction)), rows ranked best-first per image; (B, k, 15) with
    config.eye_iters > 1; packed to uint16 with config.wire_format "u16".
    """
    geom = model.spec.face_geom
    eye_geom = model.spec.eye_geom
    patch_hw = (geom.subimage_height, geom.subimage_width)
    if shards is None:
        shards = [cascade_mod.Shard(state, crops, model.det_nets,
                                    model.det_clfs, images, pyramid,
                                    pyr_scales)]
    out = cascade_mod.run_cascade_shards(
        model.plan, geom, cfg, patch_hw, shards, n_images=n_images,
        n_per_image=n_per_image)

    with annotate("pfa.eyes") as span:
        # Per-image ranked top-k via one stable composite-key sort: rows are
        # grouped contiguously by image (exactly n_last per image; padding
        # sorts last through the img_idx sentinel) -- see run_cascade.
        n_last = cascade_mod.compacted_rows_per_image(model.plan, cfg,
                                                      n_per_image)
        k = min(k_out, n_last)
        rank = (torch.where(out.mask, torch.clamp(out.conf, 0.0, 1.999),
                            torch.full_like(out.conf, 2.0))
                + 4.0 * out.img_idx.to(torch.float32))
        order = torch.argsort(rank, stable=True)
        idx = order[:n_images * n_last].reshape(n_images, n_last)[:, :k]
        flat = idx.reshape(-1)
        boxes = out.boxes[flat]                                # (B*k, 4)
        angles = out.angles[flat]
        conf = out.conf[flat]
        valid = out.mask[flat]

        # Eye sub-cascade on the top eye_cap rows of EACH image (same cap
        # semantics as the single-image path; rows beyond the cap keep the
        # geometric prior and skip the too-far gate).
        eye_cap = min(k, max(cfg.eye_max_faces, 8))
        _, l_all, r_all = geometry.compute_approximate_eye_boxes_coordinates(
            boxes, angles, face_sampling=DESIRED_SAMPLING,
            eye_sampling=EYE_SAMPLING)
        l_all = l_all.reshape(n_images, k, 4)
        r_all = r_all.reshape(n_images, k, 4)
        sub = idx[:, :eye_cap].reshape(-1)                     # (B*eye_cap,)
        ang_sub = out.angles[sub]
        img_sub = out.img_idx[sub]
        eye_boxes = torch.cat([l_all[:, :eye_cap].reshape(-1, 4),
                               r_all[:, :eye_cap].reshape(-1, 4)], dim=0)
        span.update(rows=int(eye_boxes.shape[0]))
        both_angles = torch.cat([ang_sub, ang_sub], dim=0)
        both_img = torch.cat([img_sub, img_sub], dim=0)
        samplers = (cascade_mod.level_samplers(cfg, images.device)
                    if pyramid is not None else None)
        eye_kw = dict(pyramid=pyramid, pyr_scales=pyr_scales,
                      level_sampler=None if samplers is None else samplers[1],
                      image_idx=both_img, n_base_levels=n_levels)
        eye_args = (model.nets["net_eye"], model.clf_input_dim("EyeLX"),
                    model.clf_input_dim("EyeLY"),
                    (eye_geom.subimage_height, eye_geom.subimage_width),
                    images, model.classifier("EyeLX"),
                    model.classifier("EyeLY"))
        pass1_boxes, max_reg = eyes_mod.localize_eyes(
            *eye_args, eye_boxes, both_angles, **eye_kw)
        # config.eye_iters refinement passes; pure output refinement -- gate,
        # NMS and heads consume pass 1, refined centers appended as cols 11-14
        # (see _detect_core).
        new_boxes = pass1_boxes
        for _ in range(cfg.eye_iters - 1):
            new_boxes, _ = eyes_mod.localize_eyes(
                *eye_args, new_boxes, both_angles, **eye_kw)
        m = n_images * eye_cap

        def fin_centers(eb):
            l_fin = torch.cat([eb[:m].reshape(n_images, eye_cap, 4),
                               l_all[:, eye_cap:]], dim=1)
            r_fin = torch.cat([eb[m:].reshape(n_images, eye_cap, 4),
                               r_all[:, eye_cap:]], dim=1)
            return ((l_fin[..., 0:2] + l_fin[..., 2:4]) / 2.0,
                    (r_fin[..., 0:2] + r_fin[..., 2:4]) / 2.0)

        l_c, r_c = fin_centers(pass1_boxes)
        too_far = (max_reg >= cfg.tolerance_xy_eye).reshape(
            2, n_images, eye_cap)
        bad = too_far[0] | too_far[1]                          # (B, eye_cap)
        bad = torch.cat([bad, torch.zeros((n_images, k - eye_cap),
                                          dtype=torch.bool,
                                          device=bad.device)], dim=1)
        valid = valid.reshape(n_images, k) & torch.logical_not(bad)
        cols = [boxes.reshape(n_images, k, 4),
                angles.reshape(n_images, k)[..., None], l_c, r_c,
                conf.reshape(n_images, k)[..., None],
                valid[..., None].to(torch.float32)]
        if cfg.eye_iters > 1:
            cols += list(fin_centers(new_boxes))
        block = torch.cat(cols, dim=2)
        if cfg.wire_format == "u16":
            block = _pack_wire(block, max(images.shape[-2:]))
        return block


class FaceDetector:
    """End-to-end detector with the reference's public behaviour."""

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
        # Data-parallel inference: a 1-D mesh over which the window batch
        # of detect and of the fused batch is sharded (--data_mesh=N). One
        # device (data_mesh 1) takes no mesh, as in the JAX package.
        self._mesh = None
        self._mesh_weights = None
        if config.data_mesh > 1:
            self._mesh = mesh_mod.make_mesh(config.data_mesh,
                                            device=self.device)
            # The survivors come back to the mesh's first device, where the
            # canvas, the eye pass and the heads are.
            if (self.device.type == "cuda"
                    and (self.device.index or 0) != self._mesh.leader.index):
                raise ValueError(
                    f"a data mesh of {config.data_mesh} cards starts at "
                    f"{self._mesh.leader}; the detector runs on "
                    f"{self.device}")
        # Fixed canvas: every input of the same prescaled size shares it.
        side = config.prescale_size if config.image_prescaling else 2048
        _check_wire_range(config, side)
        self._canvas_hw = (side, side)
        # The grid is a pure function of (image size, batch) for a fixed
        # config (tracking grids depend on the last detection and bypass
        # this).
        self._grid_cache: dict = {}

    # -- image preparation ---------------------------------------------------

    def _grid_state(self, im_w: int, im_h: int, batch: int = 0,
                    track: Optional[Tuple] = None):
        """(state, n_real, pyr) of the window grid, cached for a
        non-tracking grid.

        ``batch=0`` -> make_grid_state; ``batch=B`` -> the fused
        make_batched_grid_state; ``track`` -> the tracking grid around the
        last detection, built anew. The cascade never writes through a
        state, so reuse across calls is safe."""
        with annotate("pfa.grid") as span:
            geom = self.model.spec.face_geom
            if track is not None:
                hit = cascade_mod.make_grid_state(
                    im_w, im_h, geom, self.config, track, device=self.device)
            else:
                key = (im_w, im_h, batch)
                hit = self._grid_cache.get(key)
                if hit is None:
                    if batch:
                        hit = cascade_mod.make_batched_grid_state(
                            im_w, im_h, geom, self.config, batch,
                            device=self.device)
                    else:
                        hit = cascade_mod.make_grid_state(
                            im_w, im_h, geom, self.config,
                            device=self.device)
                    self._grid_cache[key] = hit
            span.update(rows=int(hit[0].mask.shape[0]),
                        real=hit[1] * max(batch, 1))
            return hit

    def _fit_canvas(self, h: int, w: int) -> Tuple[int, int]:
        """The canvas for (h, w) inputs. Inputs larger than the canvas
        (possible only with image_prescaling off) grow it to the next
        multiple of 512, within the u16 wire's range."""
        H, W = self._canvas_hw
        if h > H or w > W:
            side = int(-(-max(h, w) // 512) * 512)
            _check_wire_range(self.config, side)
            self._canvas_hw = (side, side)
        return self._canvas_hw

    def prescale_factor(self, w: int, h: int) -> float:
        """Reference prescaling: max side <= prescale_size."""
        if not self.config.image_prescaling:
            return 1.0
        return min(1.0, self.config.prescale_size / float(max(w, h)))

    def _to_canvas(self, image: np.ndarray) -> torch.Tensor:
        """Pads into the fixed canvas on the device."""
        with annotate("pfa.upload"):
            H, W = self._fit_canvas(*image.shape)
            return _pad_convert(_to_u8(image), H, W, self.device)

    def _to_canvas_batch(self, images: Sequence[np.ndarray],
                         request=None) -> torch.Tensor:
        """B same-sized (h, w) images -> (B, H, W) float canvas stack, in
        ONE host-to-device copy of the true image extents as uint8."""
        with annotate("pfa.upload", request=request):
            H, W = self._fit_canvas(*images[0].shape)
            return _pad_convert(np.stack([_to_u8(im) for im in images]), H,
                                W, self.device)

    def _use_pyramid(self, pyr) -> bool:
        """Pyramid path for the iter-0 extraction (nearest interp only)."""
        return (pyr is not None and self.config.interpolation_formats[
            self.model.plan[0].serial] == "nearest")

    def _scales(self, pyr, tile: int = 1) -> torch.Tensor:
        return torch.tensor(pyr.scales * tile, dtype=torch.float32,
                            device=self.device)

    def _apply_mesh(self, state, crops, image, pyramid, scales
                    ) -> List[cascade_mod.Shard]:
        """The window state and the crop table sharded over the data mesh;
        canvas, pyramid and scales replicated. The networks and
        classifiers are copied once to each distinct device of a mesh
        (again only when the mesh is replaced)."""
        mesh = self._mesh
        if self._mesh_weights is None or self._mesh_weights[0] is not mesh:
            self._mesh_weights = (mesh, mesh_mod.replicate_weights(
                mesh, self.model.det_nets, self.model.det_clfs))
        return mesh_mod.cascade_shards(mesh, state, crops,
                                       self._mesh_weights[1], image, pyramid,
                                       scales)

    # -- one image -------------------------------------------------------------

    def detect(self, image: np.ndarray, estimate_attributes: bool = True,
               collect_trace: bool = False) -> List[Detection]:
        """Detects faces in a grayscale (H, W) image with values in [0, 1]
        (already prescaled, see io.images.load_image); coordinates are in
        this frame."""
        with annotate("pfa.detect"):
            device_image = self._to_canvas(image)
            with annotate("pfa.dispatch"):
                block = self._dispatch_one(device_image, image.shape,
                                           collect_trace)
            if block is None:
                return []
            with annotate("pfa.finish", images=1):
                return self._finish_one(device_image, block,
                                        estimate_attributes)

    def _dispatch_one(self, device_image: torch.Tensor,
                      hw: Tuple[int, int], collect_trace: bool
                      ) -> Optional[torch.Tensor]:
        """Grid, pyramid and the enqueued (k_out, 11) block of one image
        (None when the grid is empty)."""
        cfg = self.config
        model = self.model
        im_h, im_w = hw
        geom = model.spec.face_geom
        track = self.tracked_face if (cfg.track_single_face and
                                      self.face_has_been_found) else None
        state, n_real, pyr = self._grid_state(im_w, im_h, track=track)
        self.windows_scanned = n_real
        if n_real == 0:
            return None
        pyramid = crops = scales_arr = None
        if self._use_pyramid(pyr):
            with annotate("pfa.pyramid"):
                pyramid = build_pyramid(device_image, pyr.scales,
                                        pyr.level_hw)
            crops = pyr.crops
            scales_arr = self._scales(pyr)

        self.last_trace = None
        if collect_trace:
            # Per-stage attribution only (compaction off); the detections
            # always come from the production run below.
            _, trace = cascade_mod.run_cascade(
                model.plan, model.det_nets, geom, cfg,
                (geom.subimage_height, geom.subimage_width),
                device_image, model.det_clfs, state, pyramid=pyramid,
                crops=crops, pyr_scales=scales_arr, collect_trace=True)
            with annotate("pfa.pull"):
                self.last_trace = [tuple(t.cpu().numpy() for t in snap)
                                   for snap in trace]
        shards = (None if self._mesh is None else self._apply_mesh(
            state, crops, device_image, pyramid, scales_arr))
        return _detect_core(model, cfg, cfg.max_detections, device_image,
                            state, pyramid, crops, scales_arr, shards)

    def _finish_one(self, device_image: torch.Tensor, block: torch.Tensor,
                    estimate_attributes: bool) -> List[Detection]:
        """The one result pull, NMS, tracking, heads and assembly of one
        image's block."""
        cfg = self.config
        purged = self._purge([_pull(block)])[0]
        self._update_tracking(purged)
        if len(purged) == 0:
            return []
        dets = self._assemble_batch(device_image[None], [purged],
                                    estimate_attributes)[0]
        if (estimate_attributes and cfg.save_age_estimation_images
                and self._wants_attributes()):
            self._age_image_index = heads_mod.save_age_estimation_images(
                device_image, _arg_rows(purged, cfg),
                start_index=getattr(self, "_age_image_index", 0))
        return dets

    # -- batched multi-image detection ----------------------------------------

    def detect_batch(self, images: Sequence[np.ndarray],
                     estimate_attributes: bool = True
                     ) -> List[List[Detection]]:
        """Detects faces in MANY same-sized grayscale images at once.

        cfg.batch_mode selects the device strategy:
        - "fused" (default): ONE cascade over every image's windows
          (_detect_core_batch) -- per-stage products are B times taller
          for the same work and the launches per image fall B-fold; one
          (B, k, 11) result pull. More than ``max_fused_batch`` images are
          processed in chunks of that size.
        - "async": one cascade per image, enqueued back-to-back, results
          pulled afterwards -- lower peak device memory.
        Images of differing sizes, and tracking mode, fall back to
        sequential detect().
        """
        if len(images) == 0:
            return []
        cfg = self.config
        shape0 = images[0].shape
        if any(im.shape != shape0 for im in images) or \
                cfg.track_single_face:
            return [self.detect(im, estimate_attributes) for im in images]

        if cfg.batch_mode == "fused":
            if len(images) > cfg.max_fused_batch:
                # The cap is kept from the JAX package, where the crop
                # kernel's scalar memory set it; here it bounds the peak
                # device memory of one fused cascade.
                out: List[List[Detection]] = []
                for k in range(0, len(images), cfg.max_fused_batch):
                    out.extend(self.detect_batch(
                        images[k: k + cfg.max_fused_batch],
                        estimate_attributes))
                return out
            stack, fut = self._dispatch_fused(images)
            return self._finish_fused(stack, fut, estimate_attributes)

        # Async mode: enqueue one cascade per image, pull afterwards.
        model = self.model
        im_h, im_w = shape0
        state, n_real, pyr = self._grid_state(im_w, im_h)
        self.windows_scanned = n_real
        if n_real == 0:
            return [[] for _ in images]
        use_pyr = self._use_pyramid(pyr)
        scales_arr = self._scales(pyr) if use_pyr else None
        device_images, futures = [], []
        for im in images:
            device_image = self._to_canvas(im)
            device_images.append(device_image)
            pyramid = crops = None
            if use_pyr:
                with annotate("pfa.pyramid"):
                    pyramid = build_pyramid(device_image, pyr.scales,
                                            pyr.level_hw)
                crops = pyr.crops
            futures.append(_detect_core(
                model, cfg, cfg.max_detections, device_image, state,
                pyramid, crops, scales_arr))
        purged_per_image = self._purge([_pull(fut) for fut in futures])
        return self._assemble_batch(torch.stack(device_images),
                                    purged_per_image, estimate_attributes)

    # -- fused-path pieces (shared by detect_batch and detect_stream) ---------

    def _dispatch_fused(self, images: Sequence[np.ndarray],
                        stack: Optional[torch.Tensor] = None,
                        request=None):
        """Copies a same-sized image batch to the device and enqueues the
        fused cascade.

        Returns ``(stack, future)`` where ``future`` is the not-yet-pulled
        (B, k, 11) device block (None when the grid is empty). On CUDA the
        cascade runs asynchronously -- callers can overlap it with host
        work or with pulling a previous batch (see detect_stream).
        ``stack`` may carry the canvas batch already on the device (the
        stream's producer thread makes it; None = convert and copy here).
        ``request`` names the batch in the spans (utils.profiling)."""
        cfg, model = self.config, self.model
        im_h, im_w = images[0].shape
        B = len(images)
        with annotate("pfa.dispatch", request=request):
            state_b, n_real, pyr_b = self._grid_state(im_w, im_h, batch=B)
            self.windows_scanned = n_real
            if stack is None:
                stack = self._to_canvas_batch(images)
            if n_real == 0:
                # Image below the scale envelope: nothing to scan.
                return stack, None
            pyramid_b = crops_b = scales_b = None
            n_levels = 0
            if self._use_pyramid(pyr_b):
                n_levels = len(pyr_b.scales)
                with annotate("pfa.pyramid"):
                    pyramid_b = build_pyramid_batch(stack, pyr_b.scales,
                                                    pyr_b.level_hw)
                crops_b = pyr_b.crops
                scales_b = self._scales(pyr_b, tile=B)
            shards = (None if self._mesh is None else self._apply_mesh(
                state_b, crops_b, stack, pyramid_b, scales_b))
            fut = _detect_core_batch(
                model, cfg, cfg.max_detections, B, n_real, n_levels, stack,
                state_b, pyramid_b, crops_b, scales_b, shards)
            return stack, fut

    def _purge(self, blocks: Iterable[np.ndarray]) -> List[np.ndarray]:
        """Host NMS of the valid rows of each pulled block."""
        with annotate("pfa.nms") as span:
            out, rows_in = [], 0
            for block in blocks:
                rows = _block_rows(block)
                rows_in += len(rows)
                out.append(nms_mod.purge_detections(
                    rows, self.config.purge_threshold) if len(rows)
                    else np.zeros((0, 10)))
            span.update(rows_in=rows_in, kept=sum(len(p) for p in out))
            return out

    def _finish_fused(self, stack: torch.Tensor,
                      fut: Optional[torch.Tensor],
                      estimate_attributes: bool,
                      request=None) -> List[List[Detection]]:
        """Result pull, host NMS, attribute heads and Detection assembly of
        a dispatched fused batch (``_dispatch_fused``'s pair)."""
        B = int(stack.shape[0])
        with annotate("pfa.finish", request=request, images=B):
            if fut is None:                      # n_real == 0 sentinel
                return [[] for _ in range(B)]
            blocks = _pull(fut)
            if blocks.dtype == np.uint16:        # wire_format="u16"
                blocks = _unpack_wire(blocks, max(stack.shape[-2:]))
            return self._assemble_batch(stack, self._purge(blocks),
                                        estimate_attributes)

    def detect_stream(self, batches: Iterable[Sequence[np.ndarray]],
                      estimate_attributes: bool = True,
                      depth: Optional[int] = None):
        """Pipelined batched detection over an iterable of image batches.

        Yields one ``List[List[Detection]]`` per input batch, in order.
        Up to ``depth`` (default ``config.stream_depth``) batches are kept
        in flight: while batch i's result is pulled and post-processed on
        the host (NMS, attribute heads, assembly), batches i+1..i+depth-1
        are already on the device with their cascades enqueued. Depth 1
        reproduces back-to-back detect_batch. Each in-flight batch holds
        its canvas stack on the device.

        Batches must each contain same-sized images (sizes may differ
        ACROSS batches); tracking mode, a ragged batch, one above
        ``max_fused_batch`` or ``batch_mode != "fused"`` falls back to a
        plain detect_batch call for that batch (pipeline flushed first).

        With ``config.stream_push_prefetch`` the stream runs in three
        stages over two helper threads: a producer (uint8 conversion and
        the host-to-device copy), the caller's thread (cascade dispatch)
        and a finisher (result pull, NMS, attribute heads, assembly). The
        finisher enqueues device work too: the heads' program of each
        batch. All device work stays on the default stream, so it executes
        in the order it was enqueued, and each of the finisher's two pulls
        (the result block, the heads' output) waits for everything enqueued
        before it, the cascades of later batches included: the overlap is
        less than ``depth`` suggests. So does each host-to-device copy
        (the producer's canvases, the dispatch's scale table and u16
        constants, the heads' inputs): PyTorch synchronises the stream
        after a copy made without ``non_blocking``, so a batch's dispatch
        returns only once its own cascade has run. The copies and pulls
        release the interpreter lock, so the stages overlap; order is kept
        because both queues are FIFO. Each batch's spans carry its index
        in the stream as their request (utils.profiling).
        """
        cfg = self.config
        depth = max(1, int(cfg.stream_depth if depth is None else depth))

        def is_ragged(images):
            return (len(images) == 0 or
                    len(images) > cfg.max_fused_batch or
                    any(im.shape != images[0].shape for im in images) or
                    cfg.track_single_face or cfg.batch_mode != "fused")

        if not cfg.stream_push_prefetch:
            q: deque = deque()

            def finish_oldest():
                j, stack, fut = q.popleft()
                return self._finish_fused(stack, fut, estimate_attributes,
                                          request=j)

            for j, images in enumerate(batches):
                if is_ragged(images):
                    while q:
                        yield finish_oldest()
                    yield self.detect_batch(images, estimate_attributes)
                    continue
                q.append((j, *self._dispatch_fused(images, request=j)))
                if len(q) >= depth:
                    yield finish_oldest()
            while q:
                yield finish_oldest()
            return

        ready: queue.Queue = queue.Queue(maxsize=depth)
        to_finish: queue.Queue = queue.Queue()
        done: queue.Queue = queue.Queue()
        end = object()
        stop = threading.Event()

        def produce():
            try:
                for j, images in enumerate(batches):
                    if stop.is_set():       # the consumer abandoned us
                        return
                    stack = None
                    if not is_ragged(images):
                        stack = self._to_canvas_batch(images, request=j)
                    with annotate("pfa.stream.producer_wait", request=j):
                        ready.put((j, images, stack))
            except BaseException as e:      # re-raised on the consumer
                ready.put(e)
                return
            ready.put(end)

        def finish():
            try:
                while True:
                    with annotate("pfa.stream.finisher_wait"):
                        item = to_finish.get()
                    if item is end:
                        return
                    j, stack, fut = item
                    done.put(self._finish_fused(stack, fut,
                                                estimate_attributes,
                                                request=j))
            except BaseException as e:      # re-raised on the consumer
                done.put(e)

        producer = threading.Thread(target=produce, daemon=True,
                                    name="pfa-stream-push")
        finisher = threading.Thread(target=finish, daemon=True,
                                    name="pfa-stream-finish")
        producer.start()
        finisher.start()
        in_flight = 0

        def drain_one():
            nonlocal in_flight
            with annotate("pfa.stream.wait_result"):
                out = done.get()
            in_flight -= 1
            if isinstance(out, BaseException):
                raise out
            return out

        try:
            while True:
                with annotate("pfa.stream.wait_input"):
                    item = ready.get()
                if item is end:
                    break
                if isinstance(item, BaseException):
                    raise item
                j, images, stack = item
                if stack is None:           # ragged: flush + fall back
                    while in_flight:
                        yield drain_one()
                    yield self.detect_batch(images, estimate_attributes)
                    continue
                to_finish.put((j, *self._dispatch_fused(
                    images, stack=stack, request=j)))
                in_flight += 1
                if in_flight >= depth:
                    yield drain_one()
            while in_flight:
                yield drain_one()
        finally:
            stop.set()
            to_finish.put(end)
            try:                 # unblock a put-blocked producer
                while True:
                    ready.get_nowait()
            except queue.Empty:
                pass
            producer.join(timeout=5.0)
            finisher.join(timeout=5.0)

    def _wants_attributes(self) -> bool:
        cfg = self.config
        return cfg.estimate_age or cfg.estimate_race or cfg.estimate_gender

    def _assemble_batch(self, stack: torch.Tensor,
                        purged_per_image: List[np.ndarray],
                        estimate_attributes: bool) -> List[List[Detection]]:
        """Attribute heads over all faces of the (B, H, W) canvas stack
        (one device program, one pull) and the Detection lists."""
        cfg = self.config
        ages = stds = races = genders = None
        counts = [len(p) for p in purged_per_image]
        if (estimate_attributes and self._wants_attributes()
                and sum(counts) > 0):
            with annotate("pfa.heads", faces=sum(counts)):
                all_rows = np.concatenate(
                    [_arg_rows(p, cfg) for p in purged_per_image if len(p)],
                    axis=0)
                img_idx = np.repeat(np.arange(len(counts)), counts)
                ages, stds, races, genders = \
                    heads_mod.estimate_age_race_gender_multi(
                        stack, all_rows, img_idx, self.model,
                        tta=cfg.arg_tta)

        out: List[List[Detection]] = []
        offset = 0
        with annotate("pfa.assemble", detections=sum(counts)):
            for purged in purged_per_image:
                dets = []
                for j, r in enumerate(purged):
                    k = offset + j
                    el, er = _row_eyes(r, cfg)
                    dets.append(Detection(
                        box=tuple(float(v) for v in r[0:4]),
                        angle=float(r[4]), eye_left=el, eye_right=er,
                        confidence=float(r[9]),
                        age=None if ages is None else float(ages[k]),
                        age_std=None if stds is None else float(stds[k]),
                        race_value=(None if races is None
                                    else float(races[k])),
                        gender_value=(None if genders is None
                                      else float(genders[k]))))
                offset += len(purged)
                out.append(dets)
        return out

    def _update_tracking(self, purged: np.ndarray) -> None:
        if not self.config.track_single_face:
            return
        if len(purged) > 0:
            self.tracked_face = tuple(purged[0][0:4])
            self.face_has_been_found = True
        else:
            self.face_has_been_found = False
