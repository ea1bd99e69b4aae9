"""FaceDetector: the top-level entry for one image, a batch or a stream.

Port of ``pyfaceanalysis_tpu.engine.detector``: canvas -> pyramid ->
all-scales grid -> masked cascade (engine.cascade) -> survivor ranking ->
approximate eye boxes -> eye localization (engine.eyes) -> host NMS
(engine.nms) -> age/race/gender heads (engine.heads) ->
:class:`Detection` rows.

Host/device split as in the JAX package: grid construction, NMS and
bookkeeping are host numpy; everything per window runs on the model's
device. One function, ``_detect_core``, is the device program of both
``detect`` and the fused ``detect_batch`` (ONE cascade over the windows of
every image of the batch): cascade, ranking, eye pass, too-far gate and
result block over (B, k) rows, one image being B = 1; only which rows the
ranking selects depends on whether the rows carry an image index. One
(k_out, 11) block crosses back to the host per image (``detect``), or one
(B, k, 11) block per batch, plus one (4, N) block of attributes.
``detect_stream`` keeps several batches in flight. With
``config.data_mesh`` above 1 the window batch of ``detect`` and of the
fused batch is sharded over a data mesh of that many devices
(``parallel.mesh``); the ranking, the eye pass and the heads run on the
first device over all survivors.
"""

from __future__ import annotations

import dataclasses
import functools
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
from pyfaceanalysis_torch.engine import graphs
from pyfaceanalysis_torch.engine import heads as heads_mod
from pyfaceanalysis_torch.engine import nms as nms_mod
from pyfaceanalysis_torch.engine import upload as upload_mod
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


@functools.lru_cache(maxsize=64)
def _wire_constants(ncols: int, canvas_side: int, device: torch.device
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(offset, scale) of _wire_affine on ``device``, copied there once per
    (ncols, canvas side, device)."""
    off, scale = _wire_affine(ncols, _wire_coord_scale(canvas_side))
    return (torch.as_tensor(off, device=device),
            torch.as_tensor(scale, device=device))


def _pack_wire(block: torch.Tensor, canvas_side: int) -> torch.Tensor:
    """Device-side u16 pack of a (..., ncols) float32 block: round half to
    even, clip to [0, 65535] (see _wire_affine)."""
    off, scale = _wire_constants(block.shape[-1], canvas_side, block.device)
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


def _row_eyes(r: List[float], cfg=None
              ) -> Tuple[Tuple[float, float], Tuple[float, float]]:
    """REPORTED eye centres of a purged row (a ``.tolist()`` row of Python
    floats): the refined pass when present (cols 10:14), else the pass-1
    positions (cols 5:9); ``config.eye_report == "pass1"`` reports pass 1
    regardless."""
    report_refined = (len(r) >= 14 and
                      (cfg is None or
                       getattr(cfg, "eye_report", "refined") == "refined"))
    e = r[10:14] if report_refined else r[5:9]
    return (e[0], e[1]), (e[2], e[3])


def _detect_core(model: DetectionModel, cfg: DetectorConfig, k_out: int,
                 images: torch.Tensor, state: cascade_mod.CascadeState,
                 pyramid: Optional[torch.Tensor] = None,
                 crops: Optional[torch.Tensor] = None,
                 pyr_scales: Optional[torch.Tensor] = None,
                 shards: Optional[List[cascade_mod.Shard]] = None,
                 n_images: int = 1, n_per_image: int = 0, n_levels: int = 0
                 ) -> torch.Tensor:
    """Cascade + survivor ranking + eye localization on the device, for one
    image or for a FUSED batch of ``n_images`` same-sized images.

    One image: ``images`` is the (H, W) canvas and ``state`` comes from
    ``cascade.make_grid_state`` (rows carry no image index). Fused batch:
    ``images`` is a (B, H, W) stack, ``state`` comes from
    ``cascade.make_batched_grid_state`` (tiled grid + img_idx, real rows
    ``n_per_image`` per image), ``pyramid`` holds the stacked per-image
    pyramids ((B * n_levels, lh, lw)) and ``pyr_scales`` the single-image
    ladder tiled B times. ONE cascade runs over the windows of all images:
    every stage product is B times taller for the same total work, and the
    launches per image fall B-fold. With ``shards``
    (``FaceDetector._apply_mesh``) the cascade runs sharded and its
    survivors come back to ``images``' device, where the rest runs.

    Returns (B, k, 11) blocks [x0, y0, x1, y1, angle, elx, ely, erx, ery,
    conf, valid], rows ranked best-first per image (B = 1 for one image;
    k = min(k_out, rows per image after compaction)); with config.eye_iters
    > 1, (B, k, 15) blocks whose cols 11-14 are the refined eye centres
    (cols 5-8 stay pass 1, which the too-far gate and NMS use).
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
        # Alive rows first, best (lowest) Disc confidence first within them.
        if out.img_idx is None:
            k = min(k_out, out.mask.shape[0])
            rank = torch.where(out.mask, out.conf,
                               torch.full_like(out.conf, 2.0))
            idx = torch.argsort(rank, stable=True)[:k][None]
        else:
            # Per image, by one stable composite-key sort: rows are grouped
            # contiguously by image (exactly n_last per image; padding
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

        # The eye sub-cascade runs on the top eye_cap rows of EACH image;
        # rows beyond the cap keep the geometric eye prior and skip the
        # too-far gate.
        eye_cap = min(k, max(cfg.eye_max_faces, 8))

        def per_image(t):                                      # (B, k, ...)
            return t.reshape(n_images, k, *t.shape[1:])

        def capped(t):                                         # (B*eye_cap,)
            return per_image(t)[:, :eye_cap].reshape(-1, *t.shape[1:])

        def both(t):                                           # L rows, R rows
            return torch.cat([t, t], dim=0)

        _, l_all, r_all = geometry.compute_approximate_eye_boxes_coordinates(
            boxes, angles, face_sampling=DESIRED_SAMPLING,
            eye_sampling=EYE_SAMPLING)
        eye_boxes = torch.cat([capped(l_all), capped(r_all)], dim=0)
        span.update(rows=int(eye_boxes.shape[0]))
        both_angles = both(capped(angles))
        samplers = (cascade_mod.level_samplers(cfg, images.device)
                    if pyramid is not None else None)
        eye_kw = dict(pyramid=pyramid, pyr_scales=pyr_scales,
                      level_sampler=None if samplers is None else samplers[1])
        if out.img_idx is not None:
            eye_kw.update(image_idx=both(capped(out.img_idx[flat])),
                          n_base_levels=n_levels)
        eye_args = (model.nets["net_eye"], model.clf_input_dim("EyeLX"),
                    model.clf_input_dim("EyeLY"),
                    (eye_geom.subimage_height, eye_geom.subimage_width),
                    images, model.classifier("EyeLX"),
                    model.classifier("EyeLY"))
        pass1_boxes, max_reg = eyes_mod.localize_eyes(
            *eye_args, eye_boxes, both_angles, **eye_kw)
        # Optional refinement passes: a pure OUTPUT refinement
        # (config.eye_iters).
        new_boxes = pass1_boxes
        for _ in range(cfg.eye_iters - 1):
            new_boxes, _ = eyes_mod.localize_eyes(
                *eye_args, new_boxes, both_angles, **eye_kw)
        m = n_images * eye_cap

        def centres(eb):
            l_fin = torch.cat([eb[:m].reshape(n_images, eye_cap, 4),
                               per_image(l_all)[:, eye_cap:]], dim=1)
            r_fin = torch.cat([eb[m:].reshape(n_images, eye_cap, 4),
                               per_image(r_all)[:, eye_cap:]], dim=1)
            return ((l_fin[..., 0:2] + l_fin[..., 2:4]) / 2.0,
                    (r_fin[..., 0:2] + r_fin[..., 2:4]) / 2.0)

        too_far = (max_reg >= cfg.tolerance_xy_eye).reshape(
            2, n_images, eye_cap)
        bad = too_far[0] | too_far[1]                          # (B, eye_cap)
        bad = torch.cat([bad, torch.zeros((n_images, k - eye_cap),
                                          dtype=torch.bool,
                                          device=bad.device)], dim=1)
        valid = per_image(valid) & torch.logical_not(bad)
        cols = [per_image(boxes), per_image(angles)[..., None],
                *centres(pass1_boxes), per_image(conf)[..., None],
                valid[..., None].to(torch.float32)]
        if cfg.eye_iters > 1:
            cols += list(centres(new_boxes))
        return torch.cat(cols, dim=2)


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
        # The dispatches' device work, captured per shape (engine.graphs),
        # and on a card the heads', per stack shape and face bucket
        # (engine.heads; the CPU runs them eagerly).
        self._graphs = graphs.GraphCache()
        self._head_graphs = (graphs.GraphCache()
                             if self.device.type == "cuda" else None)
        # The upload's staging slots: one for each batch in flight in a
        # stream of the default depth and one for the batch being copied.
        self._upload = upload_mod.Uploader(self.device,
                                           config.stream_depth + 1)

    # -- image preparation ---------------------------------------------------

    def _grid_state(self, im_w: int, im_h: int, batch: int = 0,
                    track: Optional[Tuple] = None):
        """(state, n_real, pyr, scales) of the window grid, cached for a
        non-tracking grid; ``scales`` is the pyramid's scale ladder on the
        device, tiled ``batch`` times (None without a pyramid).

        ``batch=0`` -> make_grid_state; ``batch=B`` -> the fused
        make_batched_grid_state; ``track`` -> the tracking grid around the
        last detection, built anew. The cascade never writes through a
        state, so reuse across calls is safe."""
        with annotate("pfa.grid") as span:
            if track is not None:
                hit = self._make_grid(im_w, im_h, 0, track)
            else:
                key = (im_w, im_h, batch)
                hit = self._grid_cache.get(key)
                if hit is None:
                    hit = self._grid_cache[key] = self._make_grid(
                        im_w, im_h, batch)
            span.update(rows=int(hit[0].mask.shape[0]),
                        real=hit[1] * max(batch, 1))
            return hit

    def _make_grid(self, im_w: int, im_h: int, batch: int,
                   track: Optional[Tuple] = None):
        geom = self.model.spec.face_geom
        if batch:
            state, n_real, pyr = cascade_mod.make_batched_grid_state(
                im_w, im_h, geom, self.config, batch, device=self.device)
        else:
            state, n_real, pyr = cascade_mod.make_grid_state(
                im_w, im_h, geom, self.config, track, device=self.device)
        scales = None if pyr is None else torch.tensor(
            pyr.scales * max(batch, 1), dtype=torch.float32,
            device=self.device)
        return state, n_real, pyr, scales

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
        """One (h, w) image -> its (H, W) float canvas on the device
        (engine.upload)."""
        H, W = self._fit_canvas(*image.shape)
        return self._upload.canvas([image], H, W)[0]

    def _to_canvas_batch(self, images: Sequence[np.ndarray],
                         request=None) -> torch.Tensor:
        """B same-sized (h, w) images -> (B, H, W) float canvas stack, in
        ONE host-to-device copy of the true image extents (engine.upload);
        ``request`` names the batch in the upload's span."""
        H, W = self._fit_canvas(*images[0].shape)
        return self._upload.canvas(images, H, W, request=request)

    def _use_pyramid(self, pyr) -> bool:
        """Pyramid path for the iter-0 extraction (nearest interp only)."""
        return (pyr is not None and self.config.interpolation_formats[
            self.model.plan[0].serial] == "nearest")

    def _graphable(self, pyr, track=None, collect_trace: bool = False
                   ) -> bool:
        """Whether a dispatch's device work goes through the graph cache:
        on a card, unsharded (a mesh's rungs pull indices to the host), on
        a cached grid (a tracking grid changes every frame), without the
        per-stage trace, and on the pyramid path."""
        return (self.device.type == "cuda" and self._mesh is None
                and track is None and not collect_trace
                and self._use_pyramid(pyr))

    def _device_work(self, work: graphs.Work, canvas: torch.Tensor,
                     grid_key: Tuple[int, int, int], graphable: bool
                     ) -> Tuple[torch.Tensor, bool]:
        """``work(canvas)``, eagerly or through the graph of its shapes
        (engine.graphs); returns the block and whether a graph replayed."""
        if not graphable:
            return work(canvas), False
        ncols = 15 if self.config.eye_iters > 1 else 11
        with torch.cuda.device(self.device):
            return self._graphs.run((tuple(canvas.shape), grid_key, ncols),
                                    canvas, work)

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
        (None when the grid is empty), in a ``pfa.dispatch`` span."""
        cfg = self.config
        model = self.model
        im_h, im_w = hw
        geom = model.spec.face_geom
        with annotate("pfa.dispatch", graph=0) as span:
            track = self.tracked_face if (cfg.track_single_face and
                                          self.face_has_been_found) else None
            state, n_real, pyr, scales = self._grid_state(im_w, im_h,
                                                          track=track)
            self.windows_scanned = n_real
            if n_real == 0:
                return None
            self.last_trace = None
            use_pyr = self._use_pyramid(pyr)

            def work(image: torch.Tensor) -> torch.Tensor:
                pyramid = crops = scales_arr = None
                if use_pyr:
                    with annotate("pfa.pyramid"):
                        pyramid = build_pyramid(image, pyr.scales,
                                                pyr.level_hw)
                    crops, scales_arr = pyr.crops, scales
                if collect_trace:
                    # Per-stage attribution only (compaction off); the
                    # detections always come from the production run
                    # below.
                    _, trace = cascade_mod.run_cascade(
                        model.plan, model.det_nets, geom, cfg,
                        (geom.subimage_height, geom.subimage_width),
                        image, model.det_clfs, state, pyramid=pyramid,
                        crops=crops, pyr_scales=scales_arr,
                        collect_trace=True)
                    with annotate("pfa.pull"):
                        self.last_trace = [
                            tuple(t.cpu().numpy() for t in snap)
                            for snap in trace]
                shards = (None if self._mesh is None else self._apply_mesh(
                    state, crops, image, pyramid, scales_arr))
                return _detect_core(model, cfg, cfg.max_detections, image,
                                    state, pyramid, crops, scales_arr,
                                    shards)[0]

            block, replayed = self._device_work(
                work, device_image, (im_w, im_h, 0),
                self._graphable(pyr, track, collect_trace))
            span.update(graph=int(replayed))
            return block

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
          (_detect_core) -- per-stage products are B times taller
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
        device_images, futures = [], []
        for im in images:
            device_image = self._to_canvas(im)
            block = self._dispatch_one(device_image, shape0, False)
            if block is None:                    # the same empty grid
                return [[] for _ in images]
            device_images.append(device_image)
            futures.append(block)
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
        (B, k, 11) device block (None when the grid is empty), packed to
        uint16 with config.wire_format "u16". On CUDA the cascade runs
        asynchronously -- callers can overlap it with host work or with
        pulling a previous batch (see detect_stream).
        ``stack`` may carry the canvas batch already on the device (the
        stream's producer thread makes it; None = convert and copy here).
        ``request`` names the batch in the spans (utils.profiling)."""
        cfg, model = self.config, self.model
        im_h, im_w = images[0].shape
        B = len(images)
        with annotate("pfa.dispatch", request=request, graph=0) as span:
            state_b, n_real, pyr_b, scales_b = self._grid_state(
                im_w, im_h, batch=B)
            self.windows_scanned = n_real
            if stack is None:
                stack = self._to_canvas_batch(images)
            if n_real == 0:
                # Image below the scale envelope: nothing to scan.
                return stack, None
            use_pyr = self._use_pyramid(pyr_b)
            n_levels = len(pyr_b.scales) if use_pyr else 0

            def work(canvases: torch.Tensor) -> torch.Tensor:
                pyramid_b = crops_b = scales_arr = None
                if use_pyr:
                    with annotate("pfa.pyramid"):
                        pyramid_b = build_pyramid_batch(
                            canvases, pyr_b.scales, pyr_b.level_hw)
                    crops_b, scales_arr = pyr_b.crops, scales_b
                shards = (None if self._mesh is None else self._apply_mesh(
                    state_b, crops_b, canvases, pyramid_b, scales_arr))
                block = _detect_core(
                    model, cfg, cfg.max_detections, canvases, state_b,
                    pyramid_b, crops_b, scales_arr, shards, n_images=B,
                    n_per_image=n_real, n_levels=n_levels)
                if cfg.wire_format == "u16":
                    block = _pack_wire(block, max(canvases.shape[-2:]))
                return block

            fut, replayed = self._device_work(work, stack, (im_w, im_h, B),
                                              self._graphable(pyr_b))
            span.update(graph=int(replayed))
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
        stages over two helper threads: a producer (the upload), the
        caller's thread (cascade dispatch) and a finisher (result pull,
        NMS, attribute heads, assembly). The finisher enqueues device work
        too: the heads' program of each batch. All device work but the
        upload's copies stays on the default stream, so it executes in the
        order it was enqueued, and each of the finisher's two pulls (the
        result block, the heads' output) waits for everything enqueued
        before it, the cascades of later batches included: the overlap is
        less than ``depth`` suggests. The producer does not wait so
        (engine.upload): it copies a batch's float rows into a pinned
        staging slot, enqueues the slot's copy to the card on the upload's
        own stream, where the copy engine overlaps the cascades in flight,
        and enqueues the rounding to the canvas on the default stream
        behind the copy's event. The producer waits only when a
        slot's earlier copy has not completed (``pfa.upload.wait``); the
        copy stream does not overwrite a device slot before the conversion
        that read it has run. The finisher's one copy, the heads' face
        table, comes from pinned memory without blocking, so the finisher
        enqueues it and the heads' program behind the batches in flight
        and waits only in the heads' pull. The dispatch makes no
        host-to-device copy and reads nothing back (its scale table and u16
        constants stay on the device), so the caller enqueues batch i+1
        while batch i's cascade runs. From a batch shape's second dispatch
        on, the dispatch is one CUDA graph (engine.graphs): captured on
        that dispatch, replayed after, and a replayed dispatch makes no
        pyramid, stage, rung or eye spans; likewise the heads' program, one
        graph per stack shape and face bucket (engine.heads). The
        copies and pulls release the interpreter lock, so the stages
        overlap; order is kept because both queues are FIFO. Each batch's
        spans carry its index in the stream as their request
        (utils.profiling).
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
            all_rows = np.concatenate(
                [_arg_rows(p, cfg) for p in purged_per_image if len(p)],
                axis=0)
            img_idx = np.repeat(np.arange(len(counts)), counts)
            ages, stds, races, genders = \
                heads_mod.estimate_age_race_gender_multi(
                    stack, all_rows, img_idx, self.model, tta=cfg.arg_tta,
                    graph_cache=self._head_graphs)

        out: List[List[Detection]] = []
        offset = 0
        with annotate("pfa.assemble", detections=sum(counts)):
            # One .tolist() an array: the same Python floats as float() of
            # each element.
            ages, stds, races, genders = (
                [None] * sum(counts) if a is None else a.tolist()
                for a in (ages, stds, races, genders))
            for purged in purged_per_image:
                dets = []
                for k, r in enumerate(purged.tolist(), offset):
                    el, er = _row_eyes(r, cfg)
                    dets.append(Detection(
                        box=tuple(r[0:4]), angle=r[4], eye_left=el,
                        eye_right=er, confidence=r[9], age=ages[k],
                        age_std=stds[k], race_value=races[k],
                        gender_value=genders[k]))
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
