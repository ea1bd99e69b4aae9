"""Configuration dataclasses for the detection pipeline.

Mirrors the module-global tunables of the reference
(``FaceDetectUpdated.py:79-127``) as a frozen dataclass, plus the per-family
patch geometry headers parsed from pipeline files
(``Pipelines/Pipeline_experimental.txt:2-4``).

A field-for-field copy of ``pyfaceanalysis_tpu.config`` (the JAX package is
the reference; this package imports nothing from it), plus
:func:`resolve_device`. Fields that only steer the JAX package's batch,
stream, wire and mesh paths are kept so that one config value means the
same thing in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when CUDA is asked for and absent -- there is no silent
    CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class NetGeometry:
    """Patch geometry header for one network family.

    Reference: pipeline header lines parsed at ``face_analysis.py:383-432``.
    ``Dx/Dy`` are the positional label ranges (in regression pixels), ``Dang``
    the angular range (degrees), ``mins/maxs`` the sampling (scale) envelope,
    ``subimage_*`` the physical patch size fed to the network and
    ``regression_*`` the logical size in which labels are expressed.
    """

    Dx: float = 40.0
    Dy: float = 20.0
    Dang: float = 22.5
    mins: float = 0.694
    maxs: float = 0.981
    subimage_width: int = 64
    subimage_height: int = 64
    regression_width: int = 128
    regression_height: int = 128


# The canonical face-detection sampling: the face occupies 0.825 of the
# regression box (reference: `desired_sampling=0.825`, FaceDetectUpdated.py:729).
DESIRED_SAMPLING = 0.825
# Normalized eye scale relative to its eye box (face_analysis.py:61).
EYE_SAMPLING = 2.3719
# The reference's discrimination cutoff ladder, indexed by network serial
# digit (FaceDetectUpdated.py:98). Tuned to the REFERENCE classifiers'
# output scale; freshly trained models ship a calibrated ladder in their
# manifest instead (tools/calibrate_ladder.py).
REFERENCE_CUT_OFFS_FACE = (
    0.99, 0.95, 0.85, 0.8, 0.7, 0.6, 0.5, 0.45, 0.10, 0.05)
# Canonical face triangle: inter-eye distance x eyes-to-mouth height
# (face_normalization_tools.py:29-30).
CANONICAL_DIST_EYES = 37.0
CANONICAL_TRIANGLE_HEIGHT = 42.0


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Top-level detection configuration.

    Field-for-field port of the reference's module globals
    (``FaceDetectUpdated.py:79-127``); see each comment for the source line.
    """

    # Grid construction
    smallest_face: float = 0.20              # :84
    adaptive_grid_coords: bool = True        # :82
    adaptive_grid_scale: bool = True         # :83
    patch_overlap_sampling: float = 1.1      # :110
    patch_overlap_posx_posy: float = 1.1     # :111

    # Cascade rejection tolerances (:113-115)
    tolerance_scale_deviation: float = 1.1
    tolerance_angle_deviation: float = 1.1
    tolerance_posxy_deviation: float = 1.1

    # Discrimination cutoff ladder, indexed by network "serial" digit (:98).
    # None = model decides: the trainer/calibrator may record a ladder
    # calibrated to ITS discriminators' output scale in the artifact
    # manifest (engine.detector resolves it); otherwise the reference's
    # constants (REFERENCE_CUT_OFFS_FACE) apply.
    cut_offs_face: Optional[Tuple[float, ...]] = None
    last_cut_off_face: float = -1.0          # :99 (>=0 overrides slot 9)

    # Interpolation per serial digit (:125). "nearest" | "bilinear"
    interpolation_formats: Tuple[str, ...] = ("nearest",) * 10

    # Analysis heads (:117-119)
    estimate_age: bool = True
    estimate_gender: bool = True
    estimate_race: bool = True

    # Image prescaling (:121-123)
    image_prescaling: bool = True
    prescale_size: int = 1000

    # Output formatting (:90, :100)
    right_screen_eye_first: bool = False
    write_age_race_gender_confidence: bool = True

    # Tracking & misc (:104, :94)
    track_single_face: bool = False
    skip_existing_output: bool = False

    # Eye localization rejection threshold (face_analysis.py:1018
    # tolerance_xy_eye). -1 = model decides: the manifest's calibrated
    # value (tools/calibrate_ladder.py eye-gate pass) or the reference
    # constant 9.0.
    tolerance_xy_eye: float = -1.0

    def resolved_tolerance_xy_eye(self) -> float:
        return self.tolerance_xy_eye if self.tolerance_xy_eye >= 0 else 9.0

    # Cap on faces entering the eye sub-cascade in the fused device path
    # (ranked by Disc confidence, so only the weakest survivors past the
    # cap are dropped). Final-gate survivors are typically a few dozen;
    # without the cap the eye networks ran at 2 * max_detections patches of
    # ~90% padding.
    eye_max_faces: int = 64

    # Eye-localization refinement passes (TPU extension, not in the
    # reference, which runs the eye nets once: face_analysis.py:1036-1109).
    # K>1 re-centers each eye search box on the pass-1 estimate and runs
    # the nets again (2*eye_cap extra 64x64 patches per pass -- negligible
    # next to the cascade). The "too far" rejection gate always uses the
    # PASS-1 regression magnitude, so detection validity is identical to
    # the reference semantics at any K; only the reported eye positions
    # refine. 1 = reference parity.
    eye_iters: int = 1

    # In-flight batches of detect_stream (an extension of the JAX package;
    # the reference is single-threaded per image). Depth 1 = back-to-back
    # detect_batch; more keeps the device busy across the host's pull, NMS,
    # heads and conversion of the neighbouring batches. Each in-flight
    # batch holds its canvas stack on the device (4 MB per image at the
    # 1000 px canvas).
    stream_depth: int = 3

    # detect_stream in three stages: a producer thread runs the uint8
    # conversion and the host-to-device copy of upcoming batches, the
    # caller's thread dispatches the cascades, and a finisher thread pulls
    # results and runs NMS and the heads. False = one thread and a plain
    # queue. Outputs are identical by construction (same arrays, same
    # order).
    stream_push_prefetch: bool = True

    # Result-block encoding for the fused batch path. "f32" = exact.
    # "u16" = fixed-point pack on the device (coords/angle at 1/16 px --
    # 1/8 on grown canvases past 3071 px, see
    # engine.detector._wire_coord_scale -- confidence at 1/16384), which
    # halves the device-to-host result copy. The default is the JAX
    # package's, so that default-config results are the same in both; it
    # is not bit-identical to "f32" and to the single-image path, which
    # never packs.
    wire_format: str = "u16"

    # Largest image count per fused cascade; bigger detect_batch calls are
    # chunked. The value is the JAX package's, where the TPU crop kernel's
    # scalar memory set it; that reason is gone here (the CUDA crop kernel
    # reads its table from global memory), and the cap now only bounds the
    # peak device memory of one fused cascade.
    max_fused_batch: int = 32

    # Crops averaged per face by the age/race/gender heads (an extension
    # of the JAX package, not in the reference: engine/heads.py
    # _tta_offsets). 1 = the reference's single Z-frame crop; K>1 runs K
    # jittered crops through the same batched products and
    # posterior-averages, trading K times the (small) head work for
    # robustness to eye-localization jitter.
    arg_tta: int = 1

    # Which eye pass the REPORTED eye coordinates come from when
    # eye_iters > 1 (TPU extension). "refined" = the last refinement pass
    # (the point of opting into eye_iters). "pass1" = report the pass-1
    # positions anyway -- combined with arg_eyes="refined" this lets the
    # attribute heads consume the better eyes while every user-visible
    # detection output stays bit-identical to eye_iters=1 (the refined
    # REPORTING default was rejected by a held-out panel: one borderline
    # face's refined eyes crossed the 0.25 acceptance line,
    # docs/ROUND3_NOTES.md).
    eye_report: str = "refined"

    # Which eye estimate the age/race/gender heads consume (TPU extension).
    # "pass1" = reference parity (the single eye pass the gate/NMS also
    # use). "refined" = the eye_iters>1 refined centers, when the block
    # carries them (cols 11-14); detection output is unchanged either way
    # -- only the Z-frame the attribute heads normalize from moves. Pair
    # with an age stack trained at the matching (lower) eye-jitter
    # distribution: the shipped r2 stack was trained at pass-1 noise and
    # measurably degrades on refined eyes (docs/ROUND3_NOTES.md).
    arg_eyes: str = "pass1"

    # Save the 96x96 age-head input patches (the reference writes
    # ImageForAgeEstimation%03d.jpg unconditionally, face_analysis.py:1251;
    # here opt-in).
    save_age_estimation_images: bool = False

    # Per-patch contrast normalization before detection networks
    # (load_network_subimages contrast_normalize, FaceDetectUpdated.py:686).
    # None = let the loaded model decide (the trainer records whether its
    # networks were fit on normalized patches in the calibration manifest;
    # train/inference must match). True/False forces it.
    detection_contrast_normalize: Optional[bool] = None

    # NMS threshold on relative eye error (face_analysis.py:217)
    purge_threshold: float = 0.25

    # Gain on the PAng coordinate update (1.0 = the reference's full step,
    # face_analysis.py:825-827). -1 = model decides (the trainer records a
    # calibrated value in the artifact manifest; engine.detector resolves
    # it like detection_contrast_normalize).
    pang_gain: float = -1.0

    def resolved_pang_gain(self) -> float:
        return self.pang_gain if self.pang_gain >= 0 else 1.0

    # Gains on the PosX/PosY shift and the Scale step (log-space), same
    # convention as pang_gain: 1.0 = the reference's full step, < 1 damps.
    # On real photographs the regressors overshoot (measured ~1.6x on the
    # canonical photo's trajectories); a closed-loop gain < 1 converts
    # overshoot into geometric convergence across the 3 refinement
    # iterations and bounds the damage of a saturated-wrong step.
    # -1 = model decides (manifest-calibrated, like pang_gain).
    pos_gain: float = -1.0
    scale_gain: float = -1.0

    def resolved_pos_gain(self) -> float:
        return self.pos_gain if self.pos_gain >= 0 else 1.0

    def resolved_scale_gain(self) -> float:
        return self.scale_gain if self.scale_gain >= 0 else 1.0

    # Window batches are padded to the next bucket size (kept from the JAX
    # package, which compiles one program per batch shape): the padding
    # rows are dead, but the bucket decides the row count of every product
    # and so must match for equal results.
    bucket_sizes: Tuple[int, ...] = (256, 512, 1024, 2048, 4096, 8192, 16384)
    # Device-side survivor compaction width: cascade+eye results are gathered
    # into this many rows on the device so only a small block is copied to
    # the host.
    max_detections: int = 256
    # Operand dtype for the cascade networks' products: "bf16" (default, as
    # in the JAX package: operands rounded to bfloat16, accumulation in
    # float32) or "f32". The port rounds the operands explicitly and
    # multiplies in float32, so "bf16" reproduces the JAX package's
    # numbers, not a faster product.
    matmul_dtype: str = "bf16"
    # Multi-device data-parallel inference over a mesh of this many devices
    # (0/1 = off). Not ported: FaceDetector raises for values above 1.
    data_mesh: int = 0
    # Batched detection (detect_batch): "fused" runs ONE cascade over the
    # windows of every image in the batch (B times taller per-stage
    # products, the launches per image divided by B); "async" enqueues one
    # cascade per image back-to-back (lower peak memory).
    batch_mode: str = "fused"
    # Mid-cascade compaction: after the first Disc stage (which kills ~90%
    # of windows) the batch is compacted on device to this many rows, so the
    # remaining extraction rounds and network executions run on a fraction
    # of the grid. Survivors are ranked by Disc confidence if they exceed
    # the budget. 0 disables.
    mid_compact: int = 512
    # Second compaction rung after Disc5 (start of refinement iteration 3):
    # by then ~100-150 windows survive on a busy group photo, so the last
    # extraction rounds (PAng2/Disc7, the dominant device cost) run on a
    # quarter batch. 0 disables.
    mid_compact2: int = 256
    # Patch extraction route (the name is kept from the JAX package).
    # "off" = canvas gather for refinement and eyes (ops.patches);
    # "on" = level-space sampling through the CUDA kernels (ops.cuda_crop,
    # ops.cuda_gather; on CPU tensors their plain versions); "auto" = the
    # kernels on CUDA, the canvas gather on CPU (as the JAX CPU path);
    # "ref" = the level-space path with the plain versions on any device
    # (the counterpart of the JAX package's "interpret").
    pallas_refine: str = "auto"

    def resolved_cut_offs(self) -> Tuple[float, ...]:
        """Applies ``last_cut_off_face`` to slot 9 (FaceDetectUpdated.py:434-438)."""
        cs = list(self.cut_offs_face if self.cut_offs_face is not None
                  else REFERENCE_CUT_OFFS_FACE)
        if self.last_cut_off_face >= 0:
            cs[9] = self.last_cut_off_face
        return tuple(cs)


def bucket_size(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (falls back to the largest bucket)."""
    for b in buckets:
        if n <= b:
            return b
    return max(max(buckets), int(n))
