"""The FaceDetectUpdated.py-compatible detection CLI (port of
``pyfaceanalysis_tpu.apps.detect``, the ``pfa-detect`` tool).

Supports the reference's switch set (FaceDetectUpdated.py:276-413) and the
same three invocation modes (``pfa-detect`` below stands for
``python -m pyfaceanalysis_torch.apps.detect``):

    pfa-detect [switches] image.jpg out.txt
    pfa-detect --batch=batchfile.txt
    pfa-detect [switches]            (no files: prints usage)

The tool runs on the card unless ``--device=cpu`` is given; without a card
the default raises (there is no quiet move to the CPU).

Boolean switches accept the reference's ``--flag=1/0`` form; flags that only
make sense with a display (plots, pygame, camera) are accepted and honored
when the optional backends exist, otherwise politely ignored with a notice.
Output files are opened in APPEND mode like the reference
(FaceDetectUpdated.py:1260).
"""

from __future__ import annotations

import getopt
import os
import sys
import time
from typing import List, Optional

from pyfaceanalysis_torch.utils.compile_cache import enable_persistent_compilation_cache
from pyfaceanalysis_torch.config import DetectorConfig
from pyfaceanalysis_torch.utils.benchmark import Benchmark

USAGE = """pfa-detect: PyTorch/CUDA face detection + age/race/gender estimation

Usage (either A or B):
  A) pfa-detect [switches] image_filename results_filename
  B) pfa-detect [switches] --batch=batch_filename
     (batch file: alternating image/output filename lines)

Output rows: x0, y0, x1, y1, angle, xl, yl, xr, yr[, age, race, gender, conf]

Switches (reference-compatible, FaceDetectUpdated.py):
  --smallest_face=K           smallest face size / min image side (default 0.2)
  --right_screen_eye_first    swap eye order in output rows
  --batch=FILE                batch mode
  --skip_existing_output=1    skip images whose output file exists
  --write_results=0           do not write output files
  --adaptive_grid_scale=0/1   multi-scale ladder on/off
  --adaptive_grid_coords=0/1
  --last_cut_off_face=K       override the final Disc cutoff
  --cut_offs_face=a,b,...     full 10-entry cutoff ladder
  --write_age_race_gender_confidence=0/1
  --estimate_age_race_gender=0/1
  --image_prescaling=0/1      prescale to <=1000 px (default 1)
  --track_single_face=0/1
  --coordinates_filename=F    ground-truth eval (normalization-file format)
  --true_coordinates_file=F   ground-truth eval (6-float format)
  --display_errors=0/1 --display_plots=0/1 --show_final_detection=0/1
  --save_patches=0/1 --save_normalized_face_detections=0/1
  --network_figures_together=0/1 --camera_enabled=0/1 --pygame_display=0/1
  --pipeline_dir=DIR          artifact directory (default SavedNetworksTPU)

Extensions:
  --device=cuda|cpu           device to run on (default cuda; raises without
                              a card)
  --distributed=1             multi-process batch sweep over torch.distributed
  --coordinator=HOST:PORT --num_processes=N --process_id=K
  --profile_dir=DIR           write a torch.profiler (Chrome) trace
  --data_mesh=N               shard the window batch over N devices
  --batch_mode=fused|async    batch path: one fused program vs per-image
  --stream_depth=K            in-flight batches of the streaming path (3)
  --wire_format=f32|u16       result-block wire encoding (u16 halves the
                              device->host pull; 1/16 px quantization)
  --arg_tta=K                 average the age/race/gender heads over K
                              jittered crops per face (default 1)
  --eye_iters=K               eye-localization refinement passes; the eye
                              nets re-run on the re-centered boxes (the
                              too-far gate always uses pass 1; default 1)
  --arg_eyes=pass1|refined    eye estimate the age/race/gender heads
                              normalize from (refined needs eye_iters>1;
                              detection output unchanged)
  --eye_report=refined|pass1  which eye pass the output rows report when
                              eye_iters>1 (pass1 keeps the output
                              bit-identical to eye_iters=1)
"""

_LONG_OPTS = [
    "batch=", "smallest_face=", "right_screen_eye_first", "display_errors=",
    "display_plots=", "coordinates_filename=", "true_coordinates_file=",
    "skip_existing_output=", "write_results=", "adaptive_grid_scale=",
    "adaptive_grid_coords=", "save_patches=", "network_figures_together=",
    "last_cut_off_face=", "cut_offs_face=",
    "write_age_race_gender_confidence=", "show_final_detection=",
    "camera_enabled=", "track_single_face=", "pygame_display=",
    "estimate_age_race_gender=", "image_prescaling=",
    "save_normalized_face_detections=", "pipeline_dir=", "verbose=",
    "distributed=", "coordinator=", "num_processes=", "process_id=",
    "profile_dir=", "data_mesh=", "batch_mode=", "arg_tta=", "eye_iters=",
    "stream_depth=", "wire_format=",
    "arg_eyes=", "eye_report=",
    "device=",
]


def _b(v: str) -> bool:
    return v.strip() not in ("0", "False", "false", "")


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        opts, args = getopt.getopt(argv, "b:", _LONG_OPTS)
    except getopt.GetoptError as e:
        print("Error parsing options:", e)
        print(USAGE)
        return 2

    cfg_kw = {}
    batch_file = None
    coordinates_filename = None
    true_coordinates_file = None
    write_results = True
    display_flags = {}
    pipeline_dir = os.environ.get("PFA_PIPELINE_DIR", "SavedNetworksTPU")
    save_patches = False
    save_normalized = False
    verbose = True
    distributed = False
    coordinator = None
    num_processes = None
    process_id = None
    profile_dir = None
    device = None

    for o, a in opts:
        if o in ("-b", "--batch"):
            batch_file = a
        elif o == "--smallest_face":
            cfg_kw["smallest_face"] = float(a)
        elif o == "--right_screen_eye_first":
            cfg_kw["right_screen_eye_first"] = True
        elif o == "--skip_existing_output":
            cfg_kw["skip_existing_output"] = _b(a)
        elif o == "--write_results":
            write_results = _b(a)
        elif o == "--adaptive_grid_scale":
            cfg_kw["adaptive_grid_scale"] = _b(a)
        elif o == "--adaptive_grid_coords":
            cfg_kw["adaptive_grid_coords"] = _b(a)
        elif o == "--last_cut_off_face":
            cfg_kw["last_cut_off_face"] = float(a)
        elif o == "--cut_offs_face":
            vals = tuple(float(v) for v in a.split(","))
            if len(vals) != 10:
                print("cut_offs_face needs 10 comma-separated values")
                return 2
            cfg_kw["cut_offs_face"] = vals
        elif o == "--write_age_race_gender_confidence":
            cfg_kw["write_age_race_gender_confidence"] = _b(a)
        elif o == "--estimate_age_race_gender":
            v = _b(a)
            cfg_kw["estimate_age"] = v
            cfg_kw["estimate_race"] = v
            cfg_kw["estimate_gender"] = v
        elif o == "--image_prescaling":
            cfg_kw["image_prescaling"] = _b(a)
        elif o == "--track_single_face":
            cfg_kw["track_single_face"] = _b(a)
        elif o == "--coordinates_filename":
            coordinates_filename = a
        elif o == "--true_coordinates_file":
            true_coordinates_file = a
        elif o == "--save_patches":
            save_patches = _b(a)
        elif o == "--save_normalized_face_detections":
            save_normalized = _b(a)
        elif o == "--pipeline_dir":
            pipeline_dir = a
        elif o == "--verbose":
            verbose = _b(a)
        elif o == "--distributed":
            distributed = _b(a)
        elif o == "--coordinator":
            coordinator = a
        elif o == "--num_processes":
            num_processes = int(a)
        elif o == "--process_id":
            process_id = int(a)
        elif o == "--profile_dir":
            profile_dir = a
        elif o == "--data_mesh":
            cfg_kw["data_mesh"] = int(a)
        elif o == "--batch_mode":
            cfg_kw["batch_mode"] = a
        elif o == "--arg_tta":
            cfg_kw["arg_tta"] = int(a)
        elif o == "--eye_iters":
            cfg_kw["eye_iters"] = int(a)
        elif o == "--stream_depth":
            cfg_kw["stream_depth"] = int(a)
        elif o == "--wire_format":
            cfg_kw["wire_format"] = a
        elif o == "--arg_eyes":
            cfg_kw["arg_eyes"] = a
        elif o == "--eye_report":
            cfg_kw["eye_report"] = a
        elif o == "--device":
            device = a
        elif o in ("--display_errors", "--display_plots",
                   "--show_final_detection", "--network_figures_together",
                   "--camera_enabled", "--pygame_display"):
            display_flags[o.lstrip("-")] = _b(a)

    image_filenames: List[str] = []
    output_filenames: List[str] = []
    if batch_file:
        from pyfaceanalysis_torch.io.writers import read_batch_file
        image_filenames, output_filenames = read_batch_file(batch_file)
    elif len(args) == 2:
        image_filenames = [args[0]]
        output_filenames = [args[1]]
    elif len(args) == 1:
        image_filenames = [args[0]]
        output_filenames = [os.path.splitext(args[0])[0] + ".txt"]
    else:
        print(USAGE)
        return 0

    for k, v in display_flags.items():
        if v and k in ("camera_enabled", "pygame_display"):
            print(f"notice: --{k} requested; use `pfa-camera` for the live "
                  "pygame loop")
        if v and k == "network_figures_together":
            print("notice: --network_figures_together is the only layout: "
                  "--display_plots writes all per-stage panels into one "
                  "cascade_trace figure")

    if distributed:
        # Multi-process batch sweep: images are independent until their own
        # NMS, so processes take disjoint slices (parallel.multihost).
        from pyfaceanalysis_torch.parallel import multihost
        pid, nproc = multihost.initialize(coordinator, num_processes,
                                          process_id)
        image_filenames, output_filenames = multihost.shard_batch_files(
            image_filenames, output_filenames, pid, nproc)
        print(f"[distributed] process {pid}/{nproc}: "
              f"{len(image_filenames)} image(s)")

    cfg = DetectorConfig(**cfg_kw)
    from pyfaceanalysis_torch.utils.profiling import maybe_trace
    with maybe_trace(profile_dir):
        return run_detection(
            image_filenames, output_filenames, cfg,
            pipeline_dir=pipeline_dir, write_results=write_results,
            coordinates_filename=coordinates_filename,
            true_coordinates_file=true_coordinates_file,
            save_patches=save_patches, save_normalized=save_normalized,
            verbose=verbose,
            display_plots=display_flags.get("display_plots", False),
            show_final_detection=display_flags.get("show_final_detection",
                                                   False),
            display_errors=display_flags.get("display_errors", False),
            device=device)


def run_detection(image_filenames, output_filenames, cfg: DetectorConfig,
                  pipeline_dir: str = "SavedNetworksTPU",
                  write_results: bool = True,
                  coordinates_filename: Optional[str] = None,
                  true_coordinates_file: Optional[str] = None,
                  save_patches: bool = False, save_normalized: bool = False,
                  verbose: bool = True, display_plots: bool = False,
                  show_final_detection: bool = False,
                  display_errors: bool = False, device=None) -> int:
    """Runs on ``device`` (default ``cuda``; raises without a card)."""
    from pyfaceanalysis_torch.engine.detector import DetectionModel, FaceDetector
    from pyfaceanalysis_torch.io import images as im_io
    from pyfaceanalysis_torch.io import writers

    benchmark = Benchmark(enabled=verbose)
    if not os.path.isdir(pipeline_dir):
        print(f"error: pipeline directory {pipeline_dir!r} not found. "
              "Run `pfa-train` first (or pass --pipeline_dir).")
        return 1
    # Both kernels built (in parallel) before the first detection needs them.
    enable_persistent_compilation_cache(device)
    model = DetectionModel.load(pipeline_dir, device=device)
    benchmark.add_task_from_previous_time("Loaded networks and classifiers")
    detector = FaceDetector(model, cfg, device=device)

    truth = None
    stage_eval = None
    if coordinates_filename or true_coordinates_file:
        from pyfaceanalysis_torch.engine.evaluation import (
            GroundTruthEvaluator,
            PerStageEvaluator,
        )
        truth = GroundTruthEvaluator.from_files(coordinates_filename,
                                                true_coordinates_file,
                                                display_errors=display_errors)
        # Per-stage diagnostics (reference FaceDetectUpdated.py:780-931):
        # enabled alongside the coordinates file; needs the cascade trace.
        stage_eval = PerStageEvaluator.from_files(
            model, cfg, coordinates_filename, true_coordinates_file)

    total_windows = 0
    total_faces = 0
    t_start = time.time()

    # Batched fast path: many images, no per-image debug/eval side outputs.
    use_batch = (len(image_filenames) > 1 and truth is None
                 and not (save_patches or save_normalized or display_plots
                          or show_final_detection or cfg.track_single_face
                          or cfg.skip_existing_output))
    if use_batch:
        loaded = []
        for img_fn in image_filenames:
            image, _ = im_io.load_image(
                img_fn, cfg.prescale_size if cfg.image_prescaling else None)
            loaded.append(image)
        benchmark.add_task_from_previous_time("Images loaded (batch)")
        # Group by shape; each group runs as fused cascades of 16 images.
        results = [None] * len(loaded)
        by_shape = {}
        for i, im in enumerate(loaded):
            by_shape.setdefault(im.shape, []).append(i)
        for idxs in by_shape.values():
            # detect_stream pipelines push/compute/pull across chunks
            # (config.stream_depth in flight) -- the serving path.
            chunks = [idxs[k:k + 16] for k in range(0, len(idxs), 16)]
            stream = detector.detect_stream(
                ([loaded[i] for i in chunk] for chunk in chunks))
            for chunk, dets in zip(chunks, stream):
                for i, d in zip(chunk, dets):
                    results[i] = d
        benchmark.add_task_from_previous_time("Batched detection")
        for i, (img_fn, out_fn) in enumerate(zip(image_filenames,
                                                 output_filenames)):
            detections = results[i]
            total_windows += detector.windows_scanned
            total_faces += len(detections)
            if verbose:
                print(f"{img_fn}: {len(detections)} face(s)")
            if write_results:
                writers.write_detections(
                    out_fn, detections,
                    right_screen_eye_first=cfg.right_screen_eye_first,
                    write_age_race_gender_confidence=(
                        cfg.write_age_race_gender_confidence
                        and cfg.estimate_age))
        dt = time.time() - t_start
        if verbose:
            print(f"\nbatch: {len(loaded)} image(s), {total_faces} face(s), "
                  f"{total_windows} windows in {dt:.2f}s "
                  f"({total_windows / max(dt, 1e-9):.0f} windows/s)")
            benchmark.display()
        return 0

    for i, (img_fn, out_fn) in enumerate(zip(image_filenames,
                                             output_filenames)):
        if cfg.skip_existing_output and os.path.exists(out_fn):
            if verbose:
                print(f"skipping {img_fn} (output exists)")
            continue
        benchmark.update_start_time()
        image, factor = im_io.load_image(
            img_fn, cfg.prescale_size if cfg.image_prescaling else None)
        benchmark.add_task_from_previous_time("Image loaded or captured")
        detections = detector.detect(
            image, collect_trace=display_plots or stage_eval is not None)
        benchmark.add_task_from_previous_time("Full detection pass")
        if display_plots and detector.last_trace is not None:
            from pyfaceanalysis_torch import viz
            names = [s.raw_type for s in model.spec.detection_stages]
            out = viz.plot_cascade_trace(
                image, detector.last_trace, names,
                f"cascade_trace_{i:03d}.png")
            if out and verbose:
                print(f"wrote cascade trace plot: {out}")
        if show_final_detection:
            from pyfaceanalysis_torch import viz
            try:
                # RGB copy purely for the overlay figure, like the
                # reference (FaceDetectUpdated.py:533-535); detection ran
                # on the "L" image above.
                rgb, _ = im_io.load_image(
                    img_fn,
                    cfg.prescale_size if cfg.image_prescaling else None,
                    mode="RGB")
            except Exception:
                rgb = None
            out = viz.plot_final_detections(
                image, detections, f"final_detection_{i:03d}.png", rgb=rgb)
            if out and verbose:
                print(f"wrote final detection plot: {out}")
        total_windows += detector.windows_scanned
        total_faces += len(detections)
        if verbose:
            print(f"{img_fn}: {len(detections)} face(s) "
                  f"[{detector.windows_scanned} windows scanned]")
            for d in detections:
                extra = ""
                if d.age is not None:
                    extra = (f" age={d.age:.1f}+-{d.age_std:.1f}"
                             f" race={d.race} gender={d.gender}")
                print(f"  box={tuple(round(v, 1) for v in d.box)} "
                      f"angle={d.angle:.1f} conf={d.confidence:.3f}{extra}")
        if truth is not None:
            truth.record(img_fn, detections, prescale_factor=factor)
        if stage_eval is not None and detector.last_trace is not None:
            stage_eval.record_image(img_fn, image.shape,
                                    detector.last_trace,
                                    prescale_factor=factor)
        if save_normalized or save_patches:
            _save_side_outputs(image, detections, save_patches,
                               save_normalized, i, detector.device)
        if write_results:
            writers.write_detections(
                out_fn, detections,
                right_screen_eye_first=cfg.right_screen_eye_first,
                write_age_race_gender_confidence=(
                    cfg.write_age_race_gender_confidence
                    and cfg.estimate_age))
        benchmark.add_task_from_previous_time("Results written")

    dt = time.time() - t_start
    if verbose:
        n_img = max(len(image_filenames), 1)
        print(f"\nprocessed {n_img} image(s), {total_faces} face(s), "
              f"{total_windows} windows in {dt:.2f}s "
              f"({total_windows / max(dt, 1e-9):.0f} windows/s)")
        benchmark.display()
    if stage_eval is not None:
        stage_eval.report()
    if truth is not None:
        truth.report()
    return 0


def _save_side_outputs(image, detections, save_patches, save_normalized,
                       index, device) -> None:
    """saved_patches/*.jpg raw patches (FaceDetectUpdated.py:934-944) and
    POSE-NORMALIZED face crops (face_analysis.py:983-1013: method
    eyes_inferred-mouth_area, centering mid_eyes_inferred-mouth, out
    256x192) under normalized_face_detections/. The reference normalizes
    with box-approximated eyes and a random output index; here the REFINED
    detected eyes and a deterministic image/face index are used. Both are
    sampled on ``device``."""
    import numpy as np
    import torch

    from pyfaceanalysis_torch.io import images as im_io
    from pyfaceanalysis_torch.ops.patches import extract_patches_rotate

    if len(detections) == 0:
        return
    dev_image = torch.as_tensor(np.asarray(image, np.float32), device=device)
    if save_patches:
        os.makedirs("saved_patches", exist_ok=True)
        boxes = np.asarray([d.box for d in detections], np.float32)
        angles = np.asarray([d.angle for d in detections], np.float32)
        patches = extract_patches_rotate(
            dev_image, torch.as_tensor(boxes, device=device),
            torch.as_tensor(angles, device=device), (64, 64)).cpu().numpy()
        for j, p in enumerate(patches):
            im_io.save_image(
                f"saved_patches/patch_im{index:03d}_{j:02d}.jpg", p)
    if save_normalized:
        from pyfaceanalysis_torch.normalization import normalize_image
        os.makedirs("normalized_face_detections", exist_ok=True)
        for j, d in enumerate(detections):
            coords = np.array([*d.eye_left, *d.eye_right, 0.0, 0.0],
                              np.float32)
            out = normalize_image(
                dev_image, coords,
                normalization_method="eyes_inferred-mouth_area",
                centering_mode="mid_eyes_inferred-mouth",
                rotation_mode="EyeLineRotation",
                out_size=(256, 192))
            im_io.save_image(
                f"normalized_face_detections/EyeN_im{index:03d}_{j:02d}.jpg",
                out)


if __name__ == "__main__":
    sys.exit(main())
