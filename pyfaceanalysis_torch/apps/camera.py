"""pfa-camera: live webcam detection loop (the reference's pygame UI); run
as ``python -m pyfaceanalysis_torch.apps.camera``. Port of
``pyfaceanalysis_tpu.apps.camera``.

Reference: the camera/display blocks of FaceDetectUpdated.py:440-479,
537-549, 1189-1256 -- pygame camera capture, per-frame detection with
``track_single_face`` narrowing the grid around the last hit
(face_analysis.py:576-585,611-625), FPS printout, and a box/eye overlay.

pygame is an optional dependency; without it (or without a camera device)
the command exits with a clear message. The overlay drawing is plain pygame
rects/circles; detection runs the standard FaceDetector with tracking on,
on the card unless ``--compute_device=cpu`` is given (``--device`` names
the camera, as in the JAX tool).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

from pyfaceanalysis_torch.utils.compile_cache import enable_persistent_compilation_cache

import numpy as np


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="pfa-camera",
                                description="Live face detection from a "
                                            "webcam (pygame).")
    p.add_argument("--device", default="/dev/video0")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--pipeline_dir", default="SavedNetworksTPU")
    p.add_argument("--smallest_face", type=float, default=0.2)
    p.add_argument("--max_frames", type=int, default=0,
                   help="stop after N frames (0 = run until quit)")
    p.add_argument("--compute_device", choices=("cuda", "cpu"), default=None,
                   help="device the detector runs on (default cuda; raises "
                   "without a card)")
    args = p.parse_args(argv)

    try:
        import pygame
        import pygame.camera
    except ImportError:
        print("error: pygame is not installed; the live camera UI needs it "
              "(batch/CLI detection work without)")
        return 1

    from pyfaceanalysis_torch.config import DetectorConfig
    from pyfaceanalysis_torch.engine.detector import DetectionModel, FaceDetector

    pygame.init()
    pygame.camera.init()
    cams = pygame.camera.list_cameras()
    if not cams:
        print("error: no camera found")
        return 1
    device = args.device if args.device in cams else cams[0]
    cam = pygame.camera.Camera(device, (args.width, args.height))
    cam.start()

    enable_persistent_compilation_cache(args.compute_device)
    model = DetectionModel.load(args.pipeline_dir,
                                device=args.compute_device)
    cfg = DetectorConfig(smallest_face=args.smallest_face,
                         track_single_face=True, estimate_age=False,
                         estimate_race=False, estimate_gender=False)
    detector = FaceDetector(model, cfg, device=args.compute_device)

    screen = pygame.display.set_mode((args.width, args.height))
    pygame.display.set_caption("pyfaceanalysis_torch / camera view")

    frames = 0
    t0 = time.time()
    try:
        while True:
            surf = cam.get_image()
            screen.blit(surf, (0, 0))
            rgb = pygame.surfarray.array3d(surf).swapaxes(0, 1)
            gray = (rgb @ np.array([0.299, 0.587, 0.114])) / 255.0
            detections = detector.detect(gray.astype(np.float32),
                                         estimate_attributes=False)
            for d in detections:
                x0, y0, x1, y1 = [int(v) for v in d.box]
                pygame.draw.rect(screen, (255, 255, 255),
                                 (x0, y0, x1 - x0, y1 - y0), 2)
                pygame.draw.circle(screen, (0, 0, 255),
                                   [int(v) for v in d.eye_left], 3)
                pygame.draw.circle(screen, (255, 255, 0),
                                   [int(v) for v in d.eye_right], 3)
            pygame.display.flip()
            frames += 1
            if frames % 10 == 0:
                fps = frames / (time.time() - t0)
                print(f"FPS: {fps:.2f}  faces: {len(detections)}")
            if args.max_frames and frames >= args.max_frames:
                break
            for e in pygame.event.get():
                if e.type == pygame.QUIT:
                    return 0
    finally:
        cam.stop()
        pygame.quit()
    return 0


if __name__ == "__main__":
    sys.exit(main())
