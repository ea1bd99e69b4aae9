"""Face geometry: eye/mouth priors, box transforms, detection-error metrics.

Port of ``pyfaceanalysis_tpu.geometry``; batched re-derivations of the
reference's per-row helpers:

- ``compute_approximate_eye_coordinates``   (face_analysis.py:24-58)
- ``compute_approximate_eye_boxes_coordinates`` (face_analysis.py:61-135)
- ``compute_face_midpoint``                 (face_analysis.py:138-154)
- ``compute_approximate_mouth_coordinates`` (face_normalization_tools.py:23-47)
- ``relative_error_detection`` / ``face_detected`` (face_analysis.py:158-173)

All functions take tensors with leading batch dimensions, on any device
(array-likes are converted), and return tensors on the same device.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from pyfaceanalysis_torch.config import (
    CANONICAL_DIST_EYES,
    CANONICAL_TRIANGLE_HEIGHT,
    DESIRED_SAMPLING,
    EYE_SAMPLING,
)


def compute_approximate_eye_coordinates(
        boxes, face_sampling: float = DESIRED_SAMPLING) -> torch.Tensor:
    """Crude eye positions from face boxes.

    Args:
        boxes: (..., 4) [x0, y0, x1, y1] face boxes.
        face_sampling: face size relative to the box (reference default 0.825).

    Returns (..., 4) [eyeL_x, eyeL_y, eyeR_x, eyeR_y]: the eyes sit at
    +-37/2 horizontally and -42/2 vertically of a 128-unit face frame
    (face_analysis.py:24-58).
    """
    boxes = torch.as_tensor(boxes)
    x0, y0, x1, y1 = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    fc_x = (x0 + x1) / 2.0
    fc_y = (y0 + y1) / 2.0
    eye_dx = ((CANONICAL_DIST_EYES / 2.0) * torch.abs(x1 - x0) / 128.0
              / face_sampling)
    eye_dy = ((CANONICAL_TRIANGLE_HEIGHT / 2.0) * torch.abs(y1 - y0) / 128.0
              / face_sampling)
    return torch.stack([fc_x - eye_dx, fc_y - eye_dy,
                        fc_x + eye_dx, fc_y - eye_dy], dim=-1)


def compute_approximate_eye_boxes_coordinates(
        boxes: torch.Tensor, angles: Optional[torch.Tensor] = None,
        face_sampling: float = DESIRED_SAMPLING,
        eye_sampling: float = EYE_SAMPLING
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Eye positions plus left/right square eye boxes.

    Args:
        boxes: (..., 4) face boxes [x0, y0, x1, y1].
        angles: (...,) in-plane rotation in degrees (None = 0).

    Returns (eye_coords, left_eye_boxes, right_eye_boxes), each (..., 4).
    The eyes sit at face-local (-+eye_dx, -eye_dy) rotated into the image by
    R(angle) = [[c, -s], [s, c]] (y down), the rotation of the patch
    extractor.
    """
    x0, y0, x1, y1 = boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3]
    if angles is None:
        angles = torch.zeros(boxes.shape[:-1], dtype=boxes.dtype,
                             device=boxes.device)

    fc_x = (x0 + x1) / 2.0
    fc_y = (y0 + y1) / 2.0
    eye_dx = ((CANONICAL_DIST_EYES / 2.0) * (torch.abs(x1 - x0) / 64.0)
              / (2 * face_sampling))
    eye_dy = ((CANONICAL_TRIANGLE_HEIGHT / 2.0) * (torch.abs(y1 - y0) / 64.0)
              / (2 * face_sampling))
    box_w = ((torch.abs(x1 - x0) / (64.0 * 2 * face_sampling))
             * (64.0 * eye_sampling / 2.0))
    box_h = box_w

    rad = angles * math.pi / 180.0
    c, s = torch.cos(rad), torch.sin(rad)
    el_x = fc_x - c * eye_dx + s * eye_dy
    el_y = fc_y - s * eye_dx - c * eye_dy
    er_x = fc_x + c * eye_dx + s * eye_dy
    er_y = fc_y + s * eye_dx - c * eye_dy

    eye_coords = torch.stack([el_x, el_y, er_x, er_y], dim=-1)
    left_boxes = torch.stack([el_x - box_w / 2, el_y - box_h / 2,
                              el_x + box_w / 2, el_y + box_h / 2], dim=-1)
    right_boxes = torch.stack([er_x - box_w / 2, er_y - box_h / 2,
                               er_x + box_w / 2, er_y + box_h / 2], dim=-1)
    return eye_coords, left_boxes, right_boxes


def compute_face_midpoint(eye_left_x, eye_left_y, eye_right_x, eye_right_y,
                          mouth_x, mouth_y):
    """Midpoint of the eye-center and the mouth (face_analysis.py:138-154)."""
    eye_center_x = (eye_left_x + eye_right_x) / 2.0
    eye_center_y = (eye_left_y + eye_right_y) / 2.0
    return (eye_center_x + mouth_x) / 2.0, (eye_center_y + mouth_y) / 2.0


def compute_approximate_mouth_coordinates(eye_coordinates) -> torch.Tensor:
    """Infers the mouth from the eyes assuming the canonical 37x42 triangle
    (face_normalization_tools.py:23-47).

    (..., 4) [eyeL_x, eyeL_y, eyeR_x, eyeR_y] -> (..., 2) [mouth_x, mouth_y].
    """
    ec = torch.as_tensor(eye_coordinates)
    elx, ely, erx, ery = ec[..., 0], ec[..., 1], ec[..., 2], ec[..., 3]
    eye_dx = erx - elx
    eye_dy = ery - ely
    mid_x = (erx + elx) / 2.0
    mid_y = (ery + ely) / 2.0
    r = CANONICAL_TRIANGLE_HEIGHT / CANONICAL_DIST_EYES
    return torch.stack([mid_x - r * eye_dy, mid_y + r * eye_dx], dim=-1)


def relative_error_detection(app_eye_coords, eye_coords) -> torch.Tensor:
    """Max per-eye distance relative to the inter-eye distance of
    ``eye_coords``; both (..., 4) [eyeL_x, eyeL_y, eyeR_x, eyeR_y]
    (batched face_analysis.py:158-165)."""
    a = torch.as_tensor(app_eye_coords)
    b = torch.as_tensor(eye_coords)
    dist_left = torch.sqrt(torch.sum((b[..., 0:2] - a[..., 0:2]) ** 2, dim=-1))
    dist_right = torch.sqrt(torch.sum((b[..., 2:4] - a[..., 2:4]) ** 2, dim=-1))
    dist_eyes = torch.sqrt(torch.sum((b[..., 0:2] - b[..., 2:4]) ** 2, dim=-1))
    return torch.maximum(dist_left, dist_right) / dist_eyes


def face_detected(app_eye_coords, eye_coords, factor: float = 0.25
                  ) -> torch.Tensor:
    """True where the relative eye error is below ``factor``
    (face_analysis.py:168-173)."""
    return relative_error_detection(app_eye_coords, eye_coords) < factor


def pairwise_relative_eye_error(eyes_a, eyes_b) -> torch.Tensor:
    """(N, 4) x (M, 4) -> (N, M) matrix of
    ``relative_error_detection(eyes_a[i], eyes_b[j])``; the distance is
    normalized by ``eyes_b`` (the "true" entry), as the reference's NMS
    normalizes by the kept entry's inter-eye distance
    (face_analysis.py:214)."""
    a = torch.as_tensor(eyes_a)[:, None, :]
    b = torch.as_tensor(eyes_b)[None, :, :]
    return relative_error_detection(a, b)
