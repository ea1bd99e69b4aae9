"""Face geometry: rotation-aware approximate eye boxes.

Port of ``pyfaceanalysis_tpu.geometry.compute_approximate_eye_boxes_coordinates``
(reference face_analysis.py:61-135); the remaining helpers of that module
serve the attribute heads and the evaluator and are not ported yet.
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
