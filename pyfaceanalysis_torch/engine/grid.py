"""Multi-scale sliding-window grid construction (host side).

Ports of the reference's grid generators -- these run once per image on the
host (tiny arrays), producing the padded patch batches the
cascade consumes:

- ``compute_sampling_values``   (face_analysis.py:575-607)
- ``compute_posX_posY_values``  (face_analysis.py:610-657)
- ``compute_subimage_coordinates_from_posX_posY_values``
                                (face_analysis.py:661-669)
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from pyfaceanalysis_torch.config import DESIRED_SAMPLING, NetGeometry


def compute_sampling_values(im_width: int, im_height: int, geom: NetGeometry,
                            smallest_face: float,
                            patch_overlap_sampling: float = 1.1,
                            adaptive_grid_scale: bool = True,
                            track_single_face: bool = False,
                            face_has_been_found: bool = False,
                            tracked_face: Optional[Sequence[float]] = None
                            ) -> List[float]:
    """Geometric ladder of patch sampling factors (scales).

    Reference: face_analysis.py:575-607. ``sampling_value`` is the patch size
    in image pixels divided by ``subimage_width``; the ladder climbs by
    ``(net_maxs / net_mins) / patch_overlap_sampling`` until the patch no
    longer fits the image. Tracking mode returns a single scale around the
    last detected face.
    """
    sw, sh = geom.subimage_width, geom.subimage_height
    if face_has_been_found and track_single_face and tracked_face is not None:
        b_x0, b_y0, b_x1, b_y1 = tracked_face[:4]
        face_size = 0.5 * abs(b_x1 - b_x0) + 0.5 * abs(b_y1 - b_y0)
        return [face_size * 1.0 / sw]

    min_side = min(im_height, im_width)
    min_box_side = max(20.0, min_side * smallest_face * DESIRED_SAMPLING / geom.mins)
    min_sampling_value = min_box_side * 1.0 / sw
    if not adaptive_grid_scale:
        return [min_sampling_value]

    sampling_values = []
    sampling_value = min_sampling_value
    step = (geom.maxs / geom.mins) / patch_overlap_sampling
    while (sw * sampling_value * geom.mins / DESIRED_SAMPLING < im_width and
           sh * sampling_value * geom.mins / DESIRED_SAMPLING < im_height):
        sampling_values.append(sampling_value)
        sampling_value *= step
    return sampling_values


def compute_posX_posY_values(im_width: int, im_height: int, geom: NetGeometry,
                             sampling_value: float,
                             patch_overlap_posx_posy: float = 1.1,
                             track_single_face: bool = False,
                             face_has_been_found: bool = False,
                             tracked_face: Optional[Sequence[float]] = None
                             ) -> Tuple[np.ndarray, np.ndarray, float, float,
                                        float, float]:
    """Patch-origin grids for one scale.

    Returns (posX_values, posY_values, patch_width, patch_height,
    max_Dx_diff, max_Dy_diff). Reference: face_analysis.py:610-657 --
    ``linspace`` of origins with spacing ``net_D{x,y} * 2 * patch / regression
    / overlap`` and the acceptance radii ``max_D{x,y}_diff``.
    """
    patch_width = geom.subimage_width * sampling_value
    patch_height = geom.subimage_height * sampling_value

    if face_has_been_found and track_single_face and tracked_face is not None:
        patch_sepx = geom.Dx * 2.0 * patch_width / geom.regression_width
        patch_sepy = geom.Dy * 2.0 * patch_height / geom.regression_height
        posX = np.array([tracked_face[0], tracked_face[0] + patch_sepx,
                         tracked_face[0] - patch_sepx])
        posY = np.array([tracked_face[1]] * 3)
    else:
        sep_x = geom.Dx * 2.0 * patch_width / geom.regression_width
        sep_y = geom.Dy * 2.0 * patch_height / geom.regression_height
        num_x = math.ceil((1 + (im_width - patch_width) / sep_x)
                          * patch_overlap_posx_posy)
        num_y = math.ceil((1 + (im_height - patch_height) / sep_y)
                          * patch_overlap_posx_posy)
        posX = np.linspace(0.0, im_width - patch_width, int(num_x))
        posY = np.linspace(0.0, im_height - patch_height, int(num_y))

    max_Dx_diff = geom.Dx * patch_width / geom.regression_width
    max_Dy_diff = geom.Dy * patch_height / geom.regression_height
    return posX, posY, patch_width, patch_height, max_Dx_diff, max_Dy_diff


def compute_subimage_coordinates(posX_values: np.ndarray,
                                 posY_values: np.ndarray,
                                 patch_width: float, patch_height: float
                                 ) -> np.ndarray:
    """(Ny*Nx, 4) boxes [x0, y0, x1, y1] (inclusive), Y-major ordering.

    Vectorized port of face_analysis.py:661-669.
    """
    xx, yy = np.meshgrid(posX_values, posY_values)  # (Ny, Nx)
    x0 = xx.reshape(-1)
    y0 = yy.reshape(-1)
    return np.stack([x0, y0, x0 + patch_width - 1.0, y0 + patch_height - 1.0],
                    axis=1)
