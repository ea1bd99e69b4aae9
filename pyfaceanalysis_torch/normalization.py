"""Geometric face normalization (the ``face_normalization_tools`` equivalent).

Port of ``pyfaceanalysis_tpu.normalization``. The reference's
``normalize_image`` (face_normalization_tools.py:111-329), with its PIL
crop/rotate/crop mechanics unwound, is one rotated, scaled sampling of the
source image:

    out pixel (X, Y) samples source at
        c + u * (cos phi, sin phi) + v * (-sin phi, cos phi)
    u = (X - (outW - 1)/2) * sf,   v = (Y - (outH - 1)/2) * sf

with c the centering point, phi the eye-line angle (counter-clockwise in
image coordinates, y down) when rotation_mode="EyeLineRotation" else 0, and
``sf`` source pixels per output pixel from the normalization method:

    scale_factor = sqrt(triangle_area / desired_area),
    desired_area = 37 * 42 / 2 * (37.5 / 37)^2          (:172)
    sf = scale_factor        ("eyes_mouth_area", "eyes_inferred-mouth_area")
    sf = scale_factor / 2    ("eyes_inferred-mouth_areaZ")

``frame_params`` is host float64 numpy, operation for operation as in the
JAX package; ``sample_frame`` is one bilinear gather on the image's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from pyfaceanalysis_torch.config import (
    CANONICAL_DIST_EYES,
    CANONICAL_TRIANGLE_HEIGHT,
    resolve_device,
)

# face_normalization_tools.py:172
DESIRED_AREA = (CANONICAL_DIST_EYES * CANONICAL_TRIANGLE_HEIGHT / 2.0
                * (37.5 / CANONICAL_DIST_EYES) ** 2)


@dataclasses.dataclass(frozen=True)
class FrameParams:
    """A normalized-frame sampling: center, angle (deg CCW), source px per
    output px, and whether the output is horizontally mirrored."""

    center_x: float
    center_y: float
    angle_deg: float
    sf: float
    mirror: bool = False


def frame_params(coords, normalization_method: str = "eyes_mouth_area",
                 centering_mode: str = "mid_eyes_mouth",
                 rotation_mode: str = "noRotation",
                 rng: Optional[np.random.RandomState] = None,
                 out_size: Tuple[int, int] = (256, 192)) -> FrameParams:
    """Computes the sampling frame from face coordinates.

    coords: (eyeL_x, eyeL_y, eyeR_x, eyeR_y, mouth_x, mouth_y); the mouth is
    ignored by the *inferred-mouth* methods. out_size is (width, height) --
    PIL convention, as in the reference.
    """
    elx, ely, erx, ery, mx, my = [float(v) for v in coords]
    eyes_mx = (elx + erx) / 2.0
    eyes_my = (ely + ery) / 2.0
    dist_eyes = np.hypot(erx - elx, ery - ely)
    eye_line_angle = np.degrees(np.arctan2(ery - ely, erx - elx))

    # Inferred mouth from the canonical triangle
    # (face_normalization_tools.py:23-47).
    r = CANONICAL_TRIANGLE_HEIGHT / CANONICAL_DIST_EYES
    imx = eyes_mx - r * (ery - ely)
    imy = eyes_my + r * (erx - elx)

    height = np.hypot(eyes_mx - mx, eyes_my - my)
    height_inf = np.hypot(eyes_mx - imx, eyes_my - imy)
    area = dist_eyes * height / 2.0
    area_inf = dist_eyes * height_inf / 2.0

    if normalization_method == "eyes_mouth_area":
        sf = np.sqrt(area / DESIRED_AREA)
    elif normalization_method == "eyes_inferred-mouth_area":
        sf = np.sqrt(area_inf / DESIRED_AREA)
    elif normalization_method == "eyes_inferred-mouth_areaZ":
        sf = np.sqrt(area_inf / DESIRED_AREA) / 2.0
    elif normalization_method == "eyes_inferred-mouth_areaZ-Test":
        desired_test = 8.0 * (8.0 * 42.0 / 37) / 2.0
        sf = np.sqrt(area_inf / desired_test)
    else:
        raise ValueError(f"unknown normalization {normalization_method!r}")

    mirror = False
    if centering_mode == "mid_eyes_mouth":
        cx, cy = (eyes_mx + mx) / 2.0, (eyes_my + my) / 2.0
    elif centering_mode == "mid_eyes_inferred-mouth":
        cx, cy = (eyes_mx + imx) / 2.0, (eyes_my + imy) / 2.0
    elif centering_mode == "eyeL":
        cx, cy = elx, ely
    elif centering_mode == "eyeR":
        cx, cy = erx, ery
        mirror = True
    elif centering_mode == "noFace":
        rng = rng or np.random.RandomState()
        ang = rng.uniform(0, 2 * np.pi)
        mid_x, mid_y = (eyes_mx + mx) / 2.0, (eyes_my + my) / 2.0
        cx = mid_x + 0.75 * out_size[0] * sf * np.cos(ang)
        cy = mid_y + 0.75 * out_size[1] * sf * np.sin(ang)
        sf = sf / 2.0   # zoom in, away from the face (:228-230)
    else:
        raise ValueError(f"unknown centering {centering_mode!r}")

    angle = eye_line_angle if rotation_mode != "noRotation" else 0.0
    return FrameParams(cx, cy, angle, float(sf), mirror)


def inferred_mouth_z_frames(eyes: np.ndarray
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                       np.ndarray]:
    """``frame_params`` of many faces at once, for the one combination the
    attribute heads use: "eyes_inferred-mouth_areaZ",
    "mid_eyes_inferred-mouth", "EyeLineRotation".

    eyes: (N, 4) [elx, ely, erx, ery]. Returns float64 (N,) arrays (cx, cy,
    angle_deg, sf), each element bit-equal to the per-face call: the same
    float64 operations in the same order."""
    eyes = np.asarray(eyes, np.float64)
    elx, ely, erx, ery = eyes[:, 0], eyes[:, 1], eyes[:, 2], eyes[:, 3]
    eyes_mx = (elx + erx) / 2.0
    eyes_my = (ely + ery) / 2.0
    dist_eyes = np.hypot(erx - elx, ery - ely)
    angle = np.degrees(np.arctan2(ery - ely, erx - elx))
    r = CANONICAL_TRIANGLE_HEIGHT / CANONICAL_DIST_EYES
    imx = eyes_mx - r * (ery - ely)
    imy = eyes_my + r * (erx - elx)
    height_inf = np.hypot(eyes_mx - imx, eyes_my - imy)
    area_inf = dist_eyes * height_inf / 2.0
    sf = np.sqrt(area_inf / DESIRED_AREA) / 2.0
    return (eyes_mx + imx) / 2.0, (eyes_my + imy) / 2.0, angle, sf


def sample_frame(image: torch.Tensor, fp: FrameParams,
                 out_size: Tuple[int, int], background: str = "zero",
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """Samples the normalized frame from a grayscale (H, W) image.

    out_size is (width, height); returns (height, width) in [0, 1].

    background: fill for output pixels whose sampling point leaves the
    source frame. "zero" (default) matches PIL EXTENT's black fill;
    "random" fills them with uniform [0, 1) noise drawn from ``generator``
    (a CPU generator; seed 0 when None), like the reference's
    ``im_transform_randombackground``
    (face_normalization_tools.py:53-106,316).
    """
    ow, oh = out_size
    dev = image.device
    X = torch.arange(ow, dtype=torch.float32, device=dev) - (ow - 1) / 2.0
    Y = torch.arange(oh, dtype=torch.float32, device=dev) - (oh - 1) / 2.0
    u = X[None, :] * fp.sf
    v = Y[:, None] * fp.sf
    rad = np.deg2rad(fp.angle_deg)
    c, s = float(np.cos(rad)), float(np.sin(rad))
    sx = fp.center_x + c * u + (-s) * v
    sy = fp.center_y + s * u + c * v
    out = _bilinear_gather(image, sx, sy)
    if background == "random":
        H, W = image.shape
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        oob = (sx < 0) | (sx > W - 1) | (sy < 0) | (sy > H - 1)
        noise = torch.rand(out.shape, generator=generator).to(dev)
        out = torch.where(oob, noise, out)
    elif background != "zero":
        raise ValueError(f"unknown background {background!r}")
    if fp.mirror:
        out = torch.flip(out, dims=(1,))
    return out


def _bilinear_gather(image: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor
                     ) -> torch.Tensor:
    """Bilinear samples of (H, W) ``image`` at continuous pixel INDEX
    coordinates (no pixel-centre offset); out-of-image taps are 0."""
    H, W = image.shape
    img = image.to(torch.float32).reshape(-1)
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    tx = sx - x0
    ty = sy - y0
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)

    def tap(iy, ix):
        inb = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        idx = torch.clamp(iy, 0, H - 1) * W + torch.clamp(ix, 0, W - 1)
        return torch.where(inb, img[idx], 0.0)

    top = tap(y0, x0) * (1 - tx) + tap(y0, x0 + 1) * tx
    bot = tap(y0 + 1, x0) * (1 - tx) + tap(y0 + 1, x0 + 1) * tx
    return top * (1 - ty) + bot * ty


def normalize_image(image, coords,
                    normalization_method: str = "eyes_mouth_area",
                    centering_mode: str = "mid_eyes_mouth",
                    rotation_mode: str = "noRotation",
                    out_size: Tuple[int, int] = (256, 192),
                    rng: Optional[np.random.RandomState] = None,
                    background: str = "zero",
                    device=None) -> np.ndarray:
    """Host convenience wrapper: (H, W) array in [0, 1] -> normalized array,
    sampled on ``device`` (default ``cuda``). A tensor is taken as it is
    and, with no ``device`` given, sampled where it lies, so a caller with
    many faces of one image copies it to the device once.

    background="random" fills out-of-frame pixels with noise seeded from
    ``rng``, like the reference's allow_random_background path
    (face_normalization_tools.py:53,316).
    """
    fp = frame_params(coords, normalization_method, centering_mode,
                      rotation_mode, rng=rng, out_size=out_size)
    generator = None
    if background == "random":
        seed = int((rng or np.random.RandomState()).randint(2 ** 31))
        generator = torch.Generator().manual_seed(seed)
    if torch.is_tensor(image):
        img = image.to(device=image.device if device is None
                       else resolve_device(device), dtype=torch.float32)
    else:
        img = torch.as_tensor(np.asarray(image, np.float32),
                              device=resolve_device(device))
    return sample_frame(img, fp, out_size, background=background,
                        generator=generator).cpu().numpy()
