"""Image loading and prescaling (host side; PIL optional).

Port of ``pyfaceanalysis_tpu.io.images``. Reference:
``image_loader.load_images`` (PIL open + convert "L"/"RGB",
FaceDetectUpdated.py:533-535) and the prescaling block (:551-562): images
with a side over ``prescale_size`` are resized so the max side equals it
(NEAREST for L, BILINEAR for RGB display).

Returns float32 arrays in [0, 1]; all detection coordinates are expressed in
the prescaled frame (matching the reference's output convention).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

try:
    from PIL import Image
    _HAVE_PIL = True
except ImportError:                                   # pragma: no cover
    _HAVE_PIL = False


def load_image(path: str, prescale_size: Optional[int] = 1000,
               mode: str = "L") -> Tuple[np.ndarray, float]:
    """Loads an image as float32 [0, 1]; returns (array, prescaling_factor).

    prescale_size None disables prescaling. The factor is new/old (<= 1).
    """
    if not _HAVE_PIL:
        raise RuntimeError("PIL is required for image loading")
    im = Image.open(path).convert(mode)
    w, h = im.size
    factor = 1.0
    if prescale_size is not None and max(w, h) > prescale_size:
        factor = prescale_size / float(max(w, h))
        new_size = (int(w * factor), int(h * factor))
        resample = Image.NEAREST if mode == "L" else Image.BILINEAR
        im = im.resize(new_size, resample)
    arr = np.asarray(im, np.float32) / 255.0
    return arr, factor


def save_image(path: str, array: np.ndarray, quality: int = 90) -> None:
    """Saves a [0, 1] float array as JPEG/PNG (reference saves JPEG q90,
    face_normalization_tools.py:470)."""
    if not _HAVE_PIL:
        raise RuntimeError("PIL is required for image saving")
    a = np.clip(np.asarray(array) * 255.0, 0, 255).astype(np.uint8)
    Image.fromarray(a).save(path, quality=quality)
