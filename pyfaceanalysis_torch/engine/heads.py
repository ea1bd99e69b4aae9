"""Age / race / gender estimation heads.

Port of ``pyfaceanalysis_tpu.engine.heads`` (reference
``estimate_age_race_gender``, face_analysis.py:1170-1306). Per detected face
(post-purge): normalize to the (256, 260) "Z" frame from the localized eyes
(method eyes_inferred-mouth_areaZ, centering mid_eyes_inferred-mouth,
EyeLineRotation), extract a 96x96 patch (sampling 1.14 * 160/96,
ty = -6/(160/96), contrast "AgeContrastEnhancement_Avg_Std" obj_std 0.16),
run the linear-PCA network once, and feed the SAME features to three
regressors: Age (with its std), Race, Gender.

All faces of an image stack go through one device program: one (N*K, 96,
96) gather, one network execution, one (4, N) result pulled to the host.
Label->string maps per face_analysis.py:333-371.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from pyfaceanalysis_torch import normalization
from pyfaceanalysis_torch.ops.contrast import contrast_enhance_patches
from pyfaceanalysis_torch.ops.patches import extract_centered_patch
from pyfaceanalysis_torch.utils.profiling import annotate

# Z-frame (age/race/gender) constants, from estimate_age_race_gender
# (face_analysis.py:1180-1199): out (256, 260), sampling 1.14 * 160/96,
# translation ty = -6 / (160/96) sampled units.
Z_SIZE = (260, 256)                  # (H, W)
AGE_SAMPLING = 1.14 * 160.0 / 96
AGE_TY = -6.0 / (160.0 / 96)


def age_patch_constants(subimage_hw=(96, 96)):
    """first_row/first_col/tx/ty for the Z-frame 96x96 extraction."""
    h, w = subimage_hw
    first_row = Z_SIZE[0] / 2.0 - h * AGE_SAMPLING / 2.0
    first_col = Z_SIZE[1] / 2.0 - w * AGE_SAMPLING / 2.0
    return first_row, first_col, 0.0, AGE_TY


def _tta_offsets(k: int) -> np.ndarray:
    """Deterministic (K, 3) crop perturbations (ox, oy, dlogscale) in
    Z-frame pixels for test-time multi-crop averaging.

    The deploy-time attribute error is dominated by eye-localization
    jitter (~0.08 x inter-eye ~ 6 Z px); averaging the heads over a small
    symmetric crop ring smooths the response surface. Radius 3 Z px and
    +-4% scale match that jitter. k=1 is exactly the reference's single
    crop.
    """
    if k <= 1:
        return np.zeros((1, 3), np.float32)
    r, ds = 3.0, 0.04
    pool = [(r, 0, 0), (-r, 0, 0), (0, r, 0), (0, -r, 0),
            (0, 0, ds), (0, 0, -ds),
            (r, r, 0), (-r, -r, 0), (r, -r, 0), (-r, r, 0)]
    offs = [(0.0, 0.0, 0.0)] + pool[:k - 1]
    return np.asarray(offs, np.float32)


def _age_patch_zgrid() -> Tuple[np.ndarray, np.ndarray]:
    """Static Z-frame coordinates (relative to the Z center) of the 96x96
    age-patch sample grid.

    Composes the two affine resamplings of the reference path --
    source -> (260, 256) Z frame (normalization.sample_frame) followed by
    Z frame -> 96x96 sampled crop (extract_centered_patch at AGE_SAMPLING)
    -- into ONE map, so `_sample_age_patches` gathers exactly the 9216
    output taps per face instead of materializing the 66,560-texel Z frame
    first. Single-stage bilinear of the composed map vs
    bilinear-of-bilinear differ only in filter support; the 96x96 box
    never leaves the Z frame (extent 182.4 px inside 256/260) so the
    zero-fill semantics compose exactly.
    """
    zh, zw = Z_SIZE
    fr, fc, tx, ty = age_patch_constants()
    x0 = fc + tx * AGE_SAMPLING
    y0 = fr + ty * AGE_SAMPLING
    gx = (x0 + (np.arange(96, dtype=np.float32) + 0.5) * AGE_SAMPLING
          - 0.5 - (zw - 1) / 2.0)
    gy = (y0 + (np.arange(96, dtype=np.float32) + 0.5) * AGE_SAMPLING
          - 0.5 - (zh - 1) / 2.0)
    return gx, gy


def _sample_age_patches(images: torch.Tensor, centers: torch.Tensor,
                        angles: torch.Tensor, sfs: torch.Tensor,
                        img_idx: torch.Tensor) -> torch.Tensor:
    """(N, 96, 96) age-head input patches gathered DIRECTLY from the image
    stack through the composed source->patch affine (see _age_patch_zgrid),
    bilinear at pixel-centre coordinates, zero outside the image.

    images: (B, H, W); centers: (N, 2) Z-frame center in source px;
    angles: (N,) deg; sfs: (N,) source px per Z px; img_idx: (N,) int.
    """
    B, H, W = images.shape
    dev = images.device
    flat_img = images.reshape(-1)
    gx, gy = _age_patch_zgrid()
    gx = torch.as_tensor(gx, device=dev)
    gy = torch.as_tensor(gy, device=dev)

    sf = sfs[:, None, None]
    u = gx[None, None, :] * sf
    v = gy[None, :, None] * sf
    rad = torch.deg2rad(angles)
    c = torch.cos(rad)[:, None, None]
    s = torch.sin(rad)[:, None, None]
    sx = centers[:, 0, None, None] + c * u - s * v
    sy = centers[:, 1, None, None] + s * u + c * v
    base = img_idx.to(torch.int64)[:, None, None] * (H * W)
    px = sx - 0.5
    py = sy - 0.5
    ix0 = torch.floor(px)
    iy0 = torch.floor(py)
    tx_ = px - ix0
    ty_ = py - iy0
    ix0 = ix0.to(torch.int64)
    iy0 = iy0.to(torch.int64)

    def tap(iy, ix):
        inb = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        lin = base + torch.clamp(iy, 0, H - 1) * W + torch.clamp(ix, 0, W - 1)
        return torch.where(inb, flat_img[lin], 0.0)

    top = tap(iy0, ix0) * (1 - tx_) + tap(iy0, ix0 + 1) * tx_
    bot = tap(iy0 + 1, ix0) * (1 - tx_) + tap(iy0 + 1, ix0 + 1) * tx_
    return top * (1 - ty_) + bot * ty_


def _arg_forward(net, dims: Tuple[int, int, int], images: torch.Tensor,
                 clf_age, clf_race, clf_gender, centers: torch.Tensor,
                 angles: torch.Tensor, sfs: torch.Tensor,
                 img_idx: torch.Tensor, tta_offsets: torch.Tensor
                 ) -> torch.Tensor:
    """Batched Z-frame normalization + patch + features + three regressions,
    over faces drawn from a STACK of images. Returns ONE stacked (4, N)
    tensor [age, age_std, race, gender], so the caller makes a single
    device-to-host copy.

    images: (B, H, W); centers: (N, 2), angles: (N,) deg, sfs: (N,) source
    px per Z px, img_idx: (N,) image of each face. tta_offsets: (K, 3)
    Z-frame crop perturbations; the K crops of a face run through the same
    batched products (one wider batch) and the head outputs are
    posterior-averaged per face. All arithmetic is float32.
    """
    n = centers.shape[0]
    k = tta_offsets.shape[0]
    # Expand each face into K crops: (ox, oy) rotate with the face angle
    # and scale with sf (offsets are defined in the Z frame); dlogscale
    # multiplies sf.
    rad = torch.deg2rad(angles)
    c, s = torch.cos(rad), torch.sin(rad)
    ox = tta_offsets[None, :, 0]
    oy = tta_offsets[None, :, 1]
    dx = (c[:, None] * ox - s[:, None] * oy) * sfs[:, None]
    dy = (s[:, None] * ox + c[:, None] * oy) * sfs[:, None]
    centers_k = (centers[:, None, :]
                 + torch.stack([dx, dy], dim=-1)).reshape(n * k, 2)
    sfs_k = (sfs[:, None] * torch.exp(tta_offsets[None, :, 2])
             ).reshape(n * k)
    angles_k = torch.repeat_interleave(angles, k)
    idx_k = torch.repeat_interleave(img_idx, k)

    patches = _sample_age_patches(images, centers_k, angles_k, sfs_k, idx_k)
    flat = contrast_enhance_patches(patches.reshape(patches.shape[0], -1),
                                    obj_avg=0.0, obj_std=0.16)
    sl = net(flat)
    d_age, d_race, d_gender = dims
    age_k, age_std_k = clf_age.regression(sl[:, :d_age], estimate_std=True)
    race_k = clf_race.regression(sl[:, :d_race])
    gender_k = clf_gender.regression(sl[:, :d_gender])
    # Per-face averaging over the K crops. Age std combines as the std of
    # the equal-weight mixture of the K per-crop posteriors.
    age_k = age_k.reshape(n, k)
    age = age_k.mean(dim=1)
    age_var = (age_std_k.reshape(n, k) ** 2 + age_k ** 2).mean(dim=1) \
        - age ** 2
    age_std = torch.sqrt(torch.clamp(age_var, min=0.0))
    race = race_k.reshape(n, k).mean(dim=1)
    gender = gender_k.reshape(n, k).mean(dim=1)
    return torch.stack([age, age_std, race, gender])


def _frame_arrays(rows: np.ndarray):
    """Z-frame (centers (N, 2), angles (N,), sfs (N,)) float32 arrays from
    the eye columns 5:9 of detection rows (host float64 arithmetic)."""
    centers, angles, sfs = [], [], []
    for row in rows:
        coords = [row[5], row[6], row[7], row[8], 0.0, 0.0]
        fp = normalization.frame_params(
            coords, normalization_method="eyes_inferred-mouth_areaZ",
            centering_mode="mid_eyes_inferred-mouth",
            rotation_mode="EyeLineRotation", out_size=(Z_SIZE[1], Z_SIZE[0]))
        centers.append([fp.center_x, fp.center_y])
        angles.append(fp.angle_deg)
        sfs.append(fp.sf)
    return (np.asarray(centers, np.float32), np.asarray(angles, np.float32),
            np.asarray(sfs, np.float32))


def estimate_age_race_gender_multi(images: torch.Tensor, rows: np.ndarray,
                                   img_idx: np.ndarray, model,
                                   tta: int = 1
                                   ) -> Tuple[np.ndarray, np.ndarray,
                                              np.ndarray, np.ndarray]:
    """Attribute heads for faces spread over an image STACK, as one device
    program. images: (B, H, W) stack on the model's device; rows: (N, 10)
    purged detections; img_idx: (N,) image index per row. tta: number of
    crops averaged per face (1 = reference behavior).

    The JAX package pads the face batch to a power of two to spare
    recompiles; nothing is compiled here and no output depends on the
    padding, so the batch is exactly N faces."""
    n = len(rows)
    if n == 0:
        z = np.zeros(0)
        return z, z, z, z
    dev = images.device
    centers, angles, sfs = _frame_arrays(rows)
    out = _arg_forward(
        model.nets["net_age"],
        (model.clf_input_dim("Age"), model.clf_input_dim("Race"),
         model.clf_input_dim("Gender")),
        images, model.classifier("Age"), model.classifier("Race"),
        model.classifier("Gender"),
        torch.as_tensor(centers, device=dev),
        torch.as_tensor(angles, device=dev),
        torch.as_tensor(sfs, device=dev),
        torch.as_tensor(np.asarray(img_idx, np.int64), device=dev),
        torch.as_tensor(_tta_offsets(tta), device=dev))
    with annotate("pfa.pull"):
        out = out.cpu().numpy()                 # ONE (4, N) pull
    return out[0], out[1], out[2], out[3]


def estimate_age_race_gender(image: torch.Tensor, rows: np.ndarray, model,
                             tta: int = 1
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                        np.ndarray]:
    """rows: (N, 10) purged detections of one (H, W) image. Returns (ages,
    age_stds, race_values, gender_values) as float arrays (label values,
    not strings)."""
    return estimate_age_race_gender_multi(
        image[None], rows, np.zeros(len(rows), np.int64), model, tta=tta)


def save_age_estimation_images(image: torch.Tensor, rows: np.ndarray,
                               pattern: str = "ImageForAgeEstimation%03d.jpg",
                               start_index: int = 0) -> int:
    """Writes the 96x96 age-head input patches as JPEGs.

    The reference does this UNCONDITIONALLY during attribute estimation
    (face_analysis.py:1251-1254, 'ImageForAgeEstimation%03d.jpg'); here it is
    an opt-in debug side output (DetectorConfig.save_age_estimation_images),
    made by the reference's two-stage route: Z frame, then the sampled crop.
    Returns the next index.
    """
    from pyfaceanalysis_torch.io import images as im_io

    centers, angles, sfs = _frame_arrays(rows)
    fr, fc, tx, ty = age_patch_constants()
    zh, zw = Z_SIZE
    for j in range(len(rows)):
        fp = normalization.FrameParams(centers[j][0], centers[j][1],
                                       angles[j], sfs[j])
        z = normalization.sample_frame(image, fp, (zw, zh))
        patch = extract_centered_patch(z, AGE_SAMPLING, fr, fc, tx, ty,
                                       (96, 96))[0]
        im_io.save_image(pattern % (start_index + j), patch.cpu().numpy())
    return start_index + len(rows)


def gender_strings(values, long_text: bool = True) -> List[str]:
    """-1 -> Male, +1 -> Female (face_analysis.py:333-351)."""
    return [("Male" if long_text else "M") if v <= 0
            else ("Female" if long_text else "F") for v in values]


def race_strings(values, long_text: bool = True) -> List[str]:
    """-2 -> Black, +2 -> White (face_analysis.py:354-371)."""
    return [("Black" if long_text else "B") if v <= 0
            else ("White" if long_text else "W") for v in values]
