"""Dataset builders for each pipeline stage family, on the device.

Port of ``pyfaceanalysis_tpu.training.datasets``. Each builder renders
synthetic faces (training.synth) and extracts patches with the same
sampling the detector uses (ops.patches), so coordinate and rotation
conventions agree end to end. Label ranges follow the reference pipeline:

- pose iter-0:  dx +-40, dy +-20 (regression units), angle +-22.5 deg,
                sampling 0.694..0.981
- pose iter-1:  dx +-14, dy +-13, angle +-21, same sampling envelope
- disc:         10 graded centering classes, avg_labels linspace(0, 1, 10)
                (0 = centered face, 1 = background)
- eyes:         +-10 px labels in the 2.3719-sampled 64-unit eye frame
- age/race/gender: 16.5-57.8 years / +-2 / +-1 on Z-frame 96x96 patches

Random values come from a :class:`~pyfaceanalysis_torch.training.sampler.
Sampler`, drawn in the JAX functions' call order. Patches stay on the
sampler's device; labels are host numpy.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from pyfaceanalysis_torch.config import (
    DESIRED_SAMPLING,
    EYE_SAMPLING,
    NetGeometry,
)
from pyfaceanalysis_torch.engine.heads import (  # noqa: F401 (re-exported)
    AGE_SAMPLING,
    AGE_TY,
    Z_SIZE,
    age_patch_constants,
)
from pyfaceanalysis_torch.ops.contrast import (
    contrast_enhance_patches,
    contrast_normalize_avg_std,
)
from pyfaceanalysis_torch.ops.patches import extract_patches_rotate
from pyfaceanalysis_torch.training import synth
from pyfaceanalysis_torch.training.sampler import Sampler

CANVAS = (240, 240)
# Face sizes are randomized per canvas: with a fixed size, patch-resampling
# blur correlates with the scale label and the nets latch onto it.
FACE_SIZE_RANGE = (40.0, 110.0)
# Inter-eye distance of 75 px in the Z frame.
Z_FACE_SIZE = 75.0 / (2 * synth.EYE_X)


def _render_batch(sampler: Sampler, n, with_face=True, canvas=CANVAS,
                  face_size_range=FACE_SIZE_RANGE, angle_range=0.0,
                  attr_cues="v3"):
    """n canvases with randomized face size and (optionally) in-plane face
    angle: detection-time rotation lives in the FACE, so rotation-robust
    stages train on rotated renders."""
    sizes = sampler.uniform(n, face_size_range[0], face_size_range[1])
    angles = sampler.uniform(n, -angle_range, angle_range)
    return synth.render_faces(sampler, n, canvas, face_size=sizes,
                              angle_deg=angles, with_face=with_face,
                              attr_cues=attr_cues)


_POOL_KEYS = ("eye_l", "eye_r", "mouth", "face_size", "angle")


def _face_canvases(sampler: Sampler, n, angle_range, real_source=None,
                   real_frac=0.0, canvas=CANVAS,
                   face_size_range=FACE_SIZE_RANGE, attr_cues="v3"):
    """n face canvases: synthetic renders mixed with warped real annotated
    faces (training.real) at ratio ``real_frac``; attrs follow the
    annotation convention either way."""
    n_real = int(n * real_frac) if real_source is not None else 0
    n_real = min(n_real, n - 1) if n > 1 else 0
    imgs, attrs = _render_batch(sampler, n - n_real, angle_range=angle_range,
                                canvas=canvas,
                                face_size_range=face_size_range,
                                attr_cues=attr_cues)
    if n_real > 0:
        seed = int(sampler.randint((), 0, 2 ** 31 - 1))
        r_imgs, r_attrs = real_source.sample_faces(
            seed, n_real, canvas, face_size_range, angle_range)
        imgs = torch.cat([imgs, r_imgs], dim=0)
        attrs = {k: torch.cat([attrs[k], torch.as_tensor(
            r_attrs[k], device=imgs.device)], dim=0) for k in _POOL_KEYS}
    return imgs, attrs


def _boxes_from_centers(cx, cy, side):
    """Inclusive [x0, y0, x1, y1] boxes from centres and side lengths."""
    x0 = cx - (side - 1.0) / 2.0
    y0 = cy - (side - 1.0) / 2.0
    return torch.stack([x0, y0, x0 + side - 1.0, y0 + side - 1.0], dim=-1)


def _extract_batch(imgs: torch.Tensor, boxes: torch.Tensor,
                   angles: torch.Tensor) -> torch.Tensor:
    """(M, H, W) canvases, (M, T, 4) boxes, (M, T) angles -> (M, T, 64, 64)
    patches, box row m from canvas m, nearest like the inference
    extractions."""
    M, T = angles.shape
    img_idx = torch.arange(M, device=imgs.device).repeat_interleave(T)
    out = extract_patches_rotate(imgs, boxes.reshape(M * T, 4),
                                 angles.reshape(M * T), (64, 64),
                                 method="nearest", image_idx=img_idx)
    return out.reshape(M, T, 64, 64)


def _face_centers(attrs):
    fc_x = ((attrs["eye_l"][:, 0] + attrs["eye_r"][:, 0]) / 2.0
            + attrs["mouth"][:, 0]) / 2.0
    fc_y = ((attrs["eye_l"][:, 1] + attrs["eye_r"][:, 1]) / 2.0
            + attrs["mouth"][:, 1]) / 2.0
    return fc_x, fc_y


def _blur1(p):
    return (p + torch.roll(p, 1, -1) + torch.roll(p, -1, -1)
            + torch.roll(p, 1, -2) + torch.roll(p, -1, -2)) / 5.0


def _random_patch_blur(sampler: Sampler, patches, noise_amp: float = 0.0):
    """Per-patch blur augmentation (random strength 0..~2 px), then, with
    ``noise_amp`` > 0, band-passed noise of random per-patch amplitude in
    [0, noise_amp]. Randomizing fine detail makes it an unreliable signal
    during fitting, so the slow features settle on coarse structure that
    transfers to photographs; the noise makes the presence of
    micro-structure uninformative too. patches: (..., h, w)."""
    shape = patches.shape
    n = int(np.prod(shape[:-2]))
    t1 = sampler.uniform((n, 1, 1))
    t2 = sampler.uniform((n, 1, 1)) * t1     # heavier tail
    flat = patches.reshape((n,) + tuple(shape[-2:]))
    b1 = _blur1(flat)
    b2 = _blur1(b1)
    out = flat * (1 - t1) + b1 * (t1 - t2) + b2 * t2
    if noise_amp > 0.0:
        amp = sampler.uniform((n, 1, 1)) * noise_amp
        white = sampler.normal(tuple(out.shape))
        out = torch.clamp(out + amp * (white - _blur1(white)), 0.0, 1.0)
    return out.reshape(shape)


def _maybe_contrast(flat, enabled: bool):
    """The cascade's per-patch contrast normalization (mean 137.5 / std
    0.4*255 in [0, 255] units), applied at training time iff the model is
    to run with detection_contrast_normalize."""
    if not enabled:
        return flat
    return contrast_normalize_avg_std(flat * 255.0, 137.5,
                                      0.40 * 255.0) / 255.0


def _offset_boxes(fc_x, fc_y, a, dx, dy, b, geom: NetGeometry):
    """Boxes of side b displaced by R(a) . (dx, dy) patch-frame offsets
    (regression units) from the face centres."""
    rad = torch.deg2rad(a)
    off_x = dx * b / geom.regression_width
    off_y = dy * b / geom.regression_height
    cx = fc_x[:, None] + torch.cos(rad) * off_x - torch.sin(rad) * off_y
    cy = fc_y[:, None] + torch.sin(rad) * off_x + torch.cos(rad) * off_y
    return _boxes_from_centers(cx, cy, b)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().reshape(-1)


def pose_dataset(sampler: Sampler, num_faces: int, steps: int,
                 geom: NetGeometry, dx_range: float, dy_range: float,
                 ang_range: float, real_source=None, real_frac: float = 0.0,
                 contrast_normalize: bool = False, attr_cues: str = "v3",
                 texture_noise: float = 0.0
                 ) -> Tuple[torch.Tensor, Dict[str, np.ndarray]]:
    """Pose patches: (N, 4096) in [0, 1] plus labels dx/dy/ang/scale,
    N = num_faces * steps, independent uniform pose draws per face."""
    # Faces render at random in-plane angles.
    imgs, attrs = _face_canvases(sampler, num_faces, ang_range,
                                 real_source, real_frac,
                                 attr_cues=attr_cues)
    F = attrs["face_size"]                                       # (M,)
    theta = attrs["angle"]                                       # (M,)
    fc_x, fc_y = _face_centers(attrs)

    M, T = num_faces, steps
    dx = sampler.uniform((M, T), -dx_range, dx_range)
    dy = sampler.uniform((M, T), -dy_range, dy_range)
    ang = sampler.uniform((M, T), -ang_range, ang_range)
    smp = sampler.uniform((M, T), geom.mins, geom.maxs)

    # Scale label: the update ``new_w = w / reg * 0.825`` maps the box onto
    # the face size F exactly when reg = 0.825 * b / F, so the label smp
    # means box side b = smp * F / 0.825. Extraction happens at the current
    # ANGLE ESTIMATE a = theta - ang (the net sees a residual rotation of
    # ``ang``, the PAng label); position labels are patch-frame offsets.
    b = smp * F[:, None] / DESIRED_SAMPLING                      # box side px
    a = theta[:, None] - ang                                     # (M, T)
    boxes = _offset_boxes(fc_x, fc_y, a, dx, dy, b, geom)        # (M, T, 4)
    patches = _extract_batch(imgs, boxes, a)                     # (M,T,64,64)
    patches = _random_patch_blur(sampler, patches, noise_amp=texture_noise)

    N = num_faces * steps
    labels = {"dx": _host(dx), "dy": _host(dy), "ang": _host(ang),
              "scale": _host(smp)}
    return _maybe_contrast(patches.reshape(N, -1), contrast_normalize), labels


def disc_dataset(sampler: Sampler, num_faces: int, steps: int,
                 geom: NetGeometry, num_classes: int = 10, real_source=None,
                 texture_noise: float = 0.0,
                 texture_noise_bg: float = 0.0,
                 real_frac: float = 0.0, real_bg_frac: float = 0.0,
                 contrast_normalize: bool = False,
                 mined_frac: float = 0.0, attr_cues: str = "v3",
                 return_frac: bool = False):
    """Graded face-centering patches.

    Classes 0..num_classes-2 have perturbation magnitudes growing linearly
    (class 0 = centred); the last class is background: synthetic
    face-free scenes mixed with real face-free photo crops at
    ``real_bg_frac``, plus ``mined_frac`` x its size of patches on the
    real source's mined false-positive boxes when it carries any. Real
    annotated faces join the graded classes at ``real_frac``.
    ``texture_noise_bg`` sets the background/mined injection amplitude
    apart from the face classes (0 = inherit ``texture_noise``).

    Returns (patches (N, 4096) on the device, class_ids (N,) int64,
    avg_labels (C,) = linspace(0, 1, C)), and with ``return_frac`` the
    continuous centering fraction per patch (background 1.0).
    """
    bg_noise = texture_noise_bg if texture_noise_bg > 0 else texture_noise
    imgs, attrs = _face_canvases(sampler, num_faces, 22.5,
                                 real_source, real_frac,
                                 attr_cues=attr_cues)
    F = attrs["face_size"]
    theta = attrs["angle"]
    fc_x, fc_y = _face_centers(attrs)
    dev = imgs.device

    M, T = num_faces, steps
    cls = sampler.randint((M, T), 0, num_classes - 1)   # 0..C-2
    frac = (cls + sampler.uniform((M, T))) / (num_classes - 1)
    frac = torch.clamp(frac, 0.0, 1.0)
    d = sampler.uniform((4, M, T), -1.0, 1.0)
    # All perturbation dimensions scale together with the class fraction
    # (coherent quality grades), beyond the pose envelope.
    dx = 48.0 * frac * torch.sign(d[0]) * (0.35 + 0.65 * torch.abs(d[0]))
    dy = 24.0 * frac * torch.sign(d[1]) * (0.35 + 0.65 * torch.abs(d[1]))
    ang = 27.0 * frac * d[2]
    # The JAX code takes the float32 log of the float32 ratio.
    log_span = torch.log(torch.tensor(geom.maxs / geom.mins,
                                      dtype=torch.float32, device=dev)) * 0.75
    smp = DESIRED_SAMPLING * torch.exp(log_span * frac * torch.sign(d[3])
                                       * (0.3 + 0.7 * torch.abs(d[3])))

    b = smp * F[:, None] / DESIRED_SAMPLING
    a = theta[:, None] - ang              # extraction = angle estimate
    boxes = _offset_boxes(fc_x, fc_y, a, dx, dy, b, geom)
    patches = _random_patch_blur(sampler, _extract_batch(imgs, boxes, a),
                                 noise_amp=texture_noise)
    patches = patches.reshape(M * T, -1)
    cls = _host(cls)

    # Background class: patches from face-free canvases at random scales.
    n_bg = M * T // (num_classes - 1) + 1
    n_canv = max(n_bg // 8, 1)
    n_real_canv = (int(n_canv * real_bg_frac)
                   if real_source is not None else 0)
    bg_imgs, _ = _render_batch(sampler, max(n_canv - n_real_canv, 1),
                               with_face=False, attr_cues=attr_cues)
    if n_real_canv > 0:
        seed = int(sampler.randint((), 0, 2 ** 31 - 1))
        real_bg = real_source.sample_backgrounds(seed, n_real_canv, CANVAS)
        bg_imgs = torch.cat([bg_imgs, real_bg], dim=0)
    nb = bg_imgs.shape[0]
    per = -(-n_bg // nb)
    side = sampler.uniform((nb, per), 24.0, CANVAS[0] * 0.7)
    bcx = sampler.uniform((nb, per), 40.0, CANVAS[1] - 40.0)
    bcy = sampler.uniform((nb, per), 40.0, CANVAS[0] - 40.0)
    bg_boxes = _boxes_from_centers(bcx, bcy, side)
    bg_patches = _random_patch_blur(
        sampler, _extract_batch(bg_imgs, bg_boxes,
                                torch.zeros((nb, per), device=dev)),
        noise_amp=bg_noise)
    bg_patches = bg_patches.reshape(nb * per, -1)

    n_mined = (int(nb * per * mined_frac)
               if (real_source is not None
                   and getattr(real_source, "num_mined", 0) > 0) else 0)
    if n_mined > 0:
        seed = int(sampler.randint((), 0, 2 ** 31 - 1))
        hw = (geom.subimage_height, geom.subimage_width)
        mined = real_source.sample_mined_patches(seed, n_mined, hw)
        mined = _random_patch_blur(sampler, mined, noise_amp=bg_noise)
        bg_patches = torch.cat([bg_patches, mined.reshape(n_mined, -1)],
                               dim=0)

    all_patches = torch.cat([patches, bg_patches], dim=0)
    all_cls = np.concatenate([cls,
                              np.full(nb * per + n_mined, num_classes - 1,
                                      np.int64)])
    avg_labels = np.linspace(0.0, 1.0, num_classes)
    out = _maybe_contrast(all_patches, contrast_normalize)
    if return_frac:
        frac_all = np.concatenate([_host(frac),
                                   np.ones(nb * per + n_mined)])
        return out, all_cls, avg_labels, frac_all
    return out, all_cls, avg_labels


def residual_dataset(sampler: Sampler, num_faces: int, steps: int,
                     geom: NetGeometry, texture_noise: float = 0.0,
                     *, attr_cues: str = "v3",
                     dx_r: float = 2.5, dy_r: float = 3.0, ang_r: float = 8.0,
                     logscale_r: float = 0.10,
                     real_source=None, real_frac: float = 0.0,
                     contrast_normalize: bool = False) -> torch.Tensor:
    """Patches perturbed like post-refinement residuals on true faces, to
    calibrate the final Disc cutoff; real faces join at ``real_frac``."""
    imgs, attrs = _face_canvases(sampler, num_faces, 20.0,
                                 real_source, real_frac,
                                 attr_cues=attr_cues)
    F = attrs["face_size"]
    theta = attrs["angle"]
    fc_x, fc_y = _face_centers(attrs)
    M, T = num_faces, steps
    dx = sampler.uniform((M, T), -dx_r, dx_r)
    dy = sampler.uniform((M, T), -dy_r, dy_r)
    ang = sampler.uniform((M, T), -ang_r, ang_r)
    smp = DESIRED_SAMPLING * torch.exp(
        sampler.uniform((M, T), -logscale_r, logscale_r))
    b = smp * F[:, None] / DESIRED_SAMPLING
    a = theta[:, None] - ang
    boxes = _offset_boxes(fc_x, fc_y, a, dx, dy, b, geom)
    patches = _random_patch_blur(sampler, _extract_batch(imgs, boxes, a),
                                 noise_amp=texture_noise)
    return _maybe_contrast(patches.reshape(M * T, -1), contrast_normalize)


def eye_dataset(sampler: Sampler, num_faces: int, steps: int,
                geom: NetGeometry, texture_noise: float = 0.0,
                real_source=None, real_frac: float = 0.0,
                attr_cues: str = "v3"
                ) -> Tuple[torch.Tensor, Dict[str, np.ndarray]]:
    """Eye-localization patches: 64x64 crops of eye boxes with the eye
    offset within +-10 label units, contrast-enhanced like the detector's
    eye patches.

    Label convention (inverts engine.eyes): reg = 10 units is an image
    offset of (10 / 2.3719) * box_w / 64 px; the label measures (box
    centre - eye) rotated into the patch frame. Real annotated faces join
    at ``real_frac``.
    """
    imgs, attrs = _face_canvases(sampler, num_faces, 20.0,
                                 real_source, real_frac,
                                 attr_cues=attr_cues)
    F = attrs["face_size"]
    theta = attrs["angle"]
    M, T = num_faces, steps

    # Nominal eye-box width from the detection geometry: for box side
    # b = F, box_w = F / (64 * 2 * 0.825) * (64 * 2.3719 / 2).
    box_w = F / (2 * DESIRED_SAMPLING) * (EYE_SAMPLING / 2.0)
    box_w = box_w[:, None] * (1.0 + 0.08 * sampler.normal((M, 1)))

    # Left or right eye per face (both trained identically).
    use_left = sampler.bernoulli(M)
    eye = torch.where(use_left[:, None], attrs["eye_l"], attrs["eye_r"])

    lab_x = sampler.uniform((M, T), -10.0, 10.0)
    lab_y = sampler.uniform((M, T), -10.0, 10.0)
    # Extraction happens at the detector's face-angle estimate: true face
    # angle plus residual estimation error.
    err = sampler.uniform((M, T), -8.0, 8.0)
    est = theta[:, None] + err

    # box_center = eye + R(-est) . (label/2.3719) * box_w / 64, the
    # rotation engine.eyes applies when shifting boxes.
    off_x = lab_x / EYE_SAMPLING * box_w / 64.0
    off_y = lab_y / EYE_SAMPLING * box_w / 64.0
    rad = torch.deg2rad(-est)
    cxo = torch.cos(rad) * off_x - torch.sin(rad) * off_y
    cyo = torch.sin(rad) * off_x + torch.cos(rad) * off_y
    cx = eye[:, 0:1] + cxo
    cy = eye[:, 1:2] + cyo
    boxes = _boxes_from_centers(cx, cy, box_w * torch.ones_like(cx))
    patches = _extract_batch(imgs, boxes, est)             # (M, T, 64, 64)
    patches = _random_patch_blur(sampler, patches, noise_amp=texture_noise)
    flat = contrast_enhance_patches(patches.reshape(M * T, -1),
                                    obj_avg=0.11, obj_std=0.15)
    return flat, {"x": _host(lab_x), "y": _host(lab_y)}


def age_dataset(sampler: Sampler, n: int, chunk: int = 256,
                jitter_px: float = 1.5, jitter_scale: float = 0.03,
                attr_cues: str = "v3", texture_noise: float = 0.0
                ) -> Tuple[torch.Tensor, Dict[str, np.ndarray]]:
    """Z-frame 96x96 contrast-enhanced patches + age/race/gender labels.

    Renders in chunks of ``chunk`` canvases (the renderer holds several
    (chunk, 260, 256) temporaries); only the (chunk, 96, 96) patches
    survive each chunk.
    """
    cx = Z_SIZE[1] / 2.0 - 0.5
    cy = Z_SIZE[0] / 2.0 - 0.5
    jit_xy = sampler.normal((n, 3))
    fr, fc, tx, ty = age_patch_constants()
    # extract_centered_patch's box, for every canvas of a chunk.
    x0 = fc + tx * AGE_SAMPLING
    y0 = fr + ty * AGE_SAMPLING
    box = torch.tensor([x0, y0, x0 + 96 * AGE_SAMPLING - 1.0,
                        y0 + 96 * AGE_SAMPLING - 1.0], dtype=torch.float32,
                       device=jit_xy.device)
    parts, ages, races, genders = [], [], [], []
    for s in range(0, n, chunk):
        jc = jit_xy[s:s + chunk]
        take = jc.shape[0]
        imgs, attrs = synth.render_faces(
            sampler, take, Z_SIZE,
            face_size=Z_FACE_SIZE * (1 + jitter_scale * jc[:, 2]),
            center=(cx + jitter_px * jc[:, 0], cy + jitter_px * jc[:, 1]),
            attr_cues=attr_cues)
        parts.append(extract_patches_rotate(
            imgs, box.expand(take, 4),
            torch.zeros(take, dtype=torch.float32, device=imgs.device),
            (96, 96), method="bilinear",
            image_idx=torch.arange(take, device=imgs.device)))
        ages.append(_host(attrs["age"]))
        races.append(_host(attrs["race"]))
        genders.append(_host(attrs["gender"]))
    patches = torch.cat(parts, dim=0)
    if texture_noise > 0.0:
        # Texture injection only (the Z-frame stack already has eye-jitter
        # augmentation); see _random_patch_blur.
        amp = sampler.uniform((n, 1, 1)) * texture_noise
        white = sampler.normal(tuple(patches.shape))
        patches = torch.clamp(patches + amp * (white - _blur1(white)),
                              0.0, 1.0)
    flat = contrast_enhance_patches(patches.reshape(n, -1), obj_avg=0.0,
                                    obj_std=0.16)
    labels = {"age": np.concatenate(ages), "race": np.concatenate(races),
              "gender": np.concatenate(genders)}
    return flat, labels
