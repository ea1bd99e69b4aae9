"""Eye localization sub-cascade.

Port of ``pyfaceanalysis_tpu.engine.eyes`` (reference ``find_Left_Right_eyes``,
face_analysis.py:1036-1109): extract contrast-enhanced 64x64 eye patches at
the approximate eye boxes, run the eye network once for both classifiers
(EyeLX and EyeLY share it), and shift the boxes by the rotation-corrected
regression. Both eyes run the left-eye path, batched together.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from pyfaceanalysis_torch.config import EYE_SAMPLING
from pyfaceanalysis_torch.models.network import HierarchicalNetwork
from pyfaceanalysis_torch.ops.contrast import contrast_enhance_patches
from pyfaceanalysis_torch.ops.gaussian import GaussianRegressor
from pyfaceanalysis_torch.ops.patches import extract_patches_rotate


def _eye_levels(scales: torch.Tensor, box_w: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pyramid level per eye box: the FINEST level whose texel pitch keeps
    the rotated box extent within 111 texels (``s_k >= box_w / 80``). The
    bound comes from the TPU kernel's 128-row tile; it is kept because it
    decides which level, and so which texels, an eye patch samples.

    Returns ``(levels, no_cover)``; ``no_cover`` marks boxes too wide for
    even the coarsest level, which :func:`_eye_patches` takes from the
    canvas gather (as the JAX package does)."""
    need = box_w / 80.0
    cand = torch.where(scales[None, :] >= need[:, None], scales[None, :],
                       torch.full_like(scales[None, :], float("inf")))
    idx = torch.argmin(cand, dim=1)
    no_cover = torch.isinf(cand.min(dim=1).values)
    levels = torch.where(no_cover, torch.argmax(scales), idx)
    return levels.to(torch.int32), no_cover


def _eye_patches(image: torch.Tensor, eye_boxes: torch.Tensor,
                 angles: torch.Tensor, patch_hw: Tuple[int, int],
                 pyramid: Optional[torch.Tensor] = None,
                 pyr_scales: Optional[torch.Tensor] = None,
                 level_sampler: Optional[Callable] = None,
                 image_idx: Optional[torch.Tensor] = None,
                 n_base_levels: int = 0) -> torch.Tensor:
    """The (B, h, w) NEAREST eye patches of :func:`localize_eyes`.

    From the pyramid when it is given, except that a box wider than the
    coarsest level's budget takes its patch from the canvas gather. The
    canvas patches are made for every box and selected per box, so that
    no flag goes to the host (which would wait for the device); the
    result is the same."""
    canvas = extract_patches_rotate(image, eye_boxes, angles, patch_hw,
                                    method="nearest", image_idx=image_idx)
    if pyramid is None or level_sampler is None:
        return canvas
    bw = torch.abs(eye_boxes[:, 2] - eye_boxes[:, 0]) + 1.0
    if image_idx is not None and n_base_levels > 0:
        levels, no_cover = _eye_levels(pyr_scales[:n_base_levels], bw)
        levels = levels + image_idx.to(torch.int32) * n_base_levels
    else:
        levels, no_cover = _eye_levels(pyr_scales, bw)
    patches = level_sampler(pyramid, pyr_scales, levels, eye_boxes, angles,
                            patch_hw, method="nearest")
    return torch.where(no_cover[:, None, None], canvas, patches)


def localize_eyes(net: HierarchicalNetwork, dim_x: int, dim_y: int,
                  patch_hw: Tuple[int, int], image: torch.Tensor,
                  clf_x: GaussianRegressor, clf_y: GaussianRegressor,
                  eye_boxes: torch.Tensor, angles: torch.Tensor,
                  pyramid: Optional[torch.Tensor] = None,
                  pyr_scales: Optional[torch.Tensor] = None,
                  level_sampler: Optional[Callable] = None,
                  image_idx: Optional[torch.Tensor] = None,
                  n_base_levels: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batched eye-localization pass.

    Args:
        eye_boxes: (B, 4) approximate eye boxes (either eye; L/R batched).
        angles: (B,) face angles in degrees.
        pyramid/pyr_scales/level_sampler: when all given, patches are
            sampled from the pyramid by ``level_sampler`` (the gather
            kernel's wrapper or its plain version) at the levels of
            :func:`_eye_levels`; otherwise by the canvas gather.
        image_idx/n_base_levels: fused multi-image batch -- ``image`` is a
            (B, H, W) stack, ``image_idx`` the per-box image, ``pyramid``
            the stacked per-image pyramids (B * n_base_levels levels) with
            ``pyr_scales`` the single-image ladder TILED B times; the level
            is chosen on the base ladder and folded per box
            (level' = img * n_base_levels + level).

    Returns ``(new_boxes (B, 4), max_reg (B,))`` with max_reg =
    max(|reg_x|, |reg_y|); callers apply the "too far" gate.
    """
    h, w = patch_hw
    # NEAREST, like every reference extraction.
    patches = _eye_patches(image, eye_boxes, angles, patch_hw, pyramid,
                           pyr_scales, level_sampler, image_idx,
                           n_base_levels)
    flat = patches.reshape(patches.shape[0], -1)
    flat = contrast_enhance_patches(flat, obj_avg=0.11, obj_std=0.15)
    sl = net(flat)
    reg_x = clf_x.regression(sl[:, :dim_x])
    reg_y = clf_y.regression(sl[:, :dim_y])
    max_reg = torch.maximum(torch.abs(reg_x), torch.abs(reg_y))

    box_w = torch.abs(eye_boxes[:, 2] - eye_boxes[:, 0])
    box_h = torch.abs(eye_boxes[:, 3] - eye_boxes[:, 1])
    off_x = (reg_x / EYE_SAMPLING) * box_w / w
    off_y = (reg_y / EYE_SAMPLING) * box_h / h
    # Rotate the patch-frame offset into the image frame
    # (face_analysis.py:1096-1104 with factor = 1).
    rad = -torch.deg2rad(angles)
    dx = off_x * torch.cos(rad) - off_y * torch.sin(rad)
    dy = off_y * torch.cos(rad) + off_x * torch.sin(rad)
    new_boxes = torch.stack([eye_boxes[:, 0] - dx, eye_boxes[:, 1] - dy,
                             eye_boxes[:, 2] - dx, eye_boxes[:, 3] - dy],
                            dim=1)
    return new_boxes, max_reg
