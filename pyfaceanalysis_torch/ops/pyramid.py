"""Scale-ladder image pyramid and aligned crops.

Port of ``pyfaceanalysis_tpu.ops.pyramid``:

- ``build_pyramid``: one separable nearest resize per ladder scale, each
  level in the top-left corner of a fixed (lh, lw) plane, zero elsewhere.
  The ``ceil(H / s)`` extents and the half-to-even rounding of the sample
  positions are copied exactly, so the levels are bit-identical.
- ``build_pyramid_batch``: the same for a stack of images, image-major
  along the level axis (the layout of the fused multi-image cascade).
- ``crop_patches``: (B, 3) int32 ``[level, y, x]`` -> (B, h, w) crops, with
  the start clamped into the pyramid as ``lax.dynamic_slice`` clamps it.
  This is the plain version of the crop kernel (ops.cuda_crop).
"""

from __future__ import annotations

from typing import Tuple

import torch


def build_pyramid(image: torch.Tensor, scales: Tuple[float, ...],
                  level_hw: Tuple[int, int]) -> torch.Tensor:
    """(H, W) float32 image -> (L, lh, lw) nearest-resized levels.

    Level k holds the image at 1/scales[k] resolution (one level pixel =
    scales[k] source pixels, sampled at pixel centres); out-of-image
    texels are 0.
    """
    lh, lw = level_hw
    return build_pyramid_batch(image[None], scales, level_hw).reshape(
        len(scales), lh, lw)


def build_pyramid_batch(images: torch.Tensor, scales: Tuple[float, ...],
                        level_hw: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W) image stack -> (B*L, lh, lw) image-major stacked pyramid.

    Image b's levels occupy rows [b*L, (b+1)*L): the layout that the folded
    crop levels of ``engine.cascade.make_batched_grid_state`` index. Each
    level is one row take and one column take for the whole stack.
    """
    B, H, W = images.shape
    lh, lw = level_hw
    dev = images.device
    out = torch.zeros((B, len(scales), lh, lw), dtype=torch.float32,
                      device=dev)
    for k, s in enumerate(scales):
        hk = min(lh, max(1, int(-(-H // s))))      # ceil(H / s), capped
        wk = min(lw, max(1, int(-(-W // s))))
        sy = torch.round((torch.arange(hk, dtype=torch.float32, device=dev)
                          + 0.5) * s - 0.5).to(torch.int64)
        sx = torch.round((torch.arange(wk, dtype=torch.float32, device=dev)
                          + 0.5) * s - 0.5).to(torch.int64)
        oky = (sy >= 0) & (sy < H)
        okx = (sx >= 0) & (sx < W)
        rows = images[:, torch.clamp(sy, 0, H - 1)]           # (B, hk, W)
        lvl = rows[:, :, torch.clamp(sx, 0, W - 1)]           # (B, hk, wk)
        out[:, k, :hk, :wk] = torch.where(oky[:, None] & okx[None], lvl, 0.0)
    return out.reshape(B * len(scales), lh, lw)


def crop_patches(pyramid: torch.Tensor, crops: torch.Tensor,
                 patch_hw: Tuple[int, int] = (64, 64)) -> torch.Tensor:
    """crops: (B, 3) int ``[level, y, x]`` -> (B, h, w) contiguous crops.

    Starts are clamped to ``[0, L-1] x [0, lh-h] x [0, lw-w]``.
    """
    L, lh, lw = pyramid.shape
    h, w = patch_hw
    crops = crops.to(torch.int64)
    lev = torch.clamp(crops[:, 0], 0, L - 1)
    y = torch.clamp(crops[:, 1], 0, lh - h)
    x = torch.clamp(crops[:, 2], 0, lw - w)
    dev = pyramid.device
    rows = y[:, None] + torch.arange(h, device=dev)[None]       # (B, h)
    cols = x[:, None] + torch.arange(w, device=dev)[None]       # (B, w)
    return pyramid[lev[:, None, None], rows[:, :, None], cols[:, None, :]]
