"""Rotated patch extraction: from the canvas, and from the scale pyramid.

``extract_patches_rotate`` is the port of
``pyfaceanalysis_tpu.ops.patches.extract_patches_rotate`` (the "canvas
gather"), for one image or a stack of images with a per-box image index:
for each box, sample the image rotated by ``-angle`` about the box centre,
over the (subpixel) box, at ``(h, w)`` output pixels; out-of-image samples
are 0. ``extract_centered_patch`` is the axis-aligned sampled crop of the
age path. Boxes are ``[x0, y0, x1, y1]`` with
x1/y1 inclusive, so the sampled extent is ``[x0, x1 + 1)``. The operation
order follows the JAX function so that nearest sampling rounds alike.

``sample_patches_pyramid_ref`` is the plain version of the rotated pyramid
gather kernel (ops.cuda_gather): the same sampling, read from each patch's
own pyramid level (canvas u <-> level u/s - 0.5), through the affine map
of ``pyramid_affine``, which the kernel reproduces bit for bit. Unlike the TPU kernel it samples float32 texels and
has no tile: every in-level texel is reachable, every out-of-level one is 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def extract_patches_rotate(image: torch.Tensor, boxes: torch.Tensor,
                           angles: torch.Tensor,
                           out_hw: Tuple[int, int] = (64, 64),
                           method: str = "bilinear",
                           image_idx: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """(H, W) image, (B, 4) boxes, (B,) angles in degrees -> (B, h, w);
    or an (N, H, W) stack with ``image_idx`` (B,), the image of each box.

    A positive angle samples the patch rotated counter-clockwise in image
    coordinates (callers pass the face angle directly)."""
    if image.dim() == 3:
        if image_idx is None:
            raise ValueError("an image stack needs image_idx")
        N, H, W = image.shape
        # An index outside the stack (the fused cascade's padding rows
        # carry the sentinel N) reads the last image; such rows are dead.
        base = torch.clamp(image_idx.to(torch.int64), 0,
                           N - 1)[:, None, None] * (H * W)
    else:
        H, W = image.shape
        base = 0
    oh, ow = out_hw
    dev = image.device
    flat_img = image.to(torch.float32).reshape(-1)

    x0, y0, x1, y1 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    bw = x1 + 1.0 - x0
    bh = y1 + 1.0 - y0
    cx = x0 + bw * 0.5
    cy = y0 + bh * 0.5

    fx = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) / ow
    fy = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) / oh
    u = x0[:, None, None] + fx[None, None, :] * bw[:, None, None]
    v = y0[:, None, None] + fy[None, :, None] * bh[:, None, None]

    rad = torch.deg2rad(angles).to(torch.float32)
    c = torch.cos(rad)[:, None, None]
    s = torch.sin(rad)[:, None, None]
    du = u - cx[:, None, None]
    dv = v - cy[:, None, None]
    us = cx[:, None, None] + c * du - s * dv
    vs = cy[:, None, None] + s * du + c * dv
    px = us - 0.5
    py = vs - 0.5

    def tap(iy, ix):
        inb = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        idx = (base + torch.clamp(iy, 0, H - 1) * W
               + torch.clamp(ix, 0, W - 1))
        return torch.where(inb, flat_img[idx], 0.0)

    if method == "nearest":
        return tap(torch.round(py).to(torch.int64),
                   torch.round(px).to(torch.int64))
    if method != "bilinear":
        raise ValueError(f"unknown method {method!r}")
    ix0 = torch.floor(px)
    iy0 = torch.floor(py)
    tx = px - ix0
    ty = py - iy0
    ix0 = ix0.to(torch.int64)
    iy0 = iy0.to(torch.int64)
    top = tap(iy0, ix0) * (1.0 - tx) + tap(iy0, ix0 + 1) * tx
    bot = tap(iy0 + 1, ix0) * (1.0 - tx) + tap(iy0 + 1, ix0 + 1) * tx
    return top * (1.0 - ty) + bot * ty


def extract_centered_patch(image: torch.Tensor, sampling: float,
                           first_row: float, first_col: float,
                           trans_x: float, trans_y: float,
                           out_hw: Tuple[int, int] = (96, 96)
                           ) -> torch.Tensor:
    """Axis-aligned sampled crop, the ``load_image_data_monoprocessor``
    equivalent of the age path (face_analysis.py:1231-1247).

    The box origin is ``(first_col + trans_x * sampling, first_row +
    trans_y * sampling)`` (translations in subimage units), spanning
    ``out * sampling`` source pixels, sampled bilinearly. Returns
    (1, h, w)."""
    oh, ow = out_hw
    x0 = first_col + trans_x * sampling
    y0 = first_row + trans_y * sampling
    boxes = torch.tensor([[x0, y0, x0 + ow * sampling - 1.0,
                           y0 + oh * sampling - 1.0]], dtype=torch.float32,
                         device=image.device)
    return extract_patches_rotate(
        image, boxes, torch.zeros(1, dtype=torch.float32,
                                  device=image.device), out_hw,
        method="bilinear")


def pyramid_affine(scales: torch.Tensor, levels: torch.Tensor,
                   boxes: torch.Tensor, angles: torch.Tensor,
                   out_hw: Tuple[int, int]) -> torch.Tensor:
    """(B, 6) float32 ``[ax, bx, cx, ay, by, cy]`` of the map from output
    pixel (i, j) to continuous level texel coordinates:

        lx = ax * (j + .5) + bx * (i + .5) + cx
        ly = ay * (j + .5) + by * (i + .5) + cy

    (``pallas_gather.py:176-217`` without the tile origin and roll terms).
    This is the plain version's map and the gather kernel's specification:
    the kernel (``csrc/gather.cu patch_affine``) computes the same
    coefficients itself, one float32 rounding per operation in the order
    written here, so changing an expression below changes what the kernel
    must do."""
    oh, ow = out_hw
    lev = torch.clamp(levels.to(torch.int64), 0, scales.shape[0] - 1)
    s_k = scales.to(torch.float32)[lev]
    x0, y0, x1, y1 = (boxes[:, i].to(torch.float32) for i in range(4))
    bw = x1 + 1.0 - x0
    bh = y1 + 1.0 - y0
    cx = x0 + bw * 0.5
    cy = y0 + bh * 0.5
    rad = torch.deg2rad(angles.to(torch.float32))
    co = torch.cos(rad)
    si = torch.sin(rad)
    ax = co * bw / (ow * s_k)
    bx = -si * bh / (oh * s_k)
    cx0 = (cx + co * (x0 - cx) - si * (y0 - cy)) / s_k - 0.5
    ay = si * bw / (ow * s_k)
    by = co * bh / (oh * s_k)
    cy0 = (cy + si * (x0 - cx) + co * (y0 - cy)) / s_k - 0.5
    return torch.stack([ax, bx, cx0, ay, by, cy0], dim=1).contiguous()


def level_coords(coeffs: torch.Tensor, out_hw: Tuple[int, int]):
    """(B, oh, ow) level coordinates (lx, ly) of every output pixel, in the
    operation order of the kernel: ``(a * (j+.5) + b * (i+.5)) + c``."""
    oh, ow = out_hw
    dev = coeffs.device
    jj = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5)[None, None]
    ii = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5)[None, :,
                                                                  None]
    c = [coeffs[:, k, None, None] for k in range(6)]
    lx = c[0] * jj + c[1] * ii + c[2]
    ly = c[3] * jj + c[4] * ii + c[5]
    return lx, ly


def sample_patches_pyramid_ref(pyramid: torch.Tensor, scales: torch.Tensor,
                               levels: torch.Tensor, boxes: torch.Tensor,
                               angles: torch.Tensor,
                               out_hw: Tuple[int, int] = (64, 64),
                               method: str = "nearest") -> torch.Tensor:
    """Plain version of the rotated pyramid gather: (L, lh, lw) pyramid,
    (L,) scales, (B,) levels, (B, 4) boxes, (B,) angles -> (B, oh, ow).

    Nearest rounds half to even; bilinear blends the four neighbouring
    texels, x first, then y. Texels outside the level are 0. Levels are
    clamped into [0, L-1], as the kernel clamps them."""
    L, lh, lw = pyramid.shape
    coeffs = pyramid_affine(scales, levels, boxes, angles, out_hw)
    lx, ly = level_coords(coeffs, out_hw)
    lev = torch.clamp(levels.to(torch.int64), 0, L - 1)
    base = lev[:, None, None] * (lh * lw)
    flat = pyramid.reshape(-1)

    def tap(iy, ix):
        inb = (ix >= 0) & (ix < lw) & (iy >= 0) & (iy < lh)
        idx = base + torch.clamp(iy, 0, lh - 1) * lw + torch.clamp(ix, 0,
                                                                   lw - 1)
        return torch.where(inb, flat[idx], 0.0)

    if method == "nearest":
        return tap(torch.round(ly).to(torch.int64),
                   torch.round(lx).to(torch.int64))
    if method != "bilinear":
        raise ValueError(f"unknown method {method!r}")
    fx0 = torch.floor(lx)
    fy0 = torch.floor(ly)
    tx = lx - fx0
    ty = ly - fy0
    ix0 = fx0.to(torch.int64)
    iy0 = fy0.to(torch.int64)
    top = tap(iy0, ix0) * (1.0 - tx) + tap(iy0, ix0 + 1) * tx
    bot = tap(iy0 + 1, ix0) * (1.0 - tx) + tap(iy0 + 1, ix0 + 1) * tx
    return top * (1.0 - ty) + bot * ty
