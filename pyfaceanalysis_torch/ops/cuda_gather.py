"""Rotated pyramid gather kernel: rotated patches from the scale pyramid.

Replaces ``pyfaceanalysis_tpu/ops/pallas_gather.py:sample_patches_pyramid``
(refinement-stage and eye patches) with the hand-written CUDA kernel
``csrc/gather.cu``; its plain version is
``ops.patches.sample_patches_pyramid_ref``. The six affine coefficients per
patch come from ``ops.patches.pyramid_affine``, a small torch prologue that
both versions share. Bound by bytes: 1 or 4 texels read and one float
written per output pixel (see the note in the source).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pyfaceanalysis_torch.ops.cuda_build import CudaLibrary, check_launch
from pyfaceanalysis_torch.ops.patches import (
    pyramid_affine,
    sample_patches_pyramid_ref,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaLibrary("gather.cu", {
    "pfa_gather_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]})


def sample_patches_pyramid(pyramid: torch.Tensor, scales: torch.Tensor,
                           levels: torch.Tensor, boxes: torch.Tensor,
                           angles: torch.Tensor,
                           out_hw: Tuple[int, int] = (64, 64),
                           method: str = "nearest") -> torch.Tensor:
    """(L, lh, lw) pyramid, (L,) scales, (B,) levels, (B, 4) canvas boxes
    [x0, y0, x1, y1] inclusive, (B,) angles in degrees -> (B, oh, ow).

    On a CUDA tensor this launches the kernel (or raises); on a CPU tensor
    it returns the plain version."""
    if pyramid.device.type == "cpu":
        return sample_patches_pyramid_ref(pyramid, scales, levels, boxes,
                                          angles, out_hw, method)
    if pyramid.device.type != "cuda":
        raise ValueError(f"no gather kernel for device {pyramid.device}")
    if method not in ("nearest", "bilinear"):
        raise ValueError(f"unknown method {method!r}")
    if pyramid.dtype != torch.float32 or pyramid.dim() != 3:
        raise ValueError("pyramid must be a (L, lh, lw) float32 tensor")
    B = boxes.shape[0]
    if boxes.shape != (B, 4) or levels.shape != (B,) or angles.shape != (B,):
        raise ValueError("boxes (B, 4), levels (B,) and angles (B,) differ")
    for t in (scales, levels, boxes, angles):
        if t.device != pyramid.device:
            raise ValueError("all inputs must be on the pyramid's device")
    L, lh, lw = pyramid.shape
    oh, ow = out_hw
    pyr = pyramid.contiguous()
    coeffs = pyramid_affine(scales, levels, boxes, angles, out_hw)
    levels32 = levels.to(torch.int32).contiguous()
    out = torch.empty((B, oh, ow), dtype=torch.float32, device=pyr.device)
    if B == 0:
        return out
    lib = KERNEL.lib()
    stream = torch.cuda.current_stream(pyr.device).cuda_stream
    rc = lib.pfa_gather_launch(pyr.data_ptr(), levels32.data_ptr(),
                               coeffs.data_ptr(), out.data_ptr(), B, L, lh,
                               lw, oh, ow, int(method == "bilinear"), stream)
    check_launch(rc, "gather kernel")
    KERNEL.launches += 1
    return out
