"""Crop kernel: batched axis-aligned crops from the scale pyramid.

Replaces ``pyfaceanalysis_tpu/ops/pallas_crop.py:crop_patches_pallas``
(the iter-0 grid extraction) with the hand-written CUDA kernel
``csrc/crop.cu``; its plain version is ``ops.pyramid.crop_patches``.
Bound by bytes: a copy of B*h*w texels (see the note in the source).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pyfaceanalysis_torch.ops.cuda_build import CudaLibrary, check_launch
from pyfaceanalysis_torch.ops.pyramid import crop_patches

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaLibrary("crop.cu", {
    "pfa_crop_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]})


def crop_patches_kernel(pyramid: torch.Tensor, crops: torch.Tensor,
                        patch_hw: Tuple[int, int] = (64, 64)
                        ) -> torch.Tensor:
    """(L, lh, lw) float32 pyramid, (B, 3) ``[level, y, x]`` -> (B, h, w).

    On a CUDA tensor this launches the kernel (or raises); on a CPU tensor
    it returns the plain version, ``ops.pyramid.crop_patches``."""
    if pyramid.device.type == "cpu":
        return crop_patches(pyramid, crops, patch_hw)
    if pyramid.device.type != "cuda":
        raise ValueError(f"no crop kernel for device {pyramid.device}")
    if pyramid.dtype != torch.float32 or pyramid.dim() != 3:
        raise ValueError("pyramid must be a (L, lh, lw) float32 tensor")
    if crops.dim() != 2 or crops.shape[1] != 3:
        raise ValueError("crops must be (B, 3)")
    if crops.device != pyramid.device:
        raise ValueError("crops and pyramid must be on the same device")
    L, lh, lw = pyramid.shape
    h, w = patch_hw
    if h > lh or w > lw:
        raise ValueError(f"patch {patch_hw} larger than the levels {lh}x{lw}")
    pyr = pyramid.contiguous()
    crops32 = crops.to(torch.int32).contiguous()
    B = crops32.shape[0]
    out = torch.empty((B, h, w), dtype=torch.float32, device=pyr.device)
    if B == 0:
        return out
    lib = KERNEL.lib()
    stream = torch.cuda.current_stream(pyr.device).cuda_stream
    rc = lib.pfa_crop_launch(pyr.data_ptr(), crops32.data_ptr(),
                             out.data_ptr(), B, L, lh, lw, h, w, stream)
    check_launch(rc, "crop kernel")
    KERNEL.launches += 1
    return out
