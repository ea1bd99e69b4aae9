"""Rotated pyramid gather kernel: rotated patches from the scale pyramid.

Replaces ``pyfaceanalysis_tpu/ops/pallas_gather.py:sample_patches_pyramid``
(refinement-stage and eye patches) with the hand-written CUDA kernel
``csrc/gather.cu``; its plain version is
``ops.patches.sample_patches_pyramid_ref``. One call is one GPU launch: the
kernel reads scales, levels, boxes and angles as the caller holds them
(views with any strides, ``int32`` or ``int64`` levels) and computes each
patch's six affine coefficients itself, operation for operation as
``ops.patches.pyramid_affine`` specifies them, so the wrapper runs no
torch op on the card beyond allocating the output. Bound by bytes: 1 or 4
texels read and one float written per output pixel (see the note in the
source).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from pyfaceanalysis_torch.ops.cuda_build import CudaLibrary, check_launch
from pyfaceanalysis_torch.ops.patches import sample_patches_pyramid_ref

_P, _I, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaLibrary("gather.cu", {
    # pyr, scales, levels, boxes, angles, out; five element strides;
    # levels_are_64, B, L, lh, lw, oh, ow, bilinear; stream
    "pfa_gather_launch": [_P] * 6 + [_S] * 5 + [_I] * 8 + [_P],
    # scales, levels, boxes, angles, coeffs; five element strides;
    # levels_are_64, B, L, oh, ow; stream
    "pfa_gather_coeffs_launch": [_P] * 5 + [_S] * 5 + [_I] * 5 + [_P]})


def patch_inputs(scales: torch.Tensor, levels: torch.Tensor,
                 boxes: torch.Tensor, angles: torch.Tensor):
    """Checks the per-patch inputs and returns the kernel's view of them:
    four pointers, five element strides, whether levels are 64-bit."""
    B = boxes.shape[0]
    if boxes.shape != (B, 4) or levels.shape != (B,) or angles.shape != (B,):
        raise ValueError("boxes (B, 4), levels (B,) and angles (B,) differ")
    if scales.dim() != 1:
        raise ValueError("scales must be (L,)")
    for t in (scales, boxes, angles):
        if t.dtype != torch.float32:
            raise ValueError("scales, boxes and angles must be float32")
    if levels.dtype not in (torch.int32, torch.int64):
        raise ValueError("levels must be int32 or int64")
    for t in (levels, boxes, angles):
        if t.device != scales.device:
            raise ValueError("all inputs must be on the pyramid's device")
    return ((scales.data_ptr(), levels.data_ptr(), boxes.data_ptr(),
             angles.data_ptr()),
            (scales.stride(0), levels.stride(0), boxes.stride(0),
             boxes.stride(1), angles.stride(0)),
            int(levels.dtype == torch.int64))


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
    if (pyramid.dtype != torch.float32 or pyramid.dim() != 3
            or not pyramid.is_contiguous()):
        raise ValueError("pyramid must be a contiguous (L, lh, lw) float32 "
                         "tensor")
    if scales.device != pyramid.device or scales.shape[0] != pyramid.shape[0]:
        raise ValueError("scales must be (L,) on the pyramid's device")
    ptrs, strides, levels_are_64 = patch_inputs(scales, levels, boxes,
                                                angles)
    B = boxes.shape[0]
    L, lh, lw = pyramid.shape
    oh, ow = out_hw
    out = torch.empty((B, oh, ow), dtype=torch.float32, device=pyramid.device)
    if out.numel() == 0:
        return out
    lib = KERNEL.lib()
    stream = torch.cuda.current_stream(pyramid.device).cuda_stream
    rc = lib.pfa_gather_launch(pyramid.data_ptr(), *ptrs, out.data_ptr(),
                               *strides, levels_are_64, B, L, lh, lw, oh, ow,
                               int(method == "bilinear"), stream)
    check_launch(rc, "gather kernel")
    KERNEL.launches += 1
    return out


def kernel_affine(scales: torch.Tensor, levels: torch.Tensor,
                  boxes: torch.Tensor, angles: torch.Tensor,
                  out_hw: Tuple[int, int]) -> torch.Tensor:
    """(B, 6) coefficients as the gather kernel computes them on the card,
    for checks that hold them bit for bit against
    ``ops.patches.pyramid_affine``. Not on any path of the port and not
    counted as a launch of the gather."""
    if scales.device.type != "cuda":
        raise ValueError("kernel_affine runs the kernel's code: CUDA only")
    ptrs, strides, levels_are_64 = patch_inputs(scales, levels, boxes,
                                                angles)
    B = boxes.shape[0]
    coeffs = torch.empty((B, 6), dtype=torch.float32, device=scales.device)
    rc = KERNEL.lib().pfa_gather_coeffs_launch(
        *ptrs, coeffs.data_ptr(), *strides, levels_are_64, B,
        scales.shape[0], out_hw[0], out_hw[1],
        torch.cuda.current_stream(scales.device).cuda_stream)
    check_launch(rc, "gather coefficient kernel")
    return coeffs
