"""Per-patch contrast normalization.

Port of ``pyfaceanalysis_tpu.ops.contrast``:

1. ``contrast_normalize_avg_std`` (face_analysis.py:318-330): per-row
   recentering to a target mean/std with clipping to [0, 255]; the detection
   path calls it with (137.5, 0.40*255) when the model asks for it.
2. ``contrast_enhance_patches``: z-score each patch and map it to
   ``obj_avg + obj_std * z`` in [0, 1] pixel units without clipping (eye
   path: 0.11 / 0.15).

Standard deviations are population ones (ddof 0), as ``jnp.std``.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _row_mean_std(flat: torch.Tensor):
    row_mean = flat.mean(dim=1, keepdim=True)
    centered = flat - row_mean
    row_std = torch.sqrt((centered * centered).mean(dim=1, keepdim=True))
    return row_mean, row_std


def contrast_normalize_avg_std(patches: torch.Tensor, mean: float = 137.5,
                               std: float = 0.40 * 255.0,
                               clip_max: float = 255.0) -> torch.Tensor:
    """Row-wise mean/std normalization with clipping, [0, 255] pixel units
    (the reference divides by ``row_std / std + 1e-8``: the epsilon guards
    the ratio)."""
    flat = patches.reshape(patches.shape[0], -1)
    row_mean, row_std = _row_mean_std(flat)
    out = (flat - row_mean) / (row_std / std + 1e-8) + mean
    out = torch.clamp(out, 0.0, clip_max)
    return out.reshape(patches.shape)


def contrast_enhance_patches(patches: torch.Tensor, obj_avg: float = 0.0,
                             obj_std: float = 0.2) -> torch.Tensor:
    """"AgeContrastEnhancement_Avg_Std" equivalent in [0, 1] pixel units."""
    flat = patches.reshape(patches.shape[0], -1)
    row_mean, row_std = _row_mean_std(flat)
    out = (flat - row_mean) / (row_std + _EPS) * obj_std + obj_avg
    return out.reshape(patches.shape)
