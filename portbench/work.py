"""The work a request asks of the model and of the two CUDA kernels, as
fixed functions of the configuration, the image size and the faces
returned -- whatever implements them.

- :func:`flops_per_image`: the products of the HiGSFA networks
  (2 * fields * inputs * outputs per layer and row) and the Gaussian
  forms, for every real grid window at the row counts the plan and the
  compaction budgets give, then the eye and head networks for the faces
  returned.
- :func:`crop_bytes` and :func:`gather_bytes`: the least bytes of one
  call of each kernel on a fused batch: the distinct texels its samples
  read, once; every output pixel written once; the per-patch inputs.
  Both kernels are bound by bytes (the gather's affine map is ~12
  operations per output pixel, far under the bytes' time), so the least
  time of a call is its bytes over the card's HBM rate.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from portbench.reference.detect import Grid, Settings, bucket_size, plan
from portbench.reference.model import Model

# Bytes per patch of the gather's inputs: box (4 float32), angle
# (float32), level (int32).
GATHER_INPUT_BYTES = 24
# Bytes per crop-table row: [level, y, x] int32.
CROP_INPUT_BYTES = 12


def stage_rows(model: Model, s: Settings, n_real: int, images: int
               ) -> List[Tuple[int, int]]:
    """(real rows per image, rows of the fused call over ``images``) at
    each detection stage: the grid's windows until the first compaction
    rung, then at most ``mid_compact`` per image, then ``mid_compact2``."""
    n_per = n_real
    rows = bucket_size(images * n_real, s.bucket_sizes)
    rung1 = rung2 = False
    out = []
    for st, _ in plan(model):
        out.append((n_per, rows))
        if st.kind == "Disc":
            target = 0
            if st.serial < 5 and not rung1 and s.mid_compact:
                target, rung1 = s.mid_compact, True
            elif st.serial >= 5 and not rung2 and s.mid_compact2:
                target, rung2 = s.mid_compact2, True
            if target and target < n_per:
                n_per = target
                rows = images * target
    return out


def eye_rows_per_image(s: Settings, n_last: int) -> int:
    """Eye patches per image: both eyes of the best ``eye_max_faces``."""
    k = min(s.max_detections, n_last)
    return 2 * min(k, max(s.eye_max_faces, 8))


def network_flops(net) -> int:
    return sum(2 * f * k * o for f, k, o in net.products())


def flops_per_image(model: Model, s: Settings, grid: Grid,
                    faces: float) -> float:
    """Operations of the model for one image with ``faces`` faces
    returned (see the module docstring)."""
    total = 0.0
    for (st, _), (n, _) in zip(plan(model), stage_rows(model, s,
                                                       grid.n_real, 1)):
        if not st.reuses_features:
            total += n * network_flops(model.nets[st.network_name])
        total += n * model.clfs[model.stages.index(st)].flops_per_row()
    eye = (network_flops(model.net_of("EyeLX"))
           + model.clf("EyeLX").flops_per_row()
           + model.clf("EyeLY").flops_per_row())
    head = network_flops(model.net_of("Age")) + sum(
        model.clf(h).flops_per_row() for h in ("Age", "Race", "Gender"))
    return total + faces * (2 * eye + head)


def crop_texels(grid: Grid, patch_hw: Tuple[int, int]) -> int:
    """Distinct pyramid texels that the iter-0 crops of one image cover
    (the padding rows' crop [0, 0, 0] included)."""
    h, w = patch_hw
    L = len(grid.scales)
    lh, lw = grid.level_hw
    covered = np.zeros((L, lh, lw), bool)
    for lev, y, x in np.concatenate([grid.crops, [[0, 0, 0]]]):
        covered[lev, y:y + h, x:x + w] = True
    return int(covered.sum())


def crop_bytes(grid: Grid, s: Settings, images: int,
               patch_hw: Tuple[int, int]) -> int:
    """Least bytes of one crop call on a fused batch of ``images``."""
    rows = bucket_size(images * grid.n_real, s.bucket_sizes)
    return (images * crop_texels(grid, patch_hw) * 4
            + rows * patch_hw[0] * patch_hw[1] * 4 + rows * CROP_INPUT_BYTES)


def gather_bytes(model: Model, grid: Grid, s: Settings, images: int,
                 texels_per_image: Sequence[float],
                 patch_hw: Tuple[int, int]) -> List[float]:
    """Least bytes of each gather call of a fused batch, in launch order
    (the refinement extractions, then the eye pass). ``texels_per_image``
    gives, per call, the distinct texels one image's real rows read
    (counted by the reference on sampled images)."""
    calls = [r for i, ((_, ext), (_, r)) in enumerate(zip(
        plan(model), stage_rows(model, s, grid.n_real, images)))
        if ext and i > 0]
    n_last = stage_rows(model, s, grid.n_real, 1)[-1][0]
    calls.append(images * eye_rows_per_image(s, n_last))
    if len(texels_per_image) != len(calls):
        raise ValueError(f"{len(texels_per_image)} texel counts for "
                         f"{len(calls)} gather calls")
    levels = images * len(grid.scales)
    px = patch_hw[0] * patch_hw[1]
    return [images * t * 4 + r * px * 4 + r * GATHER_INPUT_BYTES + levels * 4
            for t, r in zip(texels_per_image, calls)]
