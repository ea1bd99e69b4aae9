"""Network topology builders (the ``network_builder`` equivalent).

Port of ``pyfaceanalysis_tpu.models.builder``: the same layer specs, index
arrays included, for the same arguments.

Two topology families matching the roles of the reference's networks
(Pipelines/Pipeline_experimental.txt):

- :func:`build_higsfa` -- nonlinear hierarchical (G)SFA on square grayscale
  patches; the stand-in for "Non-Linear Ultra Thin 11 Layer Network"
  (64x64 detection/eye nets). Layer 1 tiles the image into small pixel
  fields; subsequent layers merge neighboring fields alternately along x
  and y until one field remains, each with a compressive expansion.
- :func:`build_pca_net` -- the linear counterpart ("linearPCANetworkU11L",
  96x96 age net): identical wiring, identity expansions, PCA nodes.

The wiring is OUR design (fixed field grids, pair merges); the reference's
exact MDP hinet layouts live in un-shipped pickles (SURVEY.md section 2.2:
``SavedNetworks/`` is absent), so topology parity is neither possible nor a
goal -- behavioral (label-range) parity is established by the trainer.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from pyfaceanalysis_torch.models.expansion import Expansion
from pyfaceanalysis_torch.models.network import HierarchicalNetwork, LayerSpec


def _tile_indices(h: int, w: int, fh: int, fw: int) -> np.ndarray:
    """(F, fh*fw) pixel indices tiling an (h, w) image into fh x fw fields,
    row-major field order."""
    gy, gx = h // fh, w // fw
    idx = np.arange(h * w).reshape(h, w)
    fields = []
    for y in range(gy):
        for x in range(gx):
            fields.append(idx[y * fh:(y + 1) * fh, x * fw:(x + 1) * fw].ravel())
    return np.asarray(fields, np.int32)


def _merge_indices(gy: int, gx: int, d: int, axis: str) -> np.ndarray:
    """Merge neighboring field pairs along ``axis`` ('x' or 'y').

    Previous layer: gy x gx fields of d outputs, flat index f*d + j with
    f = y*gx + x. Returns (F_new, 2*d) gather map.
    """
    fields = []
    if axis == "x":
        assert gx % 2 == 0
        for y in range(gy):
            for x in range(gx // 2):
                f0 = y * gx + 2 * x
                f1 = f0 + 1
                fields.append(np.concatenate([np.arange(f0 * d, f0 * d + d),
                                              np.arange(f1 * d, f1 * d + d)]))
    else:
        assert gy % 2 == 0
        for y in range(gy // 2):
            for x in range(gx):
                f0 = (2 * y) * gx + x
                f1 = (2 * y + 1) * gx + x
                fields.append(np.concatenate([np.arange(f0 * d, f0 * d + d),
                                              np.arange(f1 * d, f1 * d + d)]))
    return np.asarray(fields, np.int32)


def _as_tuple(a: np.ndarray) -> Tuple[Tuple[int, ...], ...]:
    return tuple(tuple(int(v) for v in row) for row in a)


def build_higsfa(input_side: int = 64, base_field: int = 4,
                 d: int = 14, top_dim: int = 20,
                 expansion: str = "spow", merge_expansion: str = "qt8",
                 node: str = "sfa") -> HierarchicalNetwork:
    """Nonlinear hierarchical SFA topology on (side, side) grayscale patches.

    For side=64, base_field=4: an 11-layer net -- L1 on 16x16 fields of 4x4
    pixels, then 8 alternating x/y pair merges down to 1x1, with compressive
    expansions throughout (the last two layers get progressively wider
    outputs, ending at ``top_dim``).
    """
    gy = gx = input_side // base_field
    specs: List[LayerSpec] = []
    specs.append(LayerSpec(
        _as_tuple(_tile_indices(input_side, input_side, base_field, base_field)),
        Expansion(expansion), d, node=node))
    dims = _merge_schedule(gy, gx, d, top_dim)
    prev_d = d
    exp = Expansion(merge_expansion)
    for (axis, out_d) in dims:
        idx = _merge_indices(gy, gx, prev_d, axis)
        if axis == "x":
            gx //= 2
        else:
            gy //= 2
        out_d = min(out_d, exp.output_dim(2 * prev_d))
        specs.append(LayerSpec(_as_tuple(idx), exp, out_d, node=node))
        prev_d = out_d
    return HierarchicalNetwork(tuple(specs), [], (input_side, input_side))


def _merge_schedule(gy: int, gx: int, d: int, top_dim: int
                    ) -> List[Tuple[str, int]]:
    """Alternating x/y merges until 1x1; output dims ramp to top_dim at the
    last two layers."""
    steps: List[Tuple[str, int]] = []
    axis = "x"
    while gy * gx > 1:
        if axis == "x" and gx > 1:
            steps.append(("x", d))
            gx //= 2
        elif gy > 1:
            steps.append(("y", d))
            gy //= 2
        else:
            steps.append(("x", d))
            gx //= 2
        axis = "y" if axis == "x" else "x"
    # Widen the final layers toward top_dim.
    if len(steps) >= 2:
        mid = (d + top_dim) // 2
        steps[-2] = (steps[-2][0], max(d, mid))
        steps[-1] = (steps[-1][0], top_dim)
    elif steps:
        steps[-1] = (steps[-1][0], top_dim)
    return steps


def build_pca_net(input_side: int = 96, base_field: int = 6,
                  d: int = 13, top_dim: int = 20,
                  node: str = "pca") -> HierarchicalNetwork:
    """Linear hierarchical topology (the age/race/gender feature net).

    ``node="pca"`` reproduces the reference's "linearPCANetworkU11L"
    variance-preserving behavior; ``node="sfa"`` keeps the same linear wiring
    but trains each layer with label-graph GSFA (LDA-like discriminative
    directions), which extracts attribute signals PCA buries.
    """
    gy = gx = input_side // base_field
    specs: List[LayerSpec] = []
    # PCA outputs are not whitened (variance = eigenvalue) -> no clipping;
    # GSFA outputs are whitened -> standard 4-sigma clip.
    clip = None if node == "pca" else 4.0
    specs.append(LayerSpec(
        _as_tuple(_tile_indices(input_side, input_side, base_field, base_field)),
        Expansion("identity"), d, node=node, clip=clip))
    dims = _merge_schedule(gy, gx, d, top_dim)
    prev_d = d
    for (axis, out_d) in dims:
        idx = _merge_indices(gy, gx, prev_d, axis)
        if axis == "x":
            gx //= 2
        else:
            gy //= 2
        out_d = min(out_d, 2 * prev_d)      # linear layer: at most its input
        specs.append(LayerSpec(_as_tuple(idx), Expansion("identity"),
                               out_d, node=node, clip=clip))
        prev_d = out_d
    return HierarchicalNetwork(tuple(specs), [], (input_side, input_side))
