"""Synthetic grayscale scenes, version 1, rendered on the device from a seed.

A PyTorch rendering of the smoke test's synthetic scene, with the face
count and sizes as parameters: a smooth random texture (a coarse grid of
uniform values, bilinearly enlarged, plus fine noise) and drawn faces -- a
bright ellipse for the head, two dark eyes and a mouth -- each with its
own side, position and in-plane angle (uniform in +-15 degrees).

``layout`` places the faces:

- ``"free"``: centres uniform in ``[side, extent - side]``; heads may
  overlap;
- ``"cells"``: the image is cut into ``cells = [columns, rows]`` equal
  cells, one face in each, its centre uniform over the part of its cell
  where the head cannot leave the cell, so that heads never overlap.

Every draw comes from one ``torch.Generator`` on the rendering device, in
a few calls for the whole pool: the same seed and device give the same
scenes. This file is the generator of the mixes that name it; a changed
generator is a new file and a new mix.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

# Head half-axes and feature placement, in units of the face side.
HEAD_U, HEAD_V = 0.36, 0.47
EYE_X, EYE_Y, EYE_U, EYE_V = 0.16, -0.1, 0.07, 0.04
MOUTH_Y, MOUTH_U, MOUTH_V = 0.22, 0.13, 0.03
MAX_ANGLE = 15.0


def render(mix: dict, seed: int, n: int, device,
           chunk: int = 8) -> List[np.ndarray]:
    """``n`` scenes of ``mix`` (keys ``width``, ``height``, ``faces``,
    ``side``: [lo, hi], ``layout``, ``cells``) from ``seed``, rendered on
    ``device`` ``chunk`` at a time; returned on the host as (height,
    width) float32 arrays in [0, 1]."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    out: List[np.ndarray] = []
    while len(out) < n:
        m = min(chunk, n - len(out))
        out.extend(_render_chunk(mix, g, m, dev))
    return out


def _render_chunk(mix: dict, g: torch.Generator, n: int, dev
                  ) -> List[np.ndarray]:
    h, w = int(mix["height"]), int(mix["width"])
    k = int(mix["faces"])
    lo, hi = (float(v) for v in mix["side"])

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev, dtype=torch.float64)

    coarse = rand(n, h // 25 + 2, w // 25 + 2)
    yy = torch.linspace(0, coarse.shape[1] - 1.001, h, device=dev,
                        dtype=torch.float64)
    xx = torch.linspace(0, coarse.shape[2] - 1.001, w, device=dev,
                        dtype=torch.float64)
    y0, x0 = yy.long(), xx.long()
    ty, tx = (yy - y0)[:, None], (xx - x0)[None, :]
    c = coarse
    tex = ((c[:, y0][:, :, x0] * (1 - tx) + c[:, y0][:, :, x0 + 1] * tx)
           * (1 - ty)
           + (c[:, y0 + 1][:, :, x0] * (1 - tx) + c[:, y0 + 1][:, :, x0 + 1]
              * tx) * ty)
    img = 0.25 + 0.45 * tex + 0.05 * rand(n, h, w)

    side = lo + (hi - lo) * rand(n, k)
    ang = torch.deg2rad(-MAX_ANGLE + 2 * MAX_ANGLE * rand(n, k))
    pos = rand(n, k, 2)
    if mix.get("layout", "free") == "cells":
        cols, rows = (int(v) for v in mix["cells"])
        if cols * rows != k:
            raise ValueError(f"{cols}x{rows} cells for {k} faces")
        cw, ch = w / cols, h / rows
        reach = HEAD_V * hi               # the head's largest half-extent
        if 2 * reach > min(cw, ch):
            raise ValueError(f"faces of side {hi} do not fit {cw}x{ch} cells")
        j = torch.arange(k, device=dev)
        cx = (j % cols) * cw + reach + (cw - 2 * reach) * pos[..., 0]
        cy = (j // cols) * ch + reach + (ch - 2 * reach) * pos[..., 1]
    else:
        cx = side + (w - 2 * side) * pos[..., 0]
        cy = side + (h - 2 * side) * pos[..., 1]
    shade = 0.55 + 0.25 * rand(n, k)

    Y = torch.arange(h, device=dev, dtype=torch.float64)[:, None]
    X = torch.arange(w, device=dev, dtype=torch.float64)[None, :]
    for f in range(k):
        s = side[:, f, None, None]
        co = torch.cos(ang[:, f])[:, None, None]
        si = torch.sin(ang[:, f])[:, None, None]
        dx = X[None] - cx[:, f, None, None]
        dy = Y[None] - cy[:, f, None, None]
        u = dx * co + dy * si
        v = -dx * si + dy * co
        head = (u / (HEAD_U * s)) ** 2 + (v / (HEAD_V * s)) ** 2 <= 1
        img = torch.where(head, shade[:, f, None, None]
                          + 0.04 * rand(n, h, w), img)
        for ex in (-EYE_X, EYE_X):
            eye = (((u - ex * s) / (EYE_U * s)) ** 2
                   + ((v - EYE_Y * s) / (EYE_V * s)) ** 2) <= 1
            img = torch.where(eye, 0.12, img)
        mouth = ((u / (MOUTH_U * s)) ** 2
                 + ((v - MOUTH_Y * s) / (MOUTH_V * s)) ** 2) <= 1
        img = torch.where(mouth, 0.2, img)
    out = torch.clamp(img, 0.0, 1.0).to(torch.float32).cpu().numpy()
    return [out[i] for i in range(n)]
