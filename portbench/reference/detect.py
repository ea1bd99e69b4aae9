"""The plain reference detector: one image at a time, in plain PyTorch.

A frozen, trimmed copy of the detector's plain path for one image, from
the grid down to the attribute heads:

- the all-scales window grid padded to its bucket, and the pyramid of the
  canvas (``face_analysis.py:575-669``);
- the 17-stage cascade over the window batch: the iter-0 crops, the
  rotated level-space samples of every later extraction, the HiGSFA
  networks, the Gaussian regressions, the box moves and gates, and both
  compaction rungs;
- the eye sub-cascade, the too-far gate, NMS (``face_analysis.py:186-221``)
  and the age/race/gender heads (``face_analysis.py:1170-1306``).

The crop and the rotated gather are the plain versions of the detector's
two CUDA kernels, so the reference samples the same texels the kernels
must. Products run at the precisions given to :class:`ReferenceDetector`
(see ``model.round_operand``); everything else is float32, host NMS and
frame arithmetic float64, as in the detector.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.reference.model import Model

DESIRED_SAMPLING = 0.825
EYE_SAMPLING = 2.3719
CANONICAL_DIST_EYES = 37.0
CANONICAL_TRIANGLE_HEIGHT = 42.0
REFERENCE_CUT_OFFS = (0.99, 0.95, 0.85, 0.8, 0.7, 0.6, 0.5, 0.45, 0.10, 0.05)
DESIRED_AREA = (CANONICAL_DIST_EYES * CANONICAL_TRIANGLE_HEIGHT / 2.0
                * (37.5 / CANONICAL_DIST_EYES) ** 2)
Z_SIZE = (260, 256)
AGE_SAMPLING = 1.14 * 160.0 / 96
AGE_TY = -6.0 / (160.0 / 96)


@dataclasses.dataclass(frozen=True)
class Settings:
    """The detector settings the reference reads, with the detector's
    defaults; ``None`` / -1 mean "the manifest decides"."""

    smallest_face: float = 0.20
    adaptive_grid_scale: bool = True
    patch_overlap_sampling: float = 1.1
    patch_overlap_posx_posy: float = 1.1
    tolerance_scale_deviation: float = 1.1
    tolerance_angle_deviation: float = 1.1
    tolerance_posxy_deviation: float = 1.1
    cut_offs_face: Optional[Tuple[float, ...]] = None
    last_cut_off_face: float = -1.0
    interpolation_formats: Tuple[str, ...] = ("nearest",) * 10
    estimate_age: bool = True
    estimate_gender: bool = True
    estimate_race: bool = True
    image_prescaling: bool = True
    prescale_size: int = 1000
    tolerance_xy_eye: float = -1.0
    eye_max_faces: int = 64
    eye_iters: int = 1
    arg_tta: int = 1
    arg_eyes: str = "pass1"
    detection_contrast_normalize: Optional[bool] = None
    purge_threshold: float = 0.25
    pang_gain: float = -1.0
    pos_gain: float = -1.0
    scale_gain: float = -1.0
    bucket_sizes: Tuple[int, ...] = (256, 512, 1024, 2048, 4096, 8192, 16384)
    max_detections: int = 256
    matmul_dtype: str = "bf16"
    mid_compact: int = 512
    mid_compact2: int = 256
    track_single_face: bool = False

    @staticmethod
    def resolve(fields: dict, calibration: dict) -> "Settings":
        """Settings from a configuration's fields (unknown ones ignored:
        they steer how the detector batches, not what it computes), with
        every "manifest decides" field filled from ``calibration``."""
        names = {f.name for f in dataclasses.fields(Settings)}
        kw = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in fields.items() if k in names}
        s = Settings(**kw)
        fill = {}
        if s.last_cut_off_face < 0 and "last_cut_off_face" in calibration:
            fill["last_cut_off_face"] = float(calibration["last_cut_off_face"])
        if s.cut_offs_face is None and "cut_offs_face" in calibration:
            fill["cut_offs_face"] = tuple(float(v)
                                          for v in calibration["cut_offs_face"])
        if s.detection_contrast_normalize is None:
            fill["detection_contrast_normalize"] = bool(
                calibration.get("detection_contrast_normalize", False))
        for gain in ("pang_gain", "pos_gain", "scale_gain"):
            if getattr(s, gain) < 0 and gain in calibration:
                fill[gain] = float(calibration[gain])
        if s.tolerance_xy_eye < 0:
            fill["tolerance_xy_eye"] = float(
                calibration.get("tolerance_xy_eye", 9.0))
        s = dataclasses.replace(s, **fill)
        if s.eye_iters != 1 or s.arg_tta != 1 or s.track_single_face:
            raise ValueError("the reference covers eye_iters 1, arg_tta 1 "
                             "and no tracking")
        return s

    def cut_offs(self) -> Tuple[float, ...]:
        cs = list(self.cut_offs_face if self.cut_offs_face is not None
                  else REFERENCE_CUT_OFFS)
        if self.last_cut_off_face >= 0:
            cs[9] = self.last_cut_off_face
        return tuple(cs)

    def gain(self, name: str) -> float:
        v = getattr(self, name)
        return v if v >= 0 else 1.0


def bucket_size(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return max(max(buckets), int(n))


def plan(model: Model) -> List[Tuple[object, bool]]:
    """(stage, extracts patches?) of every detection stage: the first
    stage extracts, and so does every later one with a network of its own
    that does not follow a Disc stage (a ``None*`` stage and a stage after
    a Disc stage read the patches or features before them)."""
    out, prev = [], None
    for i, st in enumerate(model.stages[:len(model.stages) - 5]):
        out.append((st, i == 0 or (prev != "Disc"
                                   and not st.reuses_features)))
        prev = st.kind
    return out


# -- grid ---------------------------------------------------------------------

class Grid:
    """The window grid of one image size: padded boxes and radii, the crop
    table of the iter-0 pyramid crops and the pyramid's ladder."""

    def __init__(self, im_w: int, im_h: int, geom, s: Settings):
        sw, sh = geom.subimage_width, geom.subimage_height
        min_side = min(im_h, im_w)
        min_box = max(20.0, min_side * s.smallest_face * DESIRED_SAMPLING
                      / geom.mins)
        value = min_box / sw
        samplings = []
        if not s.adaptive_grid_scale:
            samplings = [value]
        else:
            step = (geom.maxs / geom.mins) / s.patch_overlap_sampling
            while (sw * value * geom.mins / DESIRED_SAMPLING < im_w and
                   sh * value * geom.mins / DESIRED_SAMPLING < im_h):
                samplings.append(value)
                value *= step
        boxes, mdx, mdy, base, crops = [], [], [], [], []
        for k, sv in enumerate(samplings):
            pw, ph = sw * sv, sh * sv
            sep_x = geom.Dx * 2.0 * pw / geom.regression_width
            sep_y = geom.Dy * 2.0 * ph / geom.regression_height
            nx = math.ceil((1 + (im_w - pw) / sep_x)
                           * s.patch_overlap_posx_posy)
            ny = math.ceil((1 + (im_h - ph) / sep_y)
                           * s.patch_overlap_posx_posy)
            lx = np.round(np.linspace(0.0, im_w - pw, int(nx)) / sv
                          ).astype(np.int64)
            ly = np.round(np.linspace(0.0, im_h - ph, int(ny)) / sv
                          ).astype(np.int64)
            xx, yy = np.meshgrid(lx * sv, ly * sv)
            x0, y0 = xx.reshape(-1), yy.reshape(-1)
            boxes.append(np.stack([x0, y0, x0 + pw - 1.0, y0 + ph - 1.0], 1))
            n = len(x0)
            gx, gy = np.meshgrid(lx, ly)
            crops.append(np.stack([np.full(n, k), gy.reshape(-1),
                                   gx.reshape(-1)], axis=1))
            mdx.append(np.full(n, geom.Dx * pw / geom.regression_width))
            mdy.append(np.full(n, geom.Dy * ph / geom.regression_height))
            base.append(np.full(n, np.sqrt(pw ** 2 + ph ** 2)))
        self.samplings = samplings
        self.n_real = sum(len(b) for b in boxes)
        self.total = bucket_size(max(self.n_real, 1), s.bucket_sizes)
        cat = (lambda a: np.concatenate(a, 0)) if boxes else None
        self.boxes = cat(boxes) if boxes else np.zeros((0, 4))
        self.max_dx = cat(mdx) if boxes else np.zeros(0)
        self.max_dy = cat(mdy) if boxes else np.zeros(0)
        self.base_side = cat(base) if boxes else np.zeros(0)
        self.crops = cat(crops).astype(np.int32) if boxes else None
        self.scales: Optional[Tuple[float, ...]] = None
        self.level_hw: Optional[Tuple[int, int]] = None
        if samplings:
            s0 = min(min(samplings), 1.0)
            lh = max(int(np.ceil(im_h / s0)) + 2, sh + 2, 128)
            lw = max(int(np.ceil(im_w / s0)) + 2, sw + 2, 256)
            lh = -(-lh // 8) * 8
            lw = -(-lw // 128) * 128
            c = self.crops
            if not ((c[:, 1] < 0).any() or (c[:, 2] < 0).any()
                    or (c[:, 1] > lh - sh).any() or (c[:, 2] > lw - sw).any()):
                self.scales = tuple(float(v) for v in samplings) + (1.0,)
                self.level_hw = (lh, lw)

    def padded(self, a: np.ndarray, fill) -> np.ndarray:
        out = np.full((self.total,) + a.shape[1:], fill, a.dtype)
        out[:self.n_real] = a
        return out


# -- sampling -------------------------------------------------------------------

def build_pyramid(image: torch.Tensor, scales, level_hw) -> torch.Tensor:
    """(H, W) -> (L, lh, lw): nearest resize per ladder scale, top-left,
    zeros elsewhere; half-to-even rounding of the sample positions."""
    H, W = image.shape
    lh, lw = level_hw
    dev = image.device
    out = torch.zeros((len(scales), lh, lw), dtype=torch.float32, device=dev)
    for k, s in enumerate(scales):
        hk = min(lh, max(1, int(-(-H // s))))
        wk = min(lw, max(1, int(-(-W // s))))
        sy = torch.round((torch.arange(hk, dtype=torch.float32, device=dev)
                          + 0.5) * s - 0.5).to(torch.int64)
        sx = torch.round((torch.arange(wk, dtype=torch.float32, device=dev)
                          + 0.5) * s - 0.5).to(torch.int64)
        oky = (sy >= 0) & (sy < H)
        okx = (sx >= 0) & (sx < W)
        lvl = image[torch.clamp(sy, 0, H - 1)][:, torch.clamp(sx, 0, W - 1)]
        out[k, :hk, :wk] = torch.where(oky[:, None] & okx[None], lvl, 0.0)
    return out


def crop(pyramid: torch.Tensor, crops: torch.Tensor, hw) -> torch.Tensor:
    """(B, 3) [level, y, x] -> (B, h, w) crops, starts clamped."""
    L, lh, lw = pyramid.shape
    h, w = hw
    crops = crops.to(torch.int64)
    lev = torch.clamp(crops[:, 0], 0, L - 1)
    y = torch.clamp(crops[:, 1], 0, lh - h)
    x = torch.clamp(crops[:, 2], 0, lw - w)
    dev = pyramid.device
    rows = y[:, None] + torch.arange(h, device=dev)[None]
    cols = x[:, None] + torch.arange(w, device=dev)[None]
    return pyramid[lev[:, None, None], rows[:, :, None], cols[:, None, :]]


def _level_coords(scales, levels, boxes, angles, hw):
    """Level texel coordinates (lx, ly) of every output pixel: the affine
    map of the rotated box into its level, one float32 rounding per
    operation in the detector's order."""
    oh, ow = hw
    lev = torch.clamp(levels.to(torch.int64), 0, scales.shape[0] - 1)
    s_k = scales.to(torch.float32)[lev]
    x0, y0, x1, y1 = (boxes[:, i].to(torch.float32) for i in range(4))
    bw = x1 + 1.0 - x0
    bh = y1 + 1.0 - y0
    cx = x0 + bw * 0.5
    cy = y0 + bh * 0.5
    rad = torch.deg2rad(angles.to(torch.float32))
    co, si = torch.cos(rad), torch.sin(rad)
    c = torch.stack([co * bw / (ow * s_k), -si * bh / (oh * s_k),
                     (cx + co * (x0 - cx) - si * (y0 - cy)) / s_k - 0.5,
                     si * bw / (ow * s_k), co * bh / (oh * s_k),
                     (cy + si * (x0 - cx) + co * (y0 - cy)) / s_k - 0.5],
                    dim=1).contiguous()
    dev = boxes.device
    jj = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5)[None, None]
    ii = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5)[None, :,
                                                                  None]
    k = [c[:, i, None, None] for i in range(6)]
    return k[0] * jj + k[1] * ii + k[2], k[3] * jj + k[4] * ii + k[5]


def gather(pyramid, scales, levels, boxes, angles, hw, method="nearest",
           texels: Optional[list] = None, real=None) -> torch.Tensor:
    """Rotated boxes sampled from their own pyramid levels -> (B, h, w);
    out-of-level texels are 0. With ``texels`` (a list), the number of
    distinct in-level texels the ``real`` rows read is appended."""
    L, lh, lw = pyramid.shape
    lx, ly = _level_coords(scales, levels, boxes, angles, hw)
    lev = torch.clamp(levels.to(torch.int64), 0, L - 1)
    base = lev[:, None, None] * (lh * lw)
    flat = pyramid.reshape(-1)

    def tap(iy, ix):
        inb = (ix >= 0) & (ix < lw) & (iy >= 0) & (iy < lh)
        idx = base + torch.clamp(iy, 0, lh - 1) * lw + torch.clamp(ix, 0,
                                                                   lw - 1)
        return torch.where(inb, flat[idx], 0.0), idx, inb

    if method == "nearest":
        out, idx, inb = tap(torch.round(ly).to(torch.int64),
                            torch.round(lx).to(torch.int64))
        if texels is not None:
            keep = inb & real[:, None, None]
            texels.append(int(torch.unique(idx[keep]).numel()))
        return out
    if method != "bilinear":
        raise ValueError(f"unknown method {method!r}")
    fx0, fy0 = torch.floor(lx), torch.floor(ly)
    tx, ty = lx - fx0, ly - fy0
    ix0, iy0 = fx0.to(torch.int64), fy0.to(torch.int64)
    t = [tap(iy0 + a, ix0 + b)[0] for a in (0, 1) for b in (0, 1)]
    top = t[0] * (1.0 - tx) + t[1] * tx
    bot = t[2] * (1.0 - tx) + t[3] * tx
    return top * (1.0 - ty) + bot * ty


def canvas_gather(image, boxes, angles, hw, method="nearest"):
    """Rotated boxes sampled from the (H, W) canvas -> (B, h, w)."""
    H, W = image.shape
    oh, ow = hw
    dev = image.device
    flat = image.to(torch.float32).reshape(-1)
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
    px = cx[:, None, None] + c * du - s * dv - 0.5
    py = cy[:, None, None] + s * du + c * dv - 0.5

    def tap(iy, ix):
        inb = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        idx = torch.clamp(iy, 0, H - 1) * W + torch.clamp(ix, 0, W - 1)
        return torch.where(inb, flat[idx], 0.0)

    if method == "nearest":
        return tap(torch.round(py).to(torch.int64),
                   torch.round(px).to(torch.int64))
    ix0, iy0 = torch.floor(px), torch.floor(py)
    tx, ty = px - ix0, py - iy0
    ix0, iy0 = ix0.to(torch.int64), iy0.to(torch.int64)
    top = tap(iy0, ix0) * (1.0 - tx) + tap(iy0, ix0 + 1) * tx
    bot = tap(iy0 + 1, ix0) * (1.0 - tx) + tap(iy0 + 1, ix0 + 1) * tx
    return top * (1.0 - ty) + bot * ty


def _row_mean_std(flat):
    mean = flat.mean(dim=1, keepdim=True)
    c = flat - mean
    return mean, torch.sqrt((c * c).mean(dim=1, keepdim=True))


def contrast_normalize(flat, mean=137.5, std=0.40 * 255.0):
    m, s = _row_mean_std(flat)
    return torch.clamp((flat - m) / (s / std + 1e-8) + mean, 0.0, 255.0)


def contrast_enhance(flat, obj_avg, obj_std):
    m, s = _row_mean_std(flat)
    return (flat - m) / (s + 1e-8) * obj_std + obj_avg


# -- the detector -----------------------------------------------------------------

class ReferenceDetector:
    """Detects faces in one image at a time.

    ``cascade_precision`` is the cascade networks' product precision (the
    configuration's ``matmul_dtype`` unless the control lowers it);
    ``precision`` that of every other product (the eye and head networks
    and the Gaussian forms, float32 in the configuration)."""

    def __init__(self, model: Model, settings: Settings, device,
                 cascade_precision: Optional[str] = None,
                 precision: str = "f32"):
        self.model = model
        self.s = settings
        self.device = torch.device(device)
        self.cascade_precision = cascade_precision or settings.matmul_dtype
        self.precision = precision
        self.plan = plan(model)
        self._grids: Dict[Tuple[int, int], Grid] = {}
        # Distinct texels read by each gather call (``count_texels``).
        self.texels: Optional[List[int]] = None

    def grid(self, w: int, h: int) -> Grid:
        if (w, h) not in self._grids:
            self._grids[(w, h)] = Grid(w, h, self.model.face, self.s)
        return self._grids[(w, h)]

    def canvas(self, image: np.ndarray) -> torch.Tensor:
        """The image as the detector takes it: rounded to uint8, then
        padded into a square canvas of the prescale size, in [0, 1]."""
        u8 = np.clip(np.asarray(image) * 255.0, 0, 255).astype(np.uint8)
        side = self.s.prescale_size if self.s.image_prescaling else 2048
        h, w = u8.shape
        if h > side or w > side:
            side = int(-(-max(h, w) // 512) * 512)
        out = torch.zeros((side, side), dtype=torch.uint8, device=self.device)
        out[:h, :w] = torch.from_numpy(u8).to(self.device)
        return out.to(torch.float32) / 255.0

    @torch.no_grad()
    def detect(self, image: np.ndarray) -> List[dict]:
        """Detections of one (H, W) image in [0, 1], best first: dicts
        with ``box``, ``angle``, ``eye_left``, ``eye_right``,
        ``confidence`` and, where estimated, ``age``, ``age_std``,
        ``race_value`` and ``gender_value``."""
        s, m = self.s, self.model
        h, w = image.shape
        canvas = self.canvas(image)
        g = self.grid(w, h)
        if g.n_real == 0:
            return []
        block = self._cascade_and_eyes(canvas, g).cpu().numpy()
        rows = block[block[:, 10] > 0.5][:, :10]
        if len(rows) == 0:
            return []
        rows = purge(rows, s.purge_threshold)
        attrs = None
        if s.estimate_age or s.estimate_race or s.estimate_gender:
            attrs = self._heads(canvas, rows)
        out = []
        for j, r in enumerate(rows):
            d = dict(box=tuple(float(v) for v in r[0:4]), angle=float(r[4]),
                     eye_left=(float(r[5]), float(r[6])),
                     eye_right=(float(r[7]), float(r[8])),
                     confidence=float(r[9]))
            if attrs is not None:
                d.update(age=float(attrs[0][j]), age_std=float(attrs[1][j]),
                         race_value=float(attrs[2][j]),
                         gender_value=float(attrs[3][j]))
            out.append(d)
        return out

    def _cascade_and_eyes(self, canvas: torch.Tensor, g: Grid
                          ) -> torch.Tensor:
        s, m, dev = self.s, self.model, self.device
        geom = m.face
        hw = (geom.subimage_height, geom.subimage_width)

        def t(a):
            return torch.as_tensor(a, device=dev)

        boxes_p = g.padded(g.boxes.astype(np.float32), 1.0)
        r = dict(
            boxes=t(boxes_p),
            angles=torch.zeros(g.total, dtype=torch.float32, device=dev),
            mask=t(np.arange(g.total) < g.n_real),
            conf=torch.ones(g.total, dtype=torch.float32, device=dev),
            orig_cx=t((boxes_p[:, 0] + boxes_p[:, 2]) / 2.0),
            orig_cy=t((boxes_p[:, 1] + boxes_p[:, 3]) / 2.0),
            max_dx=t(g.padded(g.max_dx.astype(np.float32), 0.0)),
            max_dy=t(g.padded(g.max_dy.astype(np.float32), 0.0)),
            base_side=t(g.padded(g.base_side.astype(np.float32), 1.0)),
            real=t(np.arange(g.total) < g.n_real))
        pyramid = crops = scales = None
        first_serial = self.plan[0][0].serial
        if g.scales is not None and \
                s.interpolation_formats[first_serial] == "nearest":
            pyramid = build_pyramid(canvas, g.scales, g.level_hw)
            crops = t(g.padded(g.crops, 0))
            scales = torch.tensor(g.scales, dtype=torch.float32, device=dev)
            r["levels"] = crops[:, 0]
        cut_offs = s.cut_offs()
        min_ratio = geom.mins / DESIRED_SAMPLING
        max_ratio = geom.maxs / DESIRED_SAMPLING
        rung1 = rung2 = False
        patches = sl = None
        for si, (st, extract) in enumerate(self.plan):
            boxes, angles, mask = r["boxes"], r["angles"], r["mask"]
            if extract:
                interp = s.interpolation_formats[st.serial]
                if si == 0 and pyramid is not None:
                    patches = crop(pyramid, crops, hw)
                elif pyramid is not None and interp in ("nearest",
                                                        "bilinear"):
                    patches = gather(pyramid, scales, r["levels"], boxes,
                                     angles, hw, interp, self.texels,
                                     r["real"])
                else:
                    patches = canvas_gather(canvas, boxes, angles, hw, interp)
                patches = patches.reshape(patches.shape[0], -1)
                if s.detection_contrast_normalize:
                    patches = contrast_normalize(patches * 255.0) / 255.0
            if not st.reuses_features:
                sl = m.nets[st.network_name](patches, self.cascade_precision)
            clf = m.clfs[si]
            reg = clf.regression(sl[:, :clf.input_dim], self.precision)
            if st.kind == "Disc":
                r["conf"] = torch.where(mask, reg, r["conf"])
                mask = mask & (reg < cut_offs[st.serial])
            elif st.kind in ("PosX", "PosY"):
                a, b = (0, 2) if st.kind == "PosX" else (1, 3)
                ext = boxes[:, b] - boxes[:, a]
                size = (geom.regression_width if st.kind == "PosX"
                        else geom.regression_height)
                shift = s.gain("pos_gain") * reg * ext / size
                boxes = boxes.clone()
                boxes[:, a] -= shift
                boxes[:, b] -= shift
                drift = (boxes[:, a] + boxes[:, b]) / 2.0 - r[
                    "orig_cx" if st.kind == "PosX" else "orig_cy"]
                lim = r["max_dx" if st.kind == "PosX" else "max_dy"]
                mask = mask & (torch.abs(drift) <=
                               lim * s.tolerance_posxy_deviation)
            elif st.kind == "PAng":
                angles = angles + s.gain("pang_gain") * reg
                mask = mask & (torch.abs(angles) <=
                               geom.Dang * s.tolerance_angle_deviation)
            elif st.kind == "Scale":
                bw = boxes[:, 2] - boxes[:, 0]
                bh = boxes[:, 3] - boxes[:, 1]
                cx = (boxes[:, 2] + boxes[:, 0]) / 2.0
                cy = (boxes[:, 3] + boxes[:, 1]) / 2.0
                factor = (DESIRED_SAMPLING / torch.clamp(reg, min=1e-3)
                          ) ** s.gain("scale_gain")
                nw, nh = bw * factor, bh * factor
                boxes = torch.stack([cx - nw / 2, cy - nh / 2,
                                     cx + nw / 2, cy + nh / 2], dim=1)
                ratio = torch.sqrt(nw ** 2 + nh ** 2) / r["base_side"]
                mask = mask & (ratio <= max_ratio *
                               s.tolerance_scale_deviation)
                mask = mask & (ratio >= min_ratio /
                               s.tolerance_scale_deviation)
            else:
                raise ValueError(f"unknown stage kind {st.kind}")
            r["boxes"], r["angles"], r["mask"] = boxes, angles, mask
            if st.kind == "Disc":
                target = 0
                if st.serial < 5 and not rung1 and s.mid_compact:
                    target, rung1 = s.mid_compact, True
                elif st.serial >= 5 and not rung2 and s.mid_compact2:
                    target, rung2 = s.mid_compact2, True
                if target and target < mask.shape[0]:
                    rank = torch.where(mask, torch.clamp(r["conf"], 0.0,
                                                         1.999),
                                       torch.full_like(r["conf"], 2.0))
                    idx = torch.argsort(rank, stable=True)[:target]
                    r = {k: v[idx] for k, v in r.items()}
                    patches = patches[idx]
                    sl = sl[idx]
        return self._eyes(canvas, r, pyramid, scales)

    def _eyes(self, canvas, r, pyramid, scales) -> torch.Tensor:
        s, m = self.s, self.model
        k_out = min(s.max_detections, r["mask"].shape[0])
        eye_cap = min(k_out, max(s.eye_max_faces, 8))
        rank = torch.where(r["mask"], r["conf"],
                           torch.full_like(r["conf"], 2.0))
        idx = torch.argsort(rank, stable=True)[:k_out]
        boxes, angles = r["boxes"][idx], r["angles"][idx]
        conf, valid, real = r["conf"][idx], r["mask"][idx], r["real"][idx]
        l_boxes, r_boxes = approximate_eye_boxes(boxes, angles)
        eye_boxes = torch.cat([l_boxes[:eye_cap], r_boxes[:eye_cap]], 0)
        both = torch.cat([angles[:eye_cap], angles[:eye_cap]], 0)
        eye_real = torch.cat([real[:eye_cap], real[:eye_cap]], 0)
        new_boxes, max_reg = self._localize(canvas, eye_boxes, both,
                                            pyramid, scales, eye_real)
        l_new = torch.cat([new_boxes[:eye_cap], l_boxes[eye_cap:]], 0)
        r_new = torch.cat([new_boxes[eye_cap:], r_boxes[eye_cap:]], 0)
        too_far = max_reg >= s.tolerance_xy_eye
        bad = too_far[:eye_cap] | too_far[eye_cap:]
        bad = torch.cat([bad, torch.zeros(k_out - eye_cap, dtype=torch.bool,
                                          device=bad.device)], 0)
        valid = valid & torch.logical_not(bad)
        return torch.cat([boxes, angles[:, None],
                          (l_new[:, 0:2] + l_new[:, 2:4]) / 2.0,
                          (r_new[:, 0:2] + r_new[:, 2:4]) / 2.0,
                          conf[:, None], valid[:, None].to(torch.float32)], 1)

    def _localize(self, canvas, eye_boxes, angles, pyramid, scales, real):
        m = self.model
        g = m.eye
        hw = (g.subimage_height, g.subimage_width)
        if pyramid is not None:
            bw = torch.abs(eye_boxes[:, 2] - eye_boxes[:, 0]) + 1.0
            need = bw / 80.0
            cand = torch.where(scales[None, :] >= need[:, None],
                               scales[None, :],
                               torch.full_like(scales[None, :],
                                               float("inf")))
            lev = torch.argmin(cand, dim=1)
            no_cover = torch.isinf(cand.min(dim=1).values)
            levels = torch.where(no_cover, torch.argmax(scales),
                                 lev).to(torch.int32)
            patches = gather(pyramid, scales, levels, eye_boxes, angles, hw,
                             "nearest", self.texels, real)
            if bool(no_cover.any()):
                patches = torch.where(
                    no_cover[:, None, None],
                    canvas_gather(canvas, eye_boxes, angles, hw), patches)
        else:
            patches = canvas_gather(canvas, eye_boxes, angles, hw)
        flat = contrast_enhance(patches.reshape(patches.shape[0], -1),
                                0.11, 0.15)
        sl = m.net_of("EyeLX")(flat, self.precision)
        cx, cy = m.clf("EyeLX"), m.clf("EyeLY")
        reg_x = cx.regression(sl[:, :cx.input_dim], self.precision)
        reg_y = cy.regression(sl[:, :cy.input_dim], self.precision)
        max_reg = torch.maximum(torch.abs(reg_x), torch.abs(reg_y))
        box_w = torch.abs(eye_boxes[:, 2] - eye_boxes[:, 0])
        box_h = torch.abs(eye_boxes[:, 3] - eye_boxes[:, 1])
        off_x = (reg_x / EYE_SAMPLING) * box_w / hw[1]
        off_y = (reg_y / EYE_SAMPLING) * box_h / hw[0]
        rad = -torch.deg2rad(angles)
        dx = off_x * torch.cos(rad) - off_y * torch.sin(rad)
        dy = off_y * torch.cos(rad) + off_x * torch.sin(rad)
        return torch.stack([eye_boxes[:, 0] - dx, eye_boxes[:, 1] - dy,
                            eye_boxes[:, 2] - dx, eye_boxes[:, 3] - dy],
                           1), max_reg

    def _heads(self, canvas, rows: np.ndarray):
        """(age, age_std, race, gender) arrays of the purged rows."""
        m, dev = self.model, self.device
        centers, angles, sfs = frame_arrays(rows)
        centers = torch.as_tensor(centers, device=dev)
        angles = torch.as_tensor(angles, device=dev)
        sfs = torch.as_tensor(sfs, device=dev)
        patches = age_patches(canvas, centers, angles, sfs)
        flat = contrast_enhance(patches.reshape(patches.shape[0], -1),
                                0.0, 0.16)
        sl = m.net_of("Age")(flat, self.precision)
        ca, cr, cg = m.clf("Age"), m.clf("Race"), m.clf("Gender")
        n = len(rows)
        age_k, std_k = ca.regression(sl[:, :ca.input_dim], self.precision,
                                     estimate_std=True)
        race = cr.regression(sl[:, :cr.input_dim], self.precision)
        gender = cg.regression(sl[:, :cg.input_dim], self.precision)
        age_k = age_k.reshape(n, 1)
        age = age_k.mean(dim=1)
        var = (std_k.reshape(n, 1) ** 2 + age_k ** 2).mean(dim=1) - age ** 2
        std = torch.sqrt(torch.clamp(var, min=0.0))
        out = torch.stack([age, std, race, gender]).cpu().numpy()
        return out[0], out[1], out[2], out[3]


def approximate_eye_boxes(boxes, angles):
    """Left and right square eye boxes from face boxes and angles
    (``face_analysis.py:61-135``)."""
    x0, y0, x1, y1 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    fs = DESIRED_SAMPLING
    fc_x = (x0 + x1) / 2.0
    fc_y = (y0 + y1) / 2.0
    eye_dx = (CANONICAL_DIST_EYES / 2.0) * (torch.abs(x1 - x0) / 64.0) / (
        2 * fs)
    eye_dy = (CANONICAL_TRIANGLE_HEIGHT / 2.0) * (torch.abs(y1 - y0) / 64.0
                                                  ) / (2 * fs)
    bw = (torch.abs(x1 - x0) / (64.0 * 2 * fs)) * (64.0 * EYE_SAMPLING / 2.0)
    rad = angles * math.pi / 180.0
    c, s = torch.cos(rad), torch.sin(rad)
    el_x = fc_x - c * eye_dx + s * eye_dy
    el_y = fc_y - s * eye_dx - c * eye_dy
    er_x = fc_x + c * eye_dx + s * eye_dy
    er_y = fc_y + s * eye_dx - c * eye_dy
    left = torch.stack([el_x - bw / 2, el_y - bw / 2, el_x + bw / 2,
                        el_y + bw / 2], -1)
    right = torch.stack([er_x - bw / 2, er_y - bw / 2, er_x + bw / 2,
                         er_y + bw / 2], -1)
    return left, right


def purge(rows: np.ndarray, threshold: float = 0.25) -> np.ndarray:
    """The reference's NMS: order by (1 - conf) * inter-eye distance, keep
    rows whose least relative eye error against the kept ones exceeds
    ``threshold``."""
    rows = np.asarray(rows, np.float64)
    if len(rows) <= 1:
        return rows.copy()
    areas = np.sqrt((rows[:, 7] - rows[:, 5]) ** 2 +
                    (rows[:, 8] - rows[:, 6]) ** 2)
    weighted = (1.0 - rows[:, 9]) * areas
    weighted = weighted / max(weighted.max(), 1e-12)
    rows = rows[np.argsort(weighted)[::-1]]
    kept = [rows[0]]
    for row in rows:
        if min(relative_eye_error(row[5:9], k[5:9]) for k in kept) \
                > threshold:
            kept.append(row)
    return np.asarray(kept)


def relative_eye_error(a: np.ndarray, b: np.ndarray) -> float:
    """Larger eye distance between ``a`` and ``b`` over ``b``'s inter-eye
    distance (``face_analysis.py:158-165``)."""
    dl = np.sqrt(((b[0:2] - a[0:2]) ** 2).sum())
    dr = np.sqrt(((b[2:4] - a[2:4]) ** 2).sum())
    de = np.sqrt(((b[0:2] - b[2:4]) ** 2).sum())
    return max(dl, dr) / max(de, 1e-12)


def frame_arrays(rows: np.ndarray):
    """Z-frame centres, eye-line angles and source px per Z px of the rows'
    eyes (method eyes_inferred-mouth_areaZ, centred between the eyes and
    the inferred mouth), float64 on the host, returned as float32."""
    centers, angles, sfs = [], [], []
    r_tri = CANONICAL_TRIANGLE_HEIGHT / CANONICAL_DIST_EYES
    for row in rows:
        elx, ely, erx, ery = (float(v) for v in row[5:9])
        mx, my = (elx + erx) / 2.0, (ely + ery) / 2.0
        dist = np.hypot(erx - elx, ery - ely)
        angle = np.degrees(np.arctan2(ery - ely, erx - elx))
        imx = mx - r_tri * (ery - ely)
        imy = my + r_tri * (erx - elx)
        area = dist * np.hypot(mx - imx, my - imy) / 2.0
        sfs.append(float(np.sqrt(area / DESIRED_AREA) / 2.0))
        centers.append([(mx + imx) / 2.0, (my + imy) / 2.0])
        angles.append(angle)
    return (np.asarray(centers, np.float32), np.asarray(angles, np.float32),
            np.asarray(sfs, np.float32))


def age_patches(image, centers, angles, sfs) -> torch.Tensor:
    """(N, 96, 96) head inputs: the 96x96 crop of each face's Z frame,
    sampled bilinearly from the (H, W) image through the composed map."""
    H, W = image.shape
    dev = image.device
    zh, zw = Z_SIZE
    fr = zh / 2.0 - 96 * AGE_SAMPLING / 2.0
    fc = zw / 2.0 - 96 * AGE_SAMPLING / 2.0
    x0 = fc + 0.0 * AGE_SAMPLING
    y0 = fr + AGE_TY * AGE_SAMPLING
    ar = np.arange(96, dtype=np.float32)
    gx = torch.as_tensor(x0 + (ar + 0.5) * AGE_SAMPLING - 0.5
                         - (zw - 1) / 2.0, device=dev)
    gy = torch.as_tensor(y0 + (ar + 0.5) * AGE_SAMPLING - 0.5
                         - (zh - 1) / 2.0, device=dev)
    flat = image.reshape(-1)
    sf = sfs[:, None, None]
    u = gx[None, None, :] * sf
    v = gy[None, :, None] * sf
    rad = torch.deg2rad(angles)
    c = torch.cos(rad)[:, None, None]
    s = torch.sin(rad)[:, None, None]
    px = centers[:, 0, None, None] + c * u - s * v - 0.5
    py = centers[:, 1, None, None] + s * u + c * v - 0.5
    ix0, iy0 = torch.floor(px), torch.floor(py)
    tx, ty = px - ix0, py - iy0
    ix0, iy0 = ix0.to(torch.int64), iy0.to(torch.int64)

    def tap(iy, ix):
        inb = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        lin = torch.clamp(iy, 0, H - 1) * W + torch.clamp(ix, 0, W - 1)
        return torch.where(inb, flat[lin], 0.0)

    top = tap(iy0, ix0) * (1 - tx) + tap(iy0, ix0 + 1) * tx
    bot = tap(iy0 + 1, ix0) * (1 - tx) + tap(iy0 + 1, ix0 + 1) * tx
    return top * (1 - ty) + bot * ty

