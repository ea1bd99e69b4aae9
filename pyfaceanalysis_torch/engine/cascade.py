"""The masked, fixed-shape detection cascade -- the port's hot path.

Port of ``pyfaceanalysis_tpu.engine.cascade``. All scales of the window
grid form ONE patch batch; "discard" is a mask update, and the batch shrinks
only at the two mid-cascade compaction rungs. In fused multi-image mode the
windows of all images of a batch form that one batch
(:func:`make_batched_grid_state`), and the rungs keep rows per image. Each stage
extracts patches (or reuses the previous stage's features), runs a HiGSFA
network and a Gaussian soft-regression, and moves or gates the boxes:

- update rules:  face_analysis.py:803-840 (PosX/PosY shift by
                 -reg*extent/regression; PAng adds; Scale rescales about
                 the centre to desired_sampling 0.825)
- discard rules: face_analysis.py:842-887 (drift/cutoff tests against the
                 ORIGINAL grid box)
- Disc:          reg is "non-faceness"; reg >= cut_offs_face[serial] dies.

Patch extraction routes (``DetectorConfig.pallas_refine``, see
:func:`level_samplers`): the iter-0 grid is a set of aligned pyramid crops
(crop kernel or ``crop_patches``); refinement stages sample either the
canvas (``extract_patches_rotate``) or each window's own pyramid level
(gather kernel or its plain version).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pyfaceanalysis_torch.config import (
    DESIRED_SAMPLING,
    DetectorConfig,
    NetGeometry,
    bucket_size,
)
from pyfaceanalysis_torch.engine import grid as gridmod
from pyfaceanalysis_torch.io.pipeline import PipelineSpec
from pyfaceanalysis_torch.ops.contrast import contrast_normalize_avg_std
from pyfaceanalysis_torch.ops.cuda_crop import crop_patches_kernel
from pyfaceanalysis_torch.ops.cuda_gather import sample_patches_pyramid
from pyfaceanalysis_torch.ops.patches import (
    extract_patches_rotate,
    sample_patches_pyramid_ref,
)
from pyfaceanalysis_torch.ops.pyramid import crop_patches


class StagePlan(NamedTuple):
    """Static per-stage schedule entry."""

    kind: str           # Disc | PosX | PosY | PAng | Scale
    serial: int         # cut-off / interpolation index
    extract: bool       # extract patches at current boxes/angles?
    net_idx: int        # index into the network list (-1 = reuse features)
    clf_idx: int        # index into the classifier list
    input_dim: int      # feature truncation width for the classifier


def build_detection_plan(spec: PipelineSpec,
                         net_ids: Dict[str, int],
                         clf_input_dims: Sequence[int]
                         ) -> Tuple[StagePlan, ...]:
    """Reconstructs the extraction/execution schedule of the reference loop:
    extract at stage 0 and after any non-Disc stage with its own network;
    "None*" networks reuse the previous stage's features."""
    plan: List[StagePlan] = []
    prev_kind = None
    for i, st in enumerate(spec.detection_stages):
        reuse_net = st.reuses_features
        extract = (i == 0) or (prev_kind != "Disc" and not reuse_net)
        plan.append(StagePlan(
            kind=st.kind, serial=st.serial, extract=extract,
            net_idx=-1 if reuse_net else net_ids[st.network_name],
            clf_idx=i, input_dim=int(clf_input_dims[i])))
        prev_kind = st.kind
    return tuple(plan)


class GridPyramidInfo(NamedTuple):
    """Ladder scales + per-window crop origins for the pyramid path."""

    scales: Tuple[float, ...]
    level_hw: Tuple[int, int]
    crops: torch.Tensor         # (B, 3) int32 [level, y, x]


class CascadeState(NamedTuple):
    """Per-window cascade state ((B,) or (B, 4) tensors)."""

    boxes: torch.Tensor        # [x0, y0, x1, y1] inclusive
    angles: torch.Tensor       # degrees
    mask: torch.Tensor         # bool: still alive
    conf: torch.Tensor         # last Disc output ("non-faceness")
    orig_cx: torch.Tensor      # original grid box centre (drift reference)
    orig_cy: torch.Tensor
    max_dx: torch.Tensor       # acceptance radii (per scale -> per window)
    max_dy: torch.Tensor
    base_side: torch.Tensor    # original box diagonal
    # Per-window image index of a fused multi-image batch ((B,) int32;
    # padding rows carry the sentinel n_images); None for one image.
    img_idx: Optional[torch.Tensor] = None


def compacted_rows_per_image(plan: Tuple[StagePlan, ...],
                             cfg: DetectorConfig, n_per_image: int) -> int:
    """Rows per image that survive the mid-cascade compaction schedule --
    the SINGLE source of truth for the rung targets, mirrored exactly by
    ``run_cascade``'s in-loop logic (callers of the fused batch path need
    the final per-image group size to slice the output)."""
    n = n_per_image
    seen1 = seen2 = False
    for st in plan:
        if st.kind != "Disc":
            continue
        if st.serial < 5 and not seen1 and cfg.mid_compact:
            seen1 = True
            n = min(n, cfg.mid_compact)
        elif st.serial >= 5 and not seen2 and cfg.mid_compact2:
            seen2 = True
            n = min(n, cfg.mid_compact2)
    return n


def level_samplers(cfg: DetectorConfig, device: torch.device
                   ) -> Optional[Tuple[Callable, Callable]]:
    """``(crop, gather)`` of the level-space path for this config and
    device, or None for the canvas path.

    "off" -> None; "ref" -> the plain versions; "on" -> the kernel
    wrappers; "auto" -> the kernel wrappers on CUDA, None elsewhere (the
    JAX package's CPU path is the canvas gather)."""
    mode = cfg.pallas_refine
    if mode == "off" or (mode == "auto" and device.type != "cuda"):
        return None
    if mode == "ref":
        return crop_patches, sample_patches_pyramid_ref
    if mode in ("on", "auto"):
        return crop_patches_kernel, sample_patches_pyramid
    raise ValueError(f"unknown pallas_refine {mode!r}")


class Shard(NamedTuple):
    """One device's part of a cascade run: its rows of the window state and
    of the crop table, and its copies of the replicated inputs (see
    ``parallel.mesh.cascade_shards``)."""

    state: CascadeState
    crops: Optional[torch.Tensor]
    nets: Sequence
    clfs: Sequence
    image: torch.Tensor
    pyramid: Optional[torch.Tensor]
    pyr_scales: Optional[torch.Tensor]


# Per-row tensors a shard carries from stage to stage: the state's fields,
# the grid levels of the level-space route, the last patches and features.
_ROWS = CascadeState._fields + ("levels", "patches", "sl")


def _on(device: torch.device):
    """Makes ``device`` current while a shard's work is enqueued (the
    kernels launch on the current device)."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _gather(blocks: Sequence[Optional[torch.Tensor]]
            ) -> Optional[torch.Tensor]:
    """Per-shard row blocks -> all rows on the first block's device (the
    block itself for one shard)."""
    if len(blocks) == 1 or blocks[0] is None:
        return blocks[0]
    lead = blocks[0].device
    return torch.cat([b.to(lead) for b in blocks], dim=0)


def _take(rows: List[dict], idx: torch.Tensor,
          devices: Sequence[torch.device]) -> List[dict]:
    """The rows ``idx`` (global indices, on the first device, in order) of
    every per-row tensor, split again into contiguous blocks over
    ``devices``.

    One shard indexes its rows in place. Over several shards ``idx`` comes
    to the host (a few KB; the host waits for the device here), and each
    distinct device takes the rows of its blocks from every source block
    that holds some of them: one gather per source block, on the source's
    device, so that only chosen rows move; then, where several sources
    gave rows, one reordering. Its blocks are views of the result."""
    if len(rows) == 1:
        r = rows[0]
        return [{k: None if r[k] is None else r[k][idx] for k in _ROWS}]
    offsets = np.cumsum([0] + [r["mask"].shape[0] for r in rows])
    chosen = idx.cpu().numpy()
    src = np.searchsorted(offsets, chosen, side="right") - 1
    sizes = [len(p) for p in np.array_split(chosen, len(devices))]
    bounds = np.cumsum([0] + sizes)
    host: Dict[torch.device, list] = {}
    plans = []
    for dev in dict.fromkeys(devices):
        blocks = [j for j, d in enumerate(devices) if d == dev]
        pos = np.concatenate([np.arange(bounds[j], bounds[j + 1])
                              for j in blocks])
        # (source block, its local rows in output order, their positions)
        pieces = []
        for s in np.unique(src[pos]):
            p = pos[src[pos] == s]
            pieces.append((s, _stash(host, rows[s]["mask"].device,
                                     chosen[p] - offsets[s]), p))
        order = (_stash(host, dev, np.argsort(
            np.concatenate([p for _, _, p in pieces]), kind="stable"))
            if len(pieces) > 1 else None)
        plans.append((dev, blocks, pieces, order))
    # One copy of the host indices to each device.
    dev_idx = {d: torch.as_tensor(np.concatenate(a), device=d).split(
        [len(x) for x in a]) for d, a in host.items()}
    out: List[dict] = [{} for _ in devices]
    for dev, blocks, pieces, order in plans:
        for k in _ROWS:
            if rows[0][k] is None:
                full = None
            elif not pieces:
                full = rows[0][k][:0].to(dev)
            else:
                full = [rows[s][k][dev_idx[d][i]].to(dev)
                        for s, (d, i), _ in pieces]
                full = (full[0] if order is None else
                        torch.cat(full)[dev_idx[order[0]][order[1]]])
            split = (full.split([sizes[j] for j in blocks])
                     if full is not None else [None] * len(blocks))
            for j, t in zip(blocks, split):
                out[j][k] = t
    return out


def _stash(host: dict, device: torch.device, array: np.ndarray):
    """Queues a host index array for ``device``; returns its key."""
    arrs = host.setdefault(device, [])
    arrs.append(array)
    return device, len(arrs) - 1


def _stage_rows(st: StagePlan, si: int, shard: Shard, r: dict,
                geom: NetGeometry, cfg: DetectorConfig,
                patch_hw: Tuple[int, int], samplers, compute_dtype,
                cut_offs, min_scale_radio: float,
                max_scale_radio: float) -> None:
    """The row-parallel work of stage ``si`` on one shard's rows ``r``
    (updated in place): extraction, network, regression, box moves and
    gates."""
    boxes, angles, mask = r["boxes"], r["angles"], r["mask"]
    if st.extract:
        interp = cfg.interpolation_formats[st.serial]
        if si == 0 and shard.pyramid is not None:
            # Iter-0 grid: contiguous crops from the scale pyramid.
            crop = samplers[0] if samplers is not None else crop_patches
            patches = crop(shard.pyramid, shard.crops, patch_hw)
        elif samplers is not None and interp in ("nearest", "bilinear"):
            patches = samplers[1](shard.pyramid, shard.pyr_scales,
                                  r["levels"], boxes, angles, patch_hw,
                                  method=interp)
        else:
            patches = extract_patches_rotate(shard.image, boxes, angles,
                                             patch_hw, method=interp,
                                             image_idx=r["img_idx"])
        patches = patches.reshape(patches.shape[0], -1)
        if cfg.detection_contrast_normalize:
            # load_network_subimages(contrast_normalize=True): mean
            # 137.5 / std 0.4*255 in [0, 255] units; pixels are [0, 1].
            patches = contrast_normalize_avg_std(
                patches * 255.0, 137.5, 0.40 * 255.0) / 255.0
        r["patches"] = patches
    if st.net_idx >= 0:
        r["sl"] = shard.nets[st.net_idx](r["patches"],
                                         compute_dtype=compute_dtype)
    reg = shard.clfs[st.clf_idx].regression(r["sl"][:, :st.input_dim])

    if st.kind == "Disc":
        r["conf"] = torch.where(mask, reg, r["conf"])
        mask = mask & (reg < cut_offs[st.serial])
    elif st.kind == "PosX":
        width = boxes[:, 2] - boxes[:, 0]
        shift = (cfg.resolved_pos_gain() * reg * width
                 / geom.regression_width)
        boxes = boxes.clone()
        boxes[:, 0] -= shift
        boxes[:, 2] -= shift
        drift = (boxes[:, 0] + boxes[:, 2]) / 2.0 - r["orig_cx"]
        mask = mask & (torch.abs(drift) <=
                       r["max_dx"] * cfg.tolerance_posxy_deviation)
    elif st.kind == "PosY":
        height = boxes[:, 3] - boxes[:, 1]
        shift = (cfg.resolved_pos_gain() * reg * height
                 / geom.regression_height)
        boxes = boxes.clone()
        boxes[:, 1] -= shift
        boxes[:, 3] -= shift
        drift = (boxes[:, 1] + boxes[:, 3]) / 2.0 - r["orig_cy"]
        mask = mask & (torch.abs(drift) <=
                       r["max_dy"] * cfg.tolerance_posxy_deviation)
    elif st.kind == "PAng":
        angles = angles + cfg.resolved_pang_gain() * reg
        mask = mask & (torch.abs(angles) <=
                       geom.Dang * cfg.tolerance_angle_deviation)
    elif st.kind == "Scale":
        w = boxes[:, 2] - boxes[:, 0]
        h = boxes[:, 3] - boxes[:, 1]
        cx = (boxes[:, 2] + boxes[:, 0]) / 2.0
        cy = (boxes[:, 3] + boxes[:, 1]) / 2.0
        safe = torch.clamp(reg, min=1e-3)
        factor = (DESIRED_SAMPLING / safe) ** cfg.resolved_scale_gain()
        nw = w * factor
        nh = h * factor
        boxes = torch.stack([cx - nw / 2, cy - nh / 2,
                             cx + nw / 2, cy + nh / 2], dim=1)
        side = torch.sqrt(nw ** 2 + nh ** 2)
        ratio = side / r["base_side"]
        mask = mask & (ratio <= max_scale_radio *
                       cfg.tolerance_scale_deviation)
        mask = mask & (ratio >= min_scale_radio /
                       cfg.tolerance_scale_deviation)
    else:
        raise ValueError(f"unknown stage kind {st.kind}")
    r["boxes"], r["angles"], r["mask"] = boxes, angles, mask


def run_cascade(plan: Tuple[StagePlan, ...],
                nets: Sequence,                 # HierarchicalNetwork each
                geom: NetGeometry,
                cfg: DetectorConfig,
                patch_hw: Tuple[int, int],
                image: torch.Tensor,
                clfs: Sequence,                 # GaussianRegressor each
                state: CascadeState,
                pyramid: Optional[torch.Tensor] = None,
                crops: Optional[torch.Tensor] = None,
                pyr_scales: Optional[torch.Tensor] = None,
                collect_trace: bool = False,
                n_images: int = 1,
                n_per_image: int = 0):
    """Runs all detection stages on one padded window batch.

    With ``collect_trace`` the per-stage (boxes, angles, mask, conf)
    snapshots are returned too, and compaction is off so every grid window
    stays addressable.

    Fused multi-image mode (``n_images > 1``, requires ``state.img_idx``
    and ``n_per_image`` = real grid rows per image): one cascade over the
    windows of ALL images, every product ``n_images`` times taller.
    ``image`` is a (B, H, W) stack; a supplied ``pyramid`` must be the
    per-image pyramids concatenated along the level axis with ``crops``
    levels pre-folded (level' = img * L + level) and ``pyr_scales`` the
    ladder tiled per image, which keeps both kernels unchanged.
    Mid-cascade compaction is per image (each image keeps its own best
    ``mid_compact`` rows), preserving single-image semantics; rows stay
    grouped contiguously by image afterwards.
    """
    return run_cascade_shards(
        plan, geom, cfg, patch_hw,
        [Shard(state, crops, nets, clfs, image, pyramid, pyr_scales)],
        collect_trace=collect_trace, n_images=n_images,
        n_per_image=n_per_image)


def run_cascade_shards(plan: Tuple[StagePlan, ...], geom: NetGeometry,
                       cfg: DetectorConfig, patch_hw: Tuple[int, int],
                       shards: Sequence[Shard], collect_trace: bool = False,
                       n_images: int = 1, n_per_image: int = 0):
    """:func:`run_cascade` over row blocks on one or more devices.

    Each stage's row-parallel work runs per shard, on the shard's device
    and with its copies of the weights and the pyramid. The two compaction
    rungs see ALL rows: the rank (and image index) of every row goes to
    the first shard's device, one stable sort selects the rows as the
    unsharded cascade would, and the selected rows (state, levels,
    patches and features) are split over the shards again. The result is
    gathered on the first shard's device. One shard is the unsharded
    cascade, operation for operation."""
    trace = []
    cut_offs = cfg.resolved_cut_offs()
    min_scale_radio = geom.mins / DESIRED_SAMPLING
    max_scale_radio = geom.maxs / DESIRED_SAMPLING
    compute_dtype = torch.bfloat16 if cfg.matmul_dtype == "bf16" else None
    devices = [s.image.device for s in shards]
    # Refinement windows keep reading their ORIGINAL grid level; in fused
    # mode the caller folded the image index into it (stacked pyramid), so
    # the level-space path needs no image index. A one-image batch (the
    # tail chunk of a chunked batch) takes the same route: its folded
    # levels are the plain ones. (The JAX package sends that case to the
    # canvas; both CUDA kernels take it unchanged.)
    rows = [dict(s.state._asdict(), patches=None, sl=None,
                 levels=s.crops[:, 0] if s.crops is not None else None)
            for s in shards]
    samplers = (level_samplers(cfg, devices[0])
                if shards[0].pyramid is not None else None)
    fired_rung1 = fired_rung2 = False
    fused = n_images > 1 and rows[0]["img_idx"] is not None
    n_per_cur = n_per_image          # rows per image (fused mode only)

    for si, st in enumerate(plan):
        for shard, r in zip(shards, rows):
            with _on(shard.image.device):
                _stage_rows(st, si, shard, r, geom, cfg, patch_hw, samplers,
                            compute_dtype, cut_offs, min_scale_radio,
                            max_scale_radio)
        if st.kind == "Disc":
            # Mid-cascade compaction: after the first Disc gate and again
            # after Disc5, keep the best rows (alive first, then lowest
            # confidence; stable sort, as jnp.argsort), over all shards.
            target = 0
            if st.serial < 5 and not fired_rung1 and cfg.mid_compact:
                target, fired_rung1 = cfg.mid_compact, True
            elif st.serial >= 5 and not fired_rung2 and cfg.mid_compact2:
                target, fired_rung2 = cfg.mid_compact2, True
            cur_rows = (n_per_cur if fused
                        else sum(r["mask"].shape[0] for r in rows))
            if target and not collect_trace and target < cur_rows:
                ranks = []
                for r in rows:
                    rank = torch.where(r["mask"],
                                       torch.clamp(r["conf"], 0.0, 1.999),
                                       torch.full_like(r["conf"], 2.0))
                    if fused:
                        rank = rank + 4.0 * r["img_idx"].to(torch.float32)
                    ranks.append(rank)
                rank = _gather(ranks)
                if fused:
                    # Per-image rung: rows are grouped contiguously by
                    # image (n_per_cur each; padding carries the img_idx
                    # sentinel n_images and sorts last), so one stable
                    # composite-key sort yields each image's rows in a
                    # contiguous sorted block of exactly n_per_cur entries.
                    order = torch.argsort(rank, stable=True)
                    idx = order[:n_images * n_per_cur].reshape(
                        n_images, n_per_cur)[:, :target].reshape(-1)
                    n_per_cur = target
                else:
                    idx = torch.argsort(rank, stable=True)[:target]
                rows = _take(rows, idx, devices)

        if collect_trace:
            trace.append(tuple(_gather([r[k] for r in rows])
                               for k in ("boxes", "angles", "mask", "conf")))

    out = CascadeState(*(_gather([r[k] for r in rows])
                         for k in CascadeState._fields))
    if collect_trace:
        return out, tuple(trace)
    return out


def make_grid_state(im_width: int, im_height: int, geom: NetGeometry,
                    cfg: DetectorConfig, track: Optional[Tuple] = None,
                    device: torch.device = torch.device("cpu")
                    ) -> Tuple[CascadeState, int, Optional[GridPyramidInfo]]:
    """Builds the concatenated all-scales grid on ``device``, padded to the
    smallest configured bucket size (a copy of the JAX function's host
    arithmetic). Returns ``(state, n_real, pyr)``; ``pyr`` is None when a
    crop origin falls outside its level (tracking grids), in which case
    the cascade samples the canvas for iter 0 too."""
    face_found = track is not None
    samplings = gridmod.compute_sampling_values(
        im_width, im_height, geom, cfg.smallest_face,
        cfg.patch_overlap_sampling, cfg.adaptive_grid_scale,
        cfg.track_single_face, face_found, track)

    sw = geom.subimage_width
    sh = geom.subimage_height
    all_boxes, all_mdx, all_mdy, all_base, all_crops = [], [], [], [], []
    for k, s in enumerate(samplings):
        posX, posY, pw, ph, mdx, mdy = gridmod.compute_posX_posY_values(
            im_width, im_height, geom, s, cfg.patch_overlap_posx_posy,
            cfg.track_single_face, face_found, track)
        # Snap grid origins to integer LEVEL pixels (scale s) so iter-0
        # patches are contiguous pyramid crops.
        lx = np.round(np.asarray(posX) / s).astype(np.int64)
        ly = np.round(np.asarray(posY) / s).astype(np.int64)
        posX = lx * s
        posY = ly * s
        boxes = gridmod.compute_subimage_coordinates(posX, posY, pw, ph)
        n = len(boxes)
        gx, gy = np.meshgrid(lx, ly)
        all_crops.append(np.stack([np.full(n, k), gy.reshape(-1),
                                   gx.reshape(-1)], axis=1))
        all_boxes.append(boxes)
        all_mdx.append(np.full(n, mdx))
        all_mdy.append(np.full(n, mdy))
        all_base.append(np.full(n, np.sqrt(pw ** 2 + ph ** 2)))

    boxes = np.concatenate(all_boxes, axis=0) if all_boxes else np.zeros((0, 4))
    n_real = len(boxes)
    total = bucket_size(max(n_real, 1), cfg.bucket_sizes)

    def padded(a, fill=0.0):
        out = np.full((total,) + a.shape[1:], fill, a.dtype)
        out[:n_real] = a
        return out

    def dev(a):
        return torch.as_tensor(a, device=device)

    boxes_p = padded(boxes.astype(np.float32), fill=1.0)
    state = CascadeState(
        boxes=dev(boxes_p),
        angles=torch.zeros(total, dtype=torch.float32, device=device),
        mask=dev(np.arange(total) < n_real),
        conf=torch.ones(total, dtype=torch.float32, device=device),
        orig_cx=dev((boxes_p[:, 0] + boxes_p[:, 2]) / 2.0),
        orig_cy=dev((boxes_p[:, 1] + boxes_p[:, 3]) / 2.0),
        max_dx=dev(padded(np.concatenate(all_mdx).astype(np.float32))
                   if all_mdx else np.zeros(total, np.float32)),
        max_dy=dev(padded(np.concatenate(all_mdy).astype(np.float32))
                   if all_mdy else np.zeros(total, np.float32)),
        base_side=dev(padded(np.concatenate(all_base).astype(np.float32),
                             fill=1.0)
                      if all_base else np.ones(total, np.float32)),
    )

    pyr = None
    if samplings:
        # A NATIVE-resolution level (scale 1.0) follows the ladder: eye
        # boxes that need full detail sample it (engine.eyes).
        s0 = min(min(samplings), 1.0)
        # Level planes as the JAX package sizes them (its TPU kernels need
        # lh >= 128 & %8, lw >= 256 & %128); the padding is zeros, and the
        # same planes keep every crop and sample identical.
        lh = max(int(np.ceil(im_height / s0)) + 2, sh + 2, 128)
        lw = max(int(np.ceil(im_width / s0)) + 2, sw + 2, 256)
        lh = -(-lh // 8) * 8
        lw = -(-lw // 128) * 128
        crops_real = np.concatenate(all_crops, axis=0).astype(np.int32)
        # An origin outside [0, level - patch] would be clamped by the crop
        # and shift the patch off its box: use the canvas gather instead.
        if ((crops_real[:, 1] < 0).any() or (crops_real[:, 2] < 0).any()
                or (crops_real[:, 1] > lh - sh).any()
                or (crops_real[:, 2] > lw - sw).any()):
            return state, n_real, None
        crops = padded(crops_real)
        pyr = GridPyramidInfo(tuple(float(s) for s in samplings) + (1.0,),
                              (lh, lw), dev(crops))
    return state, n_real, pyr


def make_batched_grid_state(im_width: int, im_height: int, geom: NetGeometry,
                            cfg: DetectorConfig, n_images: int,
                            device: torch.device = torch.device("cpu")
                            ) -> Tuple[CascadeState, int,
                                       Optional[GridPyramidInfo]]:
    """Grid state for the FUSED multi-image cascade: the single-image grid
    tiled ``n_images`` times (contiguous per-image blocks) with a per-row
    image index, padded to a bucket. Padding rows carry the img_idx
    SENTINEL ``n_images`` so per-image compaction sorts them last
    (run_cascade fused mode).

    Returns ``(state, n_real_per_image, pyr)`` where ``pyr.crops`` levels
    are image-folded (level' = img * L + level) for the stacked pyramid
    (ops.pyramid.build_pyramid_batch) and ``pyr.scales`` is the
    single-image ladder (callers tile it).
    """
    state, n_real, pyr = make_grid_state(im_width, im_height, geom, cfg)
    if n_real == 0:
        return state, n_real, pyr
    # n_images == 1 goes through the tiling too: the fused cascade needs a
    # per-row img_idx, and one-image batches do reach it (the tail chunk
    # of a detect_batch split at max_fused_batch).
    total = bucket_size(n_images * n_real, cfg.bucket_sizes)

    def tile_pad(a: torch.Tensor, fill) -> torch.Tensor:
        a = a.numpy()[:n_real]
        out = np.full((total,) + a.shape[1:], fill, a.dtype)
        out[: n_images * n_real] = np.concatenate([a] * n_images, axis=0)
        return torch.as_tensor(out, device=device)

    img_idx = np.full(total, n_images, np.int32)
    img_idx[: n_images * n_real] = np.repeat(
        np.arange(n_images, dtype=np.int32), n_real)

    batched = CascadeState(
        boxes=tile_pad(state.boxes, 1.0),
        angles=torch.zeros(total, dtype=torch.float32, device=device),
        mask=torch.as_tensor(np.arange(total) < n_images * n_real,
                             device=device),
        conf=torch.ones(total, dtype=torch.float32, device=device),
        orig_cx=tile_pad(state.orig_cx, 1.0),
        orig_cy=tile_pad(state.orig_cy, 1.0),
        max_dx=tile_pad(state.max_dx, 0.0),
        max_dy=tile_pad(state.max_dy, 0.0),
        base_side=tile_pad(state.base_side, 1.0),
        img_idx=torch.as_tensor(img_idx, device=device),
    )
    if pyr is None:
        return batched, n_real, None
    L = len(pyr.scales)
    crops = pyr.crops.numpy()[:n_real]
    crops_p = np.zeros((total, 3), np.int32)
    crops_p[: n_images * n_real] = np.concatenate(
        [crops + np.array([b * L, 0, 0], np.int32) for b in range(n_images)],
        axis=0)
    return batched, n_real, GridPyramidInfo(
        pyr.scales, pyr.level_hw, torch.as_tensor(crops_p, device=device))
