#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--warm K]

Phases (any failure exits non-zero; nothing is caught and skipped):

1. Builds the CUDA kernels of ``pyfaceanalysis_torch/ops/csrc`` (one nvcc
   per source, started together) and prints ptxas' register/memory report.
2. Loads ``SavedNetworksTPU/`` onto the card, renders 1000x800 synthetic
   scenes from ``--seed`` (random texture plus a few drawn faces) and takes
   the kernels' inputs from them at the shapes of both paths: for one image
   the pyramid and grid crops, refinement-sized (512 and 256 rows) and
   eye-sized box batches (with out-of-level and coarse-level boxes); for a
   fused batch of 16 images the stacked pyramid with its folded crop
   levels and tiled scales (8,192 rows) and an eye batch with per-box
   image indices.
3. Holds each kernel against its plain PyTorch version on the card: crop
   exact (atol 0); gather nearest and bilinear within 1e-5, rounding ties
   excluded. The gather computes its affine coefficients itself, so the
   count of output pixels that differ at all is reported inside and outside
   the tie mask (outside must be 0), and the coefficients are held bit for
   bit against ``pyramid_affine``.
4. One image: ``FaceDetector(model, device="cuda").detect(img)`` with the
   attribute heads, launch counts set to 0 just before and read just
   after; fails if a kernel was not launched or an attribute is not
   finite. Again with ``pallas_refine="ref"`` (plain versions): the same
   detections (1e-3 px, 1e-4 confidence) and attributes (1e-3).
5. Fused batch: ``detect_batch`` of the scenes at the default config,
   counts set to 0 before and read after: one crop launch and one gather
   launch per refinement extraction and eye pass; the same through "ref"
   (no launch, equal detections); the async mode against sequential
   ``detect`` calls (equal); fused against sequential (f32 wire, at bf16
   and at float32 operands): the two drift apart on the card, so the
   counts, the share of faces found by both and their largest coordinate
   difference are reported and held to FUSED_VS_SEQUENTIAL_*. A batch of
   one image (the tail chunk of a chunked batch) must take the kernels
   too: 1 crop launch and as many gathers, equal to its "ref" route and
   to ``detect`` (equal shapes).
6. Stream: ``detect_stream`` over 4 batches (one ragged) in both forms,
   equal to ``detect_batch`` per batch, in order, with exactly the
   launches of three fused batches and nine single images.
7. Times: ``detect`` and ``detect_batch`` (host clock around a synchronised
   call, median of ``--warm`` runs; GPU launches, device busy time and idle
   share from a ``torch.profiler`` trace; peak device memory), and each
   kernel, its plain version and one PyTorch library call computing the
   same function, at the single-image and the fused shape, in device time
   (the sum of their GPU kernels' durations in a trace), beside the bound
   computed from this run's inputs (bytes over 3.35 TB/s HBM, or float32
   operations over 67 TFLOP/s). The same trace counts the GPU launches of
   one wrapper call: more than one fails.
8. The command line: ``pyfaceanalysis_torch.apps.detect.main`` on the same
   scenes, written as PNG files where PIL imports (the re-loaded 8-bit
   array is then the scene that is compared), else held in memory behind
   ``io.images.load_image``. Single-image mode with no ``--device`` (the
   default must be the card): the rows appended equal, byte for byte,
   ``write_detections`` of ``detect`` on the same array, and the call
   launches 1 crop and as many gathers as one cascade has. Batch mode over
   the 16 scenes (one shape group, one chunk, ``detect_stream``): each
   output file equals ``write_detections`` of ``detect_batch``, with the
   launches of one fused batch; a second run doubles every file.
   ``--coordinates_filename`` with a truth file made from scene 0's own
   detections: as many true positives as detections, no false positive or
   negative, one per-stage report line per plan stage. With PIL,
   ``--save_patches=1 --save_normalized_face_detections=1`` writes one
   file per detection in each folder. Prints one ``{"cli": {...}}`` line.

The last lines are one JSON object ``{"kernels": [...]}``, the output of
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` and the
result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM peaks (NVIDIA data sheet; at the 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# Fused batch against sequential detect calls on the card. A product 16
# times taller takes another cuBLAS kernel and rounds differently in the
# last bit; the default bf16 operand rounding turns such a bit into 2^-9 of
# an activation, and the nearest re-sampling of the next stage into texels,
# so single windows drift apart (PERF.md, Findings). Gate: faces found
# by both sides (same image, box centres within a quarter of the box side)
# must be at least this share of either side's detections, and agree
# within this many pixels (by operand type). Readings on an H100 at 700 W:
# share 0.9556; 2.32 px at bf16 operands, 0.42 px at float32 operands.
FUSED_VS_SEQUENTIAL_SHARE = 0.9
FUSED_VS_SEQUENTIAL_PX = {"bf16": 4.0, "f32": 1.0}
# Images of the fused batch: 8,192 window rows and 128 pyramid levels.
B = 16


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def synthetic_scene(seed: int, h: int = 800, w: int = 1000) -> np.ndarray:
    """(h, w) float32 in [0, 1]: smooth random texture plus a few drawn
    faces (bright ellipse, dark eyes and mouth) at random sizes."""
    rng = np.random.RandomState(seed)
    coarse = rng.rand(h // 25 + 2, w // 25 + 2)
    yy = np.linspace(0, coarse.shape[0] - 1.001, h)
    xx = np.linspace(0, coarse.shape[1] - 1.001, w)
    y0, x0 = yy.astype(int), xx.astype(int)
    ty, tx = (yy - y0)[:, None], (xx - x0)[None, :]
    c = coarse
    tex = ((c[y0][:, x0] * (1 - tx) + c[y0][:, x0 + 1] * tx) * (1 - ty)
           + (c[y0 + 1][:, x0] * (1 - tx) + c[y0 + 1][:, x0 + 1] * tx) * ty)
    img = 0.25 + 0.45 * tex + 0.05 * rng.rand(h, w)
    Y, X = np.mgrid[0:h, 0:w].astype(np.float64)
    for _ in range(5):
        side = rng.uniform(90, 220)
        cx = rng.uniform(side, w - side)
        cy = rng.uniform(side, h - side)
        ang = np.deg2rad(rng.uniform(-15, 15))
        u = (X - cx) * np.cos(ang) + (Y - cy) * np.sin(ang)
        v = -(X - cx) * np.sin(ang) + (Y - cy) * np.cos(ang)
        head = (u / (0.36 * side)) ** 2 + (v / (0.47 * side)) ** 2 <= 1
        img[head] = rng.uniform(0.55, 0.8) + 0.04 * rng.rand(head.sum())
        for ex in (-0.16, 0.16):
            eye = (((u - ex * side) / (0.07 * side)) ** 2
                   + ((v + 0.1 * side) / (0.04 * side)) ** 2) <= 1
            img[eye] = 0.12
        mouth = ((u / (0.13 * side)) ** 2
                 + ((v - 0.22 * side) / (0.03 * side)) ** 2) <= 1
        img[mouth] = 0.2
    return np.clip(img, 0.0, 1.0).astype(np.float32)


# A profiler session now and then comes back with only part of the device's
# records, mostly right after a session with thousands of launches
# (tools/torch_profiler_stress.py counts them), so a session is taken again
# this many times before its reading is given up.
PROFILER_ATTEMPTS = 4


def device_spans(torch, fn, calls: int, whole=None):
    """Durations (us) of the GPU kernels, copies and sets that ``calls``
    warm calls of ``fn`` run, by name, from a ``torch.profiler`` trace, and
    the host-clock time per call (ms) inside the trace. A trace without
    device records, or one that ``whole`` rejects, is taken again; ``None``
    in place of the durations when no attempt gave a usable trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, PROFILER_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / calls
        spans: dict = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                spans.setdefault(e.name, []).append(
                    e.time_range.elapsed_us())
        n_events = sum(len(d) for d in spans.values())
        if n_events and (whole is None or whole(spans)):
            return spans, wall
        print(f"profiler: attempt {attempt} of {PROFILER_ATTEMPTS} gave "
              f"{n_events} device records in {calls} calls, "
              f"{'an incomplete trace' if n_events else 'none'}; "
              f"{'again' if attempt < PROFILER_ATTEMPTS else 'given up'}")
    return None, wall


def device_ms(torch, fn, iters: int):
    """Device time per call of ``fn`` and its GPU launches per call: the
    GPU kernels, copies and sets that ``iters`` warm calls run, read from a
    ``torch.profiler`` trace, as the sum over kernel names of (mean
    duration x launches per call). Host launch overhead, which exceeds a
    microsecond-scale kernel, stays out of the time. Only a trace that
    holds the calls' records counts: each name a whole number of times per
    call, give or take the record that the profiler may drop at the edge
    of its window. Where the profiler gives no such trace, the time is
    the one between two CUDA events (``event_ms``, which for a kernel of a
    few microseconds reads the host's launch rate) and the launches per
    call are ``None``: not counted."""
    fn()
    torch.cuda.synchronize()

    def whole(sp):
        per_call = [round(len(d) / iters) for d in sp.values()]
        return any(per_call) and all(
            abs(len(d) - k * iters) <= max(1, iters // 10)
            for d, k in zip(sp.values(), per_call))

    spans, _ = device_spans(torch, fn, iters, whole)
    if spans is None:
        ms = event_ms(torch, fn, iters)
        print(f"profiler: no usable trace; {ms:.6f} ms/call is the time "
              f"between CUDA events around {iters} calls (host launch rate "
              f"included), GPU launches per call not counted")
        return ms, None
    us = sum(statistics.fmean(d) * round(len(d) / iters)
             for d in spans.values())
    return us / 1e3, sum(round(len(d) / iters) for d in spans.values())


def event_ms(torch, fn, iters: int) -> float:
    """Time per call of ``fn`` between two CUDA events around ``iters``
    back-to-back warm calls. For a kernel of a few microseconds this reads
    the host's launch rate, not the device time (see ``device_ms``)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(torch, fn, n: int):
    """Host-clock times of ``n`` warm synchronised calls of ``fn``."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def profile_path(torch, label: str, fn, n: int, images_per_call: int) -> dict:
    """Where a warm call of ``fn`` spends its time: wall time per call
    under ``torch.profiler``, the device's busy time (the summed durations
    of the GPU work; one stream, so they do not overlap), the idle share,
    GPU launches, all also per image, and the GPU kernels with the most
    device time. Busy time and launches are ``None`` (not measured) where
    the profiler gave no device records in any attempt."""
    spans, wall = device_spans(torch, fn, n)
    m = images_per_call
    if spans is None:
        print(f"{label} under the profiler: wall {wall:.3f} ms/call "
              f"({wall / m:.3f} ms per image of {m}); device busy time, "
              f"idle share and GPU launches not measured")
        return {"wall_ms": wall, "busy_ms": None, "launches": None}
    by_name = {name: sum(d) / 1e3 / n for name, d in spans.items()}
    count = sum(len(d) for d in spans.values())
    busy = sum(by_name.values())
    print(f"{label} under the profiler: wall {wall:.3f} ms/call, device "
          f"busy {busy:.3f} ms/call, idle share {1 - busy / wall:.4f}, "
          f"{count / n:.0f} GPU launches/call; per image ({m}): wall "
          f"{wall / m:.3f} ms, device busy {busy / m:.3f} ms, "
          f"{count / n / m:.1f} GPU launches")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  device {ms:.4f} ms/call  {name[:100]}")
    return {"wall_ms": wall, "busy_ms": busy, "launches": count / n}


def tie_mask(torch, coeffs, out_hw):
    """Output pixels whose level coordinate lies within 1e-4 of a .5
    rounding tie (nearest may legally round either way there)."""
    from pyfaceanalysis_torch.ops.patches import level_coords
    lx, ly = level_coords(coeffs, out_hw)
    return (((lx - torch.floor(lx) - 0.5).abs() < 1e-4)
            | ((ly - torch.floor(ly) - 0.5).abs() < 1e-4))


def check_gather(torch, name, pyramid, scales, lv, bx, an, shapes) -> float:
    """Holds the gather kernel against ``pyramid_affine`` (coefficients,
    bit for bit) and ``sample_patches_pyramid_ref`` (pixels) on one batch;
    returns the largest pixel error outside rounding ties."""
    from pyfaceanalysis_torch.ops import cuda_gather
    from pyfaceanalysis_torch.ops.patches import (
        pyramid_affine,
        sample_patches_pyramid_ref,
    )
    worst = 0.0
    for hw, methods in shapes:
        want_c = pyramid_affine(scales, lv, bx, an, hw)
        got_c = cuda_gather.kernel_affine(scales, lv, bx, an, hw)
        n_coeff = int((got_c.view(torch.int32)
                       != want_c.view(torch.int32)).sum())
        print(f"check gather {name} B={bx.shape[0]} {hw[0]}x{hw[1]} "
              f"levels {str(lv.dtype).split('.')[-1]} stride "
              f"{lv.stride(0)}: {n_coeff} of {want_c.numel()} in-kernel "
              f"coefficients differ in any bit from pyramid_affine")
        if n_coeff:
            fail(f"in-kernel affine coefficients differ ({name} {hw})")
        ties = tie_mask(torch, want_c, hw)
        n_tie = int(ties.sum())
        for method in methods:
            got = cuda_gather.sample_patches_pyramid(
                pyramid, scales, lv, bx, an, hw, method=method)
            want = sample_patches_pyramid_ref(pyramid, scales, lv, bx, an,
                                              hw, method=method)
            torch.cuda.synchronize()
            diff = (got - want).abs()
            n_in = int(((got != want) & ties).sum())
            n_out = int(((got != want) & ~ties).sum())
            if method == "nearest":
                diff = torch.where(ties, 0.0, diff)
            err = float(diff.max())
            nz = int((want != 0).sum())
            print(f"check gather {name} B={bx.shape[0]} {hw[0]}x{hw[1]} "
                  f"{method}: max_abs_err {err} (atol 1e-5; nearest: "
                  f"{n_tie} tie pixels excluded), pixels that differ at "
                  f"all: {n_in} inside the tie mask, {n_out} outside, "
                  f"{nz} nonzero samples")
            if not err <= 1e-5:
                fail(f"gather kernel differs ({name} {hw} {method})")
            if n_out:
                fail(f"{n_out} pixels outside the tie mask differ "
                     f"({name} {hw} {method})")
            if nz == 0:
                fail(f"the gather check {name} sampled nothing")
            worst = max(worst, err)
            del got, want, diff
    return worst


def time_crop(torch, label, pyramid, crops, iters) -> dict:
    """Device time of the crop kernel, its plain version and one library
    call (advanced indexing) on these crops, and the bound from their
    bytes: the distinct texels the windows cover read once (grid windows
    overlap, so this is far less than one read per output pixel), every
    output pixel written once, plus the crop table."""
    from pyfaceanalysis_torch.ops import cuda_crop
    from pyfaceanalysis_torch.ops.pyramid import crop_patches
    dev = pyramid.device
    B = crops.shape[0]
    idx = (crops[:, 0].long()[:, None, None],
           (crops[:, 1].long()[:, None]
            + torch.arange(64, device=dev))[:, :, None],
           (crops[:, 2].long()[:, None]
            + torch.arange(64, device=dev))[:, None, :])
    covered = torch.zeros(pyramid.shape, dtype=torch.bool, device=dev)
    covered[idx] = True
    texels = int(covered.sum())
    del covered
    n_bytes = texels * 4 + B * 64 * 64 * 4 + B * 3 * 4
    ms, n = device_ms(torch, lambda: cuda_crop.crop_patches_kernel(
        pyramid, crops, (64, 64)), iters)
    plain, _ = device_ms(torch, lambda: crop_patches(pyramid, crops,
                                                     (64, 64)), iters // 2)
    lib, _ = device_ms(torch, lambda: pyramid[idx], iters // 2)
    ev = event_ms(torch, lambda: cuda_crop.crop_patches_kernel(
        pyramid, crops, (64, 64)), iters)
    bound = n_bytes / HBM_BYTES_PER_S * 1e3
    print(f"crop {label} B={B} 64x64 from {tuple(pyramid.shape)}: device "
          f"{ms:.6f} ms in {n} GPU launches per call (plain version "
          f"{plain:.6f} ms, pyramid[idx] {lib:.6f} ms), CUDA events "
          f"{ev:.6f} ms/call, bound {bound:.6f} ms by bytes ({texels} "
          f"distinct texels read; one read per output pixel would be "
          f"{(2 * B * 64 * 64 * 4 + B * 3 * 4) / HBM_BYTES_PER_S * 1e3:.6f} "
          f"ms)")
    if n is not None and n > 1:
        fail(f"one crop wrapper call ({label}) made {n} GPU launches")
    return {"rows": B, "ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": lib, "launches_per_call": n}


def time_gather(torch, label, pyramid, scales, lv, bx, an, iters) -> dict:
    """Device time of the gather kernel (nearest 64x64, as both paths run
    it), its plain version and one library call (a 3-D ``grid_sample`` over
    the stacked levels with the grid precomputed), and the bound from this
    batch: bytes = distinct texels the samples read + the outputs + the
    per-patch inputs; operations = ~12 flops of the affine map per output
    pixel plus ~60 per patch for its coefficients."""
    from pyfaceanalysis_torch.ops import cuda_gather
    from pyfaceanalysis_torch.ops.patches import (
        level_coords,
        pyramid_affine,
        sample_patches_pyramid_ref,
    )
    hw = (64, 64)
    L, lh, lw = pyramid.shape
    B = bx.shape[0]
    coeffs = pyramid_affine(scales, lv, bx, an, hw)
    lx, ly = level_coords(coeffs, hw)
    ix, iy = torch.round(lx).long(), torch.round(ly).long()
    inb = (ix >= 0) & (ix < lw) & (iy >= 0) & (iy < lh)
    lev = torch.clamp(lv.long(), 0, L - 1)
    flat_idx = (lev[:, None, None] * lh + iy) * lw + ix
    texels = int(torch.unique(flat_idx[inb]).numel())
    del ix, iy, inb, flat_idx
    n_out = B * hw[0] * hw[1]
    g_bytes = texels * 4 + n_out * 4 + B * (4 * 4 + 4 + 4) + L * 4
    g_flops = 12 * n_out + 60 * B
    t_bytes, t_flops = g_bytes / HBM_BYTES_PER_S, g_flops / FP32_FLOPS_PER_S
    ms, n = device_ms(torch, lambda: cuda_gather.sample_patches_pyramid(
        pyramid, scales, lv, bx, an, hw), iters)
    if n is not None and n > 1:
        fail(f"one gather wrapper call ({label}) made {n} GPU launches")
    plain, plain_n = device_ms(torch, lambda: sample_patches_pyramid_ref(
        pyramid, scales, lv, bx, an, hw), max(iters // 4, 3))
    # align_corners maps -1..1 to texel centres 0..n-1; the level axis
    # lands exactly on a level.
    grid = torch.stack([lx / (lw - 1) * 2 - 1, ly / (lh - 1) * 2 - 1,
                        (lev.float()[:, None, None] / (L - 1) * 2 - 1
                         ).expand_as(lx)], dim=-1)[None]
    del lx, ly
    vol = pyramid[None, None]
    lib, _ = device_ms(torch, lambda: torch.nn.functional.grid_sample(
        vol, grid, mode="nearest", padding_mode="zeros",
        align_corners=True), max(iters // 2, 3))
    ev = event_ms(torch, lambda: cuda_gather.sample_patches_pyramid(
        pyramid, scales, lv, bx, an, hw), iters)
    bound, by = ((t_bytes, "bytes") if t_bytes >= t_flops
                 else (t_flops, "operations"))
    print(f"gather {label} B={B} 64x64 nearest from {tuple(pyramid.shape)}: "
          f"device: wrapper {ms:.6f} ms in {n} GPU launch per call (plain "
          f"version {plain:.6f} ms in {plain_n}), grid_sample {lib:.6f} ms, "
          f"bound {bound * 1e3:.6f} ms by {by} ({texels} distinct texels "
          f"read); CUDA events {ev:.6f} ms/call (wrapper)")
    return {"rows": B, "ms": ms, "plain_ms": plain, "bound_ms": bound * 1e3,
            "bound_by": by, "library_ms": lib, "launches_per_call": n}


def det_rows(dets, attributes: bool = False) -> np.ndarray:
    cols = 14 if attributes else 10
    return np.asarray(
        [(*d.box, d.angle, *d.eye_left, *d.eye_right, d.confidence)
         + ((d.age, d.age_std, d.race_value, d.gender_value)
            if attributes else ()) for d in dets],
        np.float64).reshape(-1, cols)


def compare_lists(label, got, want, px_tol, conf_tol=1e-4, attr_tol=None):
    """Per-image detection lists ``got`` against ``want``: equal counts,
    coordinates within ``px_tol``, confidence within ``conf_tol`` and, when
    ``attr_tol`` is given, finite attributes within it. Prints and returns
    the largest coordinate difference."""
    if len(got) != len(want):
        fail(f"{label}: {len(got)} result lists, expected {len(want)}")
    dpx = dconf = dattr = 0.0
    n = 0
    for i, (g, w) in enumerate(zip(got, want)):
        a = det_rows(g, attr_tol is not None)
        b = det_rows(w, attr_tol is not None)
        if a.shape != b.shape:
            fail(f"{label}: image {i} has {len(a)} detections, expected "
                 f"{len(b)}")
        if not (np.isfinite(a).all() and np.isfinite(b).all()):
            fail(f"{label}: non-finite values in image {i}")
        if len(a):
            dpx = max(dpx, float(np.abs(a[:, :9] - b[:, :9]).max()))
            dconf = max(dconf, float(np.abs(a[:, 9] - b[:, 9]).max()))
            if attr_tol is not None:
                dattr = max(dattr, float(np.abs(a[:, 10:] - b[:, 10:]).max()))
        n += len(a)
    print(f"{label}: {n} detections in {len(got)} images on both sides, "
          f"max |d coord| {dpx} px (tol {px_tol}), max |d conf| {dconf} "
          f"(tol {conf_tol})"
          + ("" if attr_tol is None
             else f", max |d attribute| {dattr} (tol {attr_tol})"))
    if dpx > px_tol or dconf > conf_tol or (attr_tol is not None
                                            and dattr > attr_tol):
        fail(f"{label}: results differ")
    return dpx


def compare_drift(label, got, want, min_share, px_tol) -> dict:
    """Per-image detection lists of two runs that may drift apart: pairs
    detections of the same image whose box centres lie within a quarter of
    the box side, prints counts, the share found by both and the largest
    coordinate difference among the pairs, and fails below ``min_share`` or
    above ``px_tol``."""
    n_got = n_want = paired = unequal = exact = 0
    dpx = 0.0
    for g, w in zip(got, want):
        a, b = det_rows(g), det_rows(w)
        n_got, n_want = n_got + len(a), n_want + len(b)
        unequal += len(a) != len(b)
        free = list(range(len(a)))
        for r in b:
            centre = np.array([(r[0] + r[2]) / 2, (r[1] + r[3]) / 2])
            dist = [np.hypot(*(np.array([(a[j][0] + a[j][2]) / 2,
                                         (a[j][1] + a[j][3]) / 2]) - centre))
                    for j in free]
            if dist and min(dist) < 0.25 * (r[2] - r[0]):
                j = free.pop(int(np.argmin(dist)))
                d = float(np.abs(a[j][:9] - r[:9]).max())
                dpx, paired, exact = max(dpx, d), paired + 1, exact + (d <= 1e-3)
    share = paired / max(n_got, n_want, 1)
    print(f"{label}: {n_got} vs {n_want} detections in {len(want)} images "
          f"({unequal} images with unequal counts), {paired} found by both "
          f"(share {share:.4f}, gate {min_share}), {exact} of them within "
          f"1e-3 px, max |d coord| among them {dpx} px (gate {px_tol})")
    if len(got) != len(want) or share < min_share or dpx > px_tol:
        fail(f"{label}: results differ beyond the stated drift")
    return {"got": n_got, "want": n_want, "paired": paired, "exact": exact,
            "max_px": dpx}


def run_cli(argv) -> str:
    """``apps.detect.main`` on ``argv`` and the shipped artifact directory,
    with what it prints captured, echoed with a prefix and returned; fails
    on another return code than 0."""
    from pyfaceanalysis_torch.apps import detect as cli
    argv = ["--pipeline_dir=" + os.path.join(ROOT, "SavedNetworksTPU"), *argv]
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = cli.main(argv)
    for line in text.getvalue().splitlines():
        print(f"cli| {line}")
    if rc != 0:
        fail(f"apps.detect.main({argv}) returned {rc}")
    return text.getvalue()


def own_rows(tmp, name, dets, cfg) -> bytes:
    """The bytes ``write_detections`` makes of ``dets`` under ``cfg``'s
    switches, as ``apps.detect`` passes them."""
    from pyfaceanalysis_torch.io import writers
    path = os.path.join(tmp, name)
    writers.write_detections(
        path, dets, right_screen_eye_first=cfg.right_screen_eye_first,
        write_age_race_gender_confidence=(
            cfg.write_age_race_gender_confidence and cfg.estimate_age))
    with open(path, "rb") as f:
        return f.read()


def read_bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def cli_phase(torch, det, plan, scenes, n_gathers, reset_counts, counts,
              tmp) -> dict:
    """Phase 8 (see the module's text): ``apps.detect.main`` on the card in
    single-image, batch, evaluation and side-output mode, held against
    ``det`` (default config) on the same arrays."""
    from pyfaceanalysis_torch.io import images as im_io
    cfg = det.config
    names = [os.path.join(tmp, f"scene{i:02d}.png")
             for i in range(len(scenes))]
    if im_io._HAVE_PIL:
        route = "png"
        for name, scene in zip(names, scenes):
            im_io.save_image(name, scene)
    else:
        # No image library on this machine: the tool reads the same 8-bit
        # scenes from memory instead of from files. Device and kernels are
        # the tool's own either way.
        route = "memory"
        held = {name: np.clip(scene * 255.0, 0, 255).astype(np.uint8)
                .astype(np.float32) / 255.0
                for name, scene in zip(names, scenes)}
        im_io.load_image = (
            lambda path, prescale_size=1000, mode="L": (held[path], 1.0))
        print("cli: PIL does not import; io.images.load_image replaced by "
              "the scenes held in memory for this phase")
    loaded = []
    for name in names:
        image, factor = im_io.load_image(name, cfg.prescale_size)
        if factor != 1.0 or image.shape != scenes[0].shape:
            fail(f"{name} came back as {image.shape} at factor {factor}")
        loaded.append(image)
    one_cascade = {"crop": 1, "gather": n_gathers}

    # Single-image mode, no --device: the default must be the card.
    out = os.path.join(tmp, "single.txt")
    reset_counts()
    run_cli([names[0], out])
    launches_single = counts()
    want = det.detect(loaded[0])
    if not want:
        fail("cli: detect found no face in the re-loaded scene 0")
    if read_bytes(out) != own_rows(tmp, "own_single.txt", want, cfg):
        fail("cli single-image rows differ from write_detections of detect")
    if launches_single != one_cascade:
        fail(f"cli single-image mode must launch {one_cascade}, not "
             f"{launches_single}")
    print(f"cli single: {len(want)} rows, byte-equal to write_detections of "
          f"detect, launches {launches_single}")

    # Batch mode: one shape group, one chunk, detect_stream.
    outs = [os.path.join(tmp, f"rows{i:02d}.txt") for i in range(len(names))]
    batch_file = os.path.join(tmp, "batch.txt")
    with open(batch_file, "w") as f:
        for name, o in zip(names, outs):
            f.write(f"{name}\n{o}\n")
    walls, launches_batch, table = [], None, {}
    for run in (1, 2):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        text = run_cli(["--batch=" + batch_file])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if counts() != one_cascade:
            fail(f"cli batch run {run} must launch {one_cascade}, not "
                 f"{counts()}")
        launches_batch = counts()
        if run == 1:
            want_b = [own_rows(tmp, f"own{i:02d}.txt", d, cfg)
                      for i, d in enumerate(det.detect_batch(loaded))]
        for i, o in enumerate(outs):
            if read_bytes(o) != want_b[i] * run:
                fail(f"cli batch run {run}: {o} is not {run} x "
                     "write_detections of detect_batch")
        for line in text.splitlines():       # the tool's own phase table
            for label in ("Loaded networks and classifiers",
                          "Images loaded (batch)", "Batched detection"):
                if line.startswith(label):
                    table[label] = float(line[60:].split()[0]) * 1e3
    batch_rows = sum(b.count(b"\n") for b in want_b)
    if batch_rows == 0:
        fail("cli batch mode wrote no row")
    print(f"cli batch of {len(names)}: {batch_rows} rows in {len(outs)} "
          f"files, byte-equal to write_detections of detect_batch, doubled "
          f"by a second run; launches {launches_batch}; wall "
          f"{walls[0]:.1f} ms then {walls[1]:.1f} ms per main() (model "
          f"load, {route} loading, detection and writing); its own table "
          f"of the second run, ms: {table}")

    # Evaluation beside a detector on the card: truth from scene 0's own
    # detections (8 floats: eyes, nose, mouth; the mouth where the 6-float
    # format puts it, the nose half way down).
    truth = os.path.join(tmp, "truth.txt")
    with open(truth, "w") as f:
        for d in want:
            (elx, ely), (erx, ery) = d.eye_left, d.eye_right
            mx, my = (elx + erx) / 2.0, (ely + ery) / 2.0 + (
                erx - elx) * 42.0 / 37.0
            f.write(f"{os.path.basename(names[0])}\n{elx} {ely} {erx} {ery} "
                    f"{mx} {((ely + ery) / 2.0 + my) / 2.0} {mx} {my}\n")
    out_eval = os.path.join(tmp, "eval.txt")
    reset_counts()
    text = run_cli(["--coordinates_filename=" + truth, "--write_results=0",
                    names[0], out_eval])
    launches_eval = counts()
    final = text[text.index("ground-truth evaluation:"):]
    tp, fp, fn = (int(final.split(label)[1].split()[0]) for label in (
        "true positives:", "false positives:", "false negatives:"))
    stage_lines = [ln for ln in text.splitlines() if ln.startswith("After ")]
    print(f"cli evaluation: {tp} TP, {fp} FP, {fn} FN for {len(want)} "
          f"detections; {len(stage_lines)} per-stage lines for {len(plan)} "
          f"plan stages; launches {launches_eval} (the traced cascade and "
          f"the production run)")
    if (tp, fp, fn) != (len(want), 0, 0):
        fail("cli evaluation against its own detections is not all true "
             "positives")
    if len(stage_lines) != len(plan):
        fail("cli per-stage report does not have one line per plan stage")
    if os.path.exists(out_eval):
        fail("--write_results=0 wrote a file")
    if any(launches_eval[k] < n for k, n in one_cascade.items()):
        fail(f"cli evaluation run launched {launches_eval}")

    # Side outputs (they are image files, so only with PIL).
    side = None
    if route == "png":
        here = os.getcwd()
        work = os.path.join(tmp, "side")
        os.makedirs(work)
        os.chdir(work)
        try:
            run_cli(["--save_patches=1", "--save_normalized_face_detections=1",
                     "--write_results=0", "--verbose=0", names[0], out_eval])
        finally:
            os.chdir(here)
        side = {}
        for folder, hw in (("saved_patches", (64, 64)),
                           ("normalized_face_detections", (192, 256))):
            files = sorted(os.listdir(os.path.join(work, folder)))
            side[folder] = len(files)
            for name in files:
                arr, _ = im_io.load_image(os.path.join(work, folder, name),
                                          None)
                if arr.shape != hw or not arr.std() > 0.01:
                    fail(f"cli side output {folder}/{name}: shape "
                         f"{arr.shape}, std {arr.std()}")
            if len(files) != len(want):
                fail(f"cli wrote {len(files)} files into {folder} for "
                     f"{len(want)} detections")
        print(f"cli side outputs: {side} files for {len(want)} detections")
    return {"images": route, "single_rows": len(want),
            "batch_rows": batch_rows, "launches_single": launches_single,
            "launches_batch": launches_batch, "launches_eval": launches_eval,
            "eval": {"tp": tp, "fp": fp, "fn": fn,
                     "stage_lines": len(stage_lines)},
            "side_outputs": side, "wall_ms_batch_cli": walls[1],
            "wall_ms_batch_cli_first": walls[0],
            "cli_table_ms": table}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--warm", type=int, default=3)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    try:
        from pyfaceanalysis_torch.config import DetectorConfig
        from pyfaceanalysis_torch.engine.cascade import level_samplers
        from pyfaceanalysis_torch.engine.detector import (
            DetectionModel,
            FaceDetector,
        )
        from pyfaceanalysis_torch.engine.eyes import _eye_levels
        from pyfaceanalysis_torch.ops import cuda_crop, cuda_gather
        from pyfaceanalysis_torch.ops.cuda_build import build_all
        from pyfaceanalysis_torch.ops.pyramid import (
            build_pyramid,
            build_pyramid_batch,
            crop_patches,
        )
    except ImportError as e:
        fail(f"the port is not importable next to this script: {e}")
    import pyfaceanalysis_torch
    if os.path.dirname(os.path.dirname(os.path.abspath(
            pyfaceanalysis_torch.__file__))) != ROOT:
        fail(f"the port was imported from {pyfaceanalysis_torch.__file__}, "
             f"not from {ROOT}")
    artifact_dir = os.path.join(ROOT, "SavedNetworksTPU")
    if not os.path.isdir(artifact_dir):
        fail(f"no {artifact_dir}")

    # Full float32 products (the bf16 rounding is explicit in the port).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    t_start = time.perf_counter()

    # -- 1. build ------------------------------------------------------------
    kernels = {"crop": cuda_crop.KERNEL, "gather": cuda_gather.KERNEL}
    t0 = time.perf_counter()
    build_all(list(kernels.values()))
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(kernels)} "
          "kernels (nvcc in parallel; 0 when already built)")
    for name, k in kernels.items():
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas[{name}]: {line.strip()}")

    def reset_counts():
        for k in kernels.values():
            k.launches = 0

    def counts():
        return {name: k.launches for name, k in kernels.items()}

    # -- 2. model, scenes, kernel inputs of both paths -------------------------
    model = DetectionModel.load(artifact_dir, device=dev)
    scenes = [synthetic_scene(args.seed + i) for i in range(B)]
    img = scenes[0]
    det = FaceDetector(model, DetectorConfig(), device=dev)
    if det.config.detection_contrast_normalize is not True:
        fail("manifest calibration was not resolved")
    if level_samplers(det.config, dev) is None:
        fail("the default config does not route through the kernels")
    im_h, im_w = img.shape
    state, n_real, pyr_info = det._grid_state(im_w, im_h)
    if pyr_info is None:
        fail("the default grid has no pyramid path")
    canvas = det._to_canvas(img)
    pyramid = build_pyramid(canvas, pyr_info.scales, pyr_info.level_hw)
    scales = det._scales(pyr_info)
    crops = pyr_info.crops
    L, lh, lw = pyramid.shape
    print(f"scene {im_w}x{im_h} seed {args.seed}: {n_real} windows in a "
          f"batch of {crops.shape[0]}; pyramid {L}x{lh}x{lw}")

    g = torch.Generator(device="cpu").manual_seed(args.seed)

    def rand(n, lo, hi):
        return (lo + (hi - lo) * torch.rand(n, generator=g)).to(dev)

    # Refinement batch (mid_compact rows): grid windows moved, rescaled and
    # rotated within the cascade's gates, at their own grid level; a few
    # pushed off the level and a few read from the coarsest levels.
    n_ref = min(det.config.mid_compact, crops.shape[0])
    pick = torch.randint(0, n_real, (n_ref,), generator=g).to(dev)
    gb = state.boxes[pick]
    side = (gb[:, 2] - gb[:, 0]) * rand(n_ref, 0.8, 1.25)
    cx = (gb[:, 0] + gb[:, 2]) / 2 + side * rand(n_ref, -0.15, 0.15)
    cy = (gb[:, 1] + gb[:, 3]) / 2 + side * rand(n_ref, -0.15, 0.15)
    cx[:8] = rand(8, -60.0, -10.0)                      # off the level
    cy[8:16] = rand(8, lh * pyr_info.scales[0] + 10, lh * 4.0)
    ref_boxes = torch.stack([cx - side / 2, cy - side / 2,
                             cx + side / 2 - 1, cy + side / 2 - 1], 1)
    # Levels as the cascade passes them: the strided int32 first column
    # of a (B, 3) crop table.
    ref_crops = crops[pick].clone()
    ref_crops[16:32, 0] = L - 2                         # coarsest ladder
    ref_levels = ref_crops[:, 0]
    ref_angles = rand(n_ref, -24.0, 24.0)
    # Second-rung batch (mid_compact2 rows): int64 levels, some beyond both
    # clamps, angles over +-45 degrees with 0, -0 and both ends.
    n_r2 = min(det.config.mid_compact2, n_ref)
    r2_boxes = ref_boxes[n_ref - n_r2:].clone()
    r2_levels = ref_levels[n_ref - n_r2:].to(torch.int64)
    r2_levels[:4] = torch.tensor([-3, L + 5, 0, L - 1], device=dev)
    r2_angles = rand(n_r2, -45.0, 45.0)
    r2_angles[:6] = torch.tensor([0.0, -0.0, 45.0, -45.0, -1e-6, -22.5],
                                 device=dev)
    # Eye batch (2 * eye_max_faces rows) at _eye_levels' levels, native
    # level included, one box too wide for any level.
    n_eye = 2 * det.config.eye_max_faces
    ew = rand(n_eye, 12.0, 130.0)
    ew[0] = 4000.0
    ex, ey = rand(n_eye, 0.0, im_w), rand(n_eye, 0.0, im_h)
    eye_boxes = torch.stack([ex - ew / 2, ey - ew / 2, ex + ew / 2,
                             ey + ew / 2], 1)
    eye_levels, _ = _eye_levels(scales, ew + 1.0)
    eye_angles = rand(n_eye, -24.0, 24.0)

    # The fused batch: B scenes stacked, the pyramid stacked image-major
    # along the level axis, crop levels folded (img * L + level), scales
    # tiled. Windows moved within the gates as above, every row at its own
    # folded level; eye boxes with a per-box image index.
    state_b, n_real_b, pyr_b = det._grid_state(im_w, im_h, batch=B)
    stack = det._to_canvas_batch(scenes)
    pyramid_b = build_pyramid_batch(stack, pyr_b.scales, pyr_b.level_hw)
    scales_b = det._scales(pyr_b, tile=B)
    crops_b = pyr_b.crops
    rows_b = crops_b.shape[0]
    if not torch.equal(pyramid_b[:L], pyramid):
        fail("the stacked pyramid's first image is not build_pyramid's")
    if not torch.equal(crops_b[:n_real_b, 0] + (B - 1) * L,
                       crops_b[(B - 1) * n_real_b: B * n_real_b, 0]):
        fail("crop levels are not folded image-major")
    print(f"fused batch of {B}: {n_real_b} windows per image in a batch of "
          f"{rows_b}; stacked pyramid {tuple(pyramid_b.shape)} "
          f"({pyramid_b.numel() * 4 / 1e6:.0f} MB)")
    fb = state_b.boxes
    fside = (fb[:, 2] - fb[:, 0]) * rand(rows_b, 0.8, 1.25)
    fcx = (fb[:, 0] + fb[:, 2]) / 2 + fside * rand(rows_b, -0.15, 0.15)
    fcy = (fb[:, 1] + fb[:, 3]) / 2 + fside * rand(rows_b, -0.15, 0.15)
    fused_boxes = torch.stack([fcx - fside / 2, fcy - fside / 2,
                               fcx + fside / 2 - 1, fcy + fside / 2 - 1], 1)
    fused_levels = crops_b[:, 0]
    fused_angles = rand(rows_b, -24.0, 24.0)
    n_feye = 2 * B * det.config.eye_max_faces
    few = rand(n_feye, 12.0, 130.0)
    few[0] = 4000.0
    fex, fey = rand(n_feye, 0.0, im_w), rand(n_feye, 0.0, im_h)
    feye_boxes = torch.stack([fex - few / 2, fey - few / 2, fex + few / 2,
                              fey + few / 2], 1)
    feye_img = torch.randint(0, B, (n_feye,), generator=g).to(
        dev, torch.int32)
    feye_levels = (_eye_levels(scales_b[:L], few + 1.0)[0] + feye_img * L)
    feye_angles = rand(n_feye, -24.0, 24.0)

    # -- 3. kernels against their plain versions ------------------------------
    errs = {"crop": 0.0, "gather": 0.0}
    for label, (p, c) in {"single": (pyramid, crops),
                          "fused": (pyramid_b, crops_b)}.items():
        got = cuda_crop.crop_patches_kernel(p, c, (64, 64))
        want = crop_patches(p, c, (64, 64))
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"check crop {label} B={c.shape[0]} 64x64 from "
              f"{tuple(p.shape)}: max_abs_err {err} (atol 0)")
        if err != 0.0 or not bool((want != 0).any()):
            fail(f"crop kernel differs from crop_patches ({label})")
        errs["crop"] = max(errs["crop"], err)
        del got, want
    both = (((64, 64), ("nearest", "bilinear")),
            ((96, 96), ("nearest", "bilinear")))
    for name, p, s, lv, bx, an, shapes in (
            ("refine", pyramid, scales, ref_levels, ref_boxes, ref_angles,
             both),
            ("rung2", pyramid, scales, r2_levels, r2_boxes, r2_angles, both),
            ("eye", pyramid, scales, eye_levels, eye_boxes, eye_angles, both),
            ("fused", pyramid_b, scales_b, fused_levels, fused_boxes,
             fused_angles, (((64, 64), ("nearest",)),)),
            ("fused-eye", pyramid_b, scales_b, feye_levels, feye_boxes,
             feye_angles, (((64, 64), ("nearest", "bilinear")),))):
        errs["gather"] = max(errs["gather"], check_gather(
            torch, name, p, s, lv, bx, an, shapes))

    # -- 4. one image, with attributes: kernels, then plain versions ----------
    det_ref = FaceDetector(model, DetectorConfig(pallas_refine="ref"),
                           device=dev)
    reset_counts()
    t0 = time.perf_counter()
    dets = det.detect(img)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = counts()
    print(f"detect (kernels): {det.windows_scanned} windows scanned, "
          f"{len(dets)} detections, first call {first_s * 1e3:.1f} ms, "
          f"launches {launches}")
    for name, n in launches.items():
        if n == 0:
            fail(f"detect never launched the {name} kernel")
    reset_counts()
    dets_ref = det_ref.detect(img)
    if any(counts().values()):
        fail("the ref path launched a kernel")
    if not dets:
        fail("detect found no face in the scene")
    compare_lists("detect, kernel path vs ref path", [dets], [dets_ref],
                  1e-3, attr_tol=1e-3)
    for d in dets:
        print("detection:", json.dumps({
            "box": [round(v, 3) for v in d.box], "angle": round(d.angle, 3),
            "eye_left": [round(v, 3) for v in d.eye_left],
            "eye_right": [round(v, 3) for v in d.eye_right],
            "confidence": round(d.confidence, 5), "age": round(d.age, 3),
            "age_std": round(d.age_std, 3), "race": d.race,
            "gender": d.gender}))

    # -- 5. fused batch at full width ------------------------------------------
    n_gathers = (sum(st.extract for st in model.plan) - 1
                 + det.config.eye_iters)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    batch = det.detect_batch(scenes)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches_batch = counts()
    peak_batch = torch.cuda.max_memory_allocated()
    print(f"detect_batch of {B} (fused, kernels): "
          f"{sum(len(d) for d in batch)} detections, first call "
          f"{first_s * 1e3:.1f} ms, launches {launches_batch} (expected 1 "
          f"crop, {n_gathers} gathers), peak device memory "
          f"{peak_batch / 1e6:.0f} MB")
    if launches_batch != {"crop": 1, "gather": n_gathers}:
        fail("one fused batch must launch 1 crop and "
             f"{n_gathers} gathers, not {launches_batch}")
    reset_counts()
    batch_ref = det_ref.detect_batch(scenes)
    if any(counts().values()):
        fail("the fused ref path launched a kernel")
    compare_lists("detect_batch, kernel path vs ref path", batch, batch_ref,
                  1e-3, attr_tol=1e-3)
    # Fused against sequential, at the f32 wire (detect never packs it):
    # at the default bf16 operand rounding and at float32 operands.
    det_f32 = FaceDetector(model, DetectorConfig(wire_format="f32"),
                           device=dev)
    sequential = [det_f32.detect(im) for im in scenes]
    drift = {"bf16": compare_drift(
        "detect_batch fused vs sequential detect (f32 wire, bf16 operands)",
        det_f32.detect_batch(scenes), sequential, FUSED_VS_SEQUENTIAL_SHARE,
        FUSED_VS_SEQUENTIAL_PX["bf16"])}
    det_mm32 = FaceDetector(
        model, DetectorConfig(wire_format="f32", matmul_dtype="f32"),
        device=dev)
    drift["f32"] = compare_drift(
        "detect_batch fused vs sequential detect (f32 wire, f32 operands)",
        det_mm32.detect_batch(scenes), [det_mm32.detect(im) for im in scenes],
        FUSED_VS_SEQUENTIAL_SHARE, FUSED_VS_SEQUENTIAL_PX["f32"])
    det_async = FaceDetector(
        model, DetectorConfig(wire_format="f32", batch_mode="async"),
        device=dev)
    reset_counts()
    compare_lists("detect_batch async vs sequential detect",
                  det_async.detect_batch(scenes), sequential, 1e-3,
                  attr_tol=1e-3)
    print(f"detect_batch async: launches {counts()}")
    # A batch of one image is one fused program of one image (the tail
    # chunk of max_fused_batch * k + 1 images): through the kernels too.
    reset_counts()
    one = det_f32.detect_batch(scenes[:1])
    launches_one = counts()
    print(f"detect_batch of 1 (fused, kernels): launches {launches_one}")
    if launches_one != {"crop": 1, "gather": n_gathers}:
        fail("a fused batch of one image must launch 1 crop and "
             f"{n_gathers} gathers, not {launches_one}")
    det_ref32 = FaceDetector(
        model, DetectorConfig(wire_format="f32", pallas_refine="ref"),
        device=dev)
    reset_counts()
    one_ref = det_ref32.detect_batch(scenes[:1])
    if any(counts().values()):
        fail("the ref path of a one-image batch launched a kernel")
    compare_lists("detect_batch of 1, kernel path vs ref path", one, one_ref,
                  1e-3, attr_tol=1e-3)
    # Its products have detect's row count, so the two must be equal.
    compare_lists("detect_batch of 1 vs detect (equal shapes)", one,
                  sequential[:1], 1e-3, attr_tol=1e-3)
    # -- 6. stream ---------------------------------------------------------------
    half = synthetic_scene(args.seed + B, 600, 800)
    batches = [scenes, scenes[::-1], scenes[: B // 2] + [half],
               scenes[1:] + scenes[:1]]
    want_stream = [det.detect_batch(b) for b in batches]
    # Three fused batches and the ragged one image by image.
    n_programs = 3 + len(batches[2])
    want_launches = {"crop": n_programs, "gather": n_programs * n_gathers}
    launches_stream = {}
    for prefetch in (False, True):
        form = "three-stage" if prefetch else "queue"
        det_s = FaceDetector(
            model, DetectorConfig(stream_push_prefetch=prefetch), device=dev)
        reset_counts()
        t0 = time.perf_counter()
        got_stream = list(det_s.detect_stream(iter(batches)))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches_stream[form] = counts()
        n_img = sum(len(b) for b in batches)
        print(f"detect_stream ({form}): {len(got_stream)} batches, {n_img} "
              f"images in {dt * 1e3:.1f} ms, launches "
              f"{launches_stream[form]}")
        if len(got_stream) != len(batches):
            fail(f"detect_stream ({form}) yielded {len(got_stream)} batches")
        for i, (gs, ws) in enumerate(zip(got_stream, want_stream)):
            compare_lists(f"detect_stream ({form}) batch {i} vs detect_batch",
                          gs, ws, 1e-3, attr_tol=1e-3)
        if launches_stream[form] != want_launches:
            fail(f"detect_stream ({form}) must launch {want_launches}")

    # -- 7. timings and bounds -------------------------------------------------
    wall = {}
    for name, fn in (
            ("detect, no attributes, kernels",
             lambda: det.detect(img, estimate_attributes=False)),
            ("detect, no attributes, ref",
             lambda: det_ref.detect(img, estimate_attributes=False)),
            ("detect, attributes, kernels", lambda: det.detect(img)),
            (f"detect_batch {B}, attributes, kernels",
             lambda: det.detect_batch(scenes)),
            (f"detect_batch {B}, attributes, ref",
             lambda: det_ref.detect_batch(scenes)),
            (f"detect_batch {B} async, attributes, kernels",
             lambda: det_async.detect_batch(scenes))):
        times = wall_ms(torch, fn, args.warm)
        wall[name] = statistics.median(times)
        print(f"wall time ({name}): median {wall[name]:.3f} ms over "
              f"{args.warm} warm runs {[round(t, 3) for t in times]}")
    batch_ms = wall[f"detect_batch {B}, attributes, kernels"]
    print(f"detect_batch {B} (fused, kernels, attributes): "
          f"{batch_ms / B:.3f} ms per image, {B / batch_ms * 1e3:.2f} images "
          f"per second; sequential detect with attributes: "
          f"{wall['detect, attributes, kernels']:.3f} ms per image, "
          f"{1e3 / wall['detect, attributes, kernels']:.2f} images per second")
    prof = {
        "detect": profile_path(
            torch, "detect (no attributes)",
            lambda: det.detect(img, estimate_attributes=False), args.warm, 1),
        "detect_attr": profile_path(torch, "detect (attributes)",
                                    lambda: det.detect(img), args.warm, 1),
        "batch": profile_path(torch, f"detect_batch of {B} (attributes)",
                              lambda: det.detect_batch(scenes), args.warm, B),
    }
    torch.cuda.reset_peak_memory_stats()
    det.detect(img)
    torch.cuda.synchronize()
    print(f"peak device memory: detect {torch.cuda.max_memory_allocated() / 1e6:.0f} MB, "
          f"detect_batch of {B} {peak_batch / 1e6:.0f} MB "
          f"(model, scenes' pyramids and check tensors resident)")
    # A batch of max_fused_batch images, the largest one fused cascade.
    big = (scenes * (det.config.max_fused_batch // B + 1))[
        : det.config.max_fused_batch]
    del pyramid_b, stack
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    n_big = sum(len(d) for d in det.detect_batch(big))
    torch.cuda.synchronize()
    print(f"detect_batch of {len(big)} (one fused cascade): {n_big} "
          f"detections, {(time.perf_counter() - t0) * 1e3:.1f} ms (first "
          f"call at this size), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e6:.0f} MB")
    stack = det._to_canvas_batch(scenes)
    pyramid_b = build_pyramid_batch(stack, pyr_b.scales, pyr_b.level_hw)

    crop_1 = time_crop(torch, "single", pyramid, crops, 100)
    crop_b = time_crop(torch, "fused", pyramid_b, crops_b, 20)
    gather_1 = time_gather(torch, "refine", pyramid, scales, ref_levels,
                           ref_boxes, ref_angles, 100)
    gather_b = time_gather(torch, "fused", pyramid_b, scales_b, fused_levels,
                           fused_boxes, fused_angles, 20)
    # The other shapes of both paths, for the record (not in the JSON).
    n_rung2_b = B * n_r2
    for label, p, s, (lv, bx, an), shape, method in (
            ("rung2", pyramid, scales, (r2_levels, r2_boxes, r2_angles),
             (64, 64), "nearest"),
            ("eye", pyramid, scales, (eye_levels, eye_boxes, eye_angles),
             (64, 64), "nearest"),
            ("refine", pyramid, scales, (ref_levels, ref_boxes, ref_angles),
             (96, 96), "bilinear"),
            ("fused rung2", pyramid_b, scales_b,
             (fused_levels[:n_rung2_b], fused_boxes[:n_rung2_b],
              fused_angles[:n_rung2_b]), (64, 64), "nearest"),
            ("fused eye", pyramid_b, scales_b,
             (feye_levels, feye_boxes, feye_angles), (64, 64), "nearest")):
        ms, n = device_ms(
            torch, lambda: cuda_gather.sample_patches_pyramid(
                p, s, lv, bx, an, shape, method), 50)
        print(f"gather {label} B={bx.shape[0]} {shape[0]}x{shape[1]} "
              f"{method}: device {ms:.6f} ms in {n} GPU launch per call")
        if n is not None and n > 1:
            fail(f"one gather wrapper call ({label}) made {n} GPU launches")
    # -- 8. the command line ----------------------------------------------------
    from pyfaceanalysis_torch.io import images as im_io
    real_load_image = im_io.load_image
    with tempfile.TemporaryDirectory() as tmp:
        try:
            cli = cli_phase(torch, det, model.plan, scenes, n_gathers,
                            reset_counts, counts, tmp)
        finally:
            im_io.load_image = real_load_image
    cli["wall_ms_detect_batch"] = batch_ms
    print(json.dumps({"cli": cli}))
    entries = []
    for name, single, fused, line in (
            ("crop", crop_1, crop_b, "pallas_crop.py:73"),
            ("gather", gather_1, gather_b, "pallas_gather.py:145")):
        entries.append({
            "name": name, "route": "cuda",
            "source": f"pyfaceanalysis_torch/ops/csrc/{name}.cu",
            "replaces": f"pyfaceanalysis_tpu/ops/{line}",
            "launches": launches[name],
            "launches_per_call": single["launches_per_call"],
            "max_abs_err": errs[name],
            "ms": single["ms"], "plain_ms": single["plain_ms"],
            "bound_ms": single["bound_ms"], "bound_by": single["bound_by"],
            "library_ms": single["library_ms"],
            "launches_fused_batch": launches_batch[name],
            "launches_stream": {f: c[name]
                                for f, c in launches_stream.items()},
            "launches_cli": {"single": cli["launches_single"][name],
                             "batch": cli["launches_batch"][name]},
            "fused": fused})
    torch.cuda.synchronize()
    print(json.dumps({"paths": {
        "batch": B, "wall_ms": wall,
        "images_per_second_batch": B / batch_ms * 1e3,
        "profile": prof, "peak_batch_bytes": peak_batch,
        "fused_vs_sequential": drift}}))
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s after "
          "imports")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(json.dumps({"kernels": entries}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
