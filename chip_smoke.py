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
   bit against ``pyramid_affine``. The layer kernel: every network of the
   model at bf16 and float32 operands, on the grid's crops of one image
   (512 rows) and of the fused batch (8,192), each layer's operand and
   each network's output equal to the plain path's bit for bit (their
   largest difference is the kernel's ``max_abs_err``), and its spow column
   on all 2^32 float32 bit patterns at each exponent of the model's spow
   layers.
4. One image: ``FaceDetector(model, device="cuda").detect(img)`` with the
   attribute heads, launch counts set to 0 just before and read just
   after; fails if a kernel was not launched or an attribute is not
   finite. The layer kernel's launches are counted apart (the "ref" route
   runs the networks too) and printed, here and for the fused batch.
   Again with ``pallas_refine="ref"`` (plain versions): the same
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
   operations over 67 TFLOP/s); the layer kernel at layers 0 and 1 of
   ``net_disc`` (bf16) at both shapes. The same trace counts the GPU
   launches of one wrapper call: more than one fails.
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
9. Training: ``pyfaceanalysis_torch.apps.train.main`` with ``--quick``,
   no real photos, TRAIN_CALIB_SCENES calibration scenes and no
   ``--device`` (full width: 64x64 and 96x96 patches, the 17-stage plan;
   only sample counts are cut), into a temporary directory. Its launches
   must equal the number derived from the code: per calibration scene one
   traced cascade without eye pass and one production run, through the
   kernels only where the calibration's grid (320 px, smallest_face 0.15)
   has a pyramid path; it has none, in the JAX package as here, so 0. The
   directory must hold every network and classifier of the trainer's
   stage layout, ``Pipeline_tpu.txt`` and a calibrated manifest, and load
   with 22 classifiers; ``detect`` on it equals its "ref" route (1e-3 px)
   with 1 crop and 7 gathers per call. ``train_network`` on one quick pose
   set and on a set driven by one latent, each drawn once on the CPU, runs
   on the card and on the CPU (full width): per-layer differences up to
   sign are printed, and the held-out regressions (PosX; the latent) are
   held to TRAIN_CARD_VS_CPU_*. One ``train_network`` call is profiled. The
   sha256 of every file of ``SavedNetworksTPU/`` and
   ``SavedNetworksTPU_photo/`` must be the same after the phase. Prints
   one ``{"train": {...}}`` line.
10. The data mesh (``parallel.mesh``, ``parallel.train_step``). (a) On a
   one-card mesh ``sharded_cascade`` equals ``run_cascade`` and ``detect``
   equals the unsharded ``detect``, bit for bit, with 1 crop and 7
   gathers. (b) A fused ``detect_batch`` of the 16 scenes on a mesh of
   MESH_SHARDS shards of the one card against the unsharded fused batch,
   at bf16 and at float32 operands (f32 wire), held to the drift gate of
   phase 5 (a shard's products are MESH_SHARDS times shorter); launches
   per call exactly MESH_SHARDS crops and MESH_SHARDS x 6 refinement
   gathers + the eye pass's (the rungs, ranking and eye pass run over all
   rows on the first device). (c) ``detect_stream`` under that mesh
   equals ``detect_batch`` under it (1e-3 px). (d) ``train_network`` on
   the one-latent set with a one-card and the MESH_SHARDS-shard mesh
   against unsharded: first-layer moments within atol 1e-5 / rtol 1e-4,
   held-out regressions within TRAIN_CARD_VS_CPU_*. (e) ``gsfa_step`` and
   ``sharded_gsfa_step`` (a 4 x 2 mesh of the card) against the CPU: mean
   within rtol 1e-4 / atol 1e-5, W up to sign within rtol 1e-2 / atol
   1e-3. (f) ``apps.train.main --quick --data_mesh=1 --no_calibrate``
   into a temporary directory, which ``detect`` runs with 1 crop and 7
   gathers. (g) ``parallel.dryrun.dryrun_multichip(1, "cuda")``. Wall
   times of a one-card mesh against unsharded for ``detect``, the fused
   batch and ``train_network``, of each step and of the phase. Prints one
   ``{"mesh": {...}}`` line.

The last lines are one JSON object ``{"kernels": [...]}``, the output of
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` and the
result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import inspect
import io
import json
import os
import re
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
# Phase 9: calibration scenes of the quick training run and smoke scenes
# through the trained directory.
TRAIN_CALIB_SCENES = 3
TRAIN_SCENES = 4
# train_network on the card against the CPU at full width, on the
# one-latent set (latent_set): a held-out regression of the latent, largest
# difference as a share of its range and the correlation of the two sides.
# Readings on an H100 at 700 W with float64 moments (the trainer's): 0.000062
# of the range, correlation 1.0 to 8 digits; on the quick pose set 0.000103
# and 1.0. With float32 moments the one-latent set read 0.000299 and the
# quick pose set 0.859 and 0.884 (its trailing slow directions followed
# the summation order); with float32 eigensolves 0.0246 and 0.99986 (see
# models/moments.py).
TRAIN_CARD_VS_CPU_REG = 0.005
TRAIN_CARD_VS_CPU_CORR = 0.9999
# Phase 10: shards of the virtual mesh (all on the one card).
MESH_SHARDS = 4


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


def net_layer_chain(torch, net, x, cd, label: str) -> float:
    """Runs ``net`` on ``x`` through the layer kernel and through the plain
    path on the card, layer by layer; fails unless every layer's operand
    and the network's output are equal bit for bit (NaNs included).
    Returns the largest |kernel - plain| over every operand and output
    (0 where both are NaN or the same infinity; inf where one is NaN)."""
    from pyfaceanalysis_torch.models.network import (
        apply_network,
        layer_operand,
        layer_operand_ref,
    )

    def bits(t):
        return t.contiguous().view(torch.int32)

    def abs_err(got, want):
        same = (got == want) | (torch.isnan(got) & torch.isnan(want))
        d = torch.where(same, 0.0, (got - want).abs())
        return float(torch.nan_to_num(d, nan=float("inf")).max())

    y, clip, err = x, None, 0.0
    for li, (spec, node, index) in enumerate(zip(net.specs, net.params,
                                                 net.indices)):
        got = layer_operand(spec, node, index, y, clip, cd)
        want = layer_operand_ref(spec, node, index, y, clip, cd)
        err = max(err, abs_err(got, want))
        if not torch.equal(bits(got), bits(want)):
            fail(f"layer kernel operand differs from the plain path "
                 f"({label}, layer {li})")
        y = torch.einsum("bfd,fdo->bfo", want, node.W.to(cd).float()
                         if cd is not None else node.W)
        clip = spec.clip
    want = torch.clamp(y, -clip, clip).reshape(y.shape[0], -1)
    got = apply_network(net, x, compute_dtype=cd)
    err = max(err, abs_err(got, want))
    if not torch.equal(bits(got), bits(want)):
        fail(f"network output through the layer kernel differs ({label})")
    return err


def time_net_layer(torch, label, net, x, cd, iters, layers=(0, 1)) -> list:
    """Device time per call of the layer kernel at ``layers`` of ``net`` on
    ``x``'s rows (each layer's input as the chain leaves it), of its plain
    version on the card, and the bound: the layer's inputs read once, its
    operand written once, the switchboard, mean and column table, over the
    card's HBM rate."""
    from pyfaceanalysis_torch.models.network import (
        layer_operand,
        layer_operand_ref,
        layer_product,
    )
    B = x.shape[0]
    inputs, y, clip = [], x, None
    for spec, node, index in zip(net.specs, net.params, net.indices):
        inputs.append((y, clip))
        y = layer_product(spec, node, index, y, clip, cd)
        clip = spec.clip
    rows = []
    for li in layers:
        spec, node, index = net.specs[li], net.params[li], net.indices[li]
        xi, ci = inputs[li]
        F, k = index.shape
        D = spec.expansion.output_dim(k)
        n_bytes = (xi.numel() * 4 + B * F * D * 4 + F * k * 8 + F * D * 4
                   + D * 4)
        bound = n_bytes / HBM_BYTES_PER_S * 1e3

        def kern():
            return layer_operand(spec, node, index, xi, ci, cd)

        ms, n = device_ms(torch, kern, iters)
        plain, plain_n = device_ms(torch, lambda: layer_operand_ref(
            spec, node, index, xi, ci, cd), max(iters // 5, 3))
        print(f"net_layer {label} layer {li} B={B} F={F} k={k} D={D} "
              f"{spec.expansion.name}: device {ms:.6f} ms in {n} GPU launch "
              f"per call (plain version {plain:.6f} ms in {plain_n}), bound "
              f"{bound:.6f} ms by bytes ({bound / ms * 100:.1f}%)")
        if n is not None and n > 1:
            fail(f"one layer kernel call ({label}) made {n} GPU launches")
        rows.append({"layer": li, "rows": B, "ms": ms, "plain_ms": plain,
                     "plain_launches": plain_n, "bound_ms": bound,
                     "bound_by": "bytes", "launches_per_call": n})
    return rows


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


def tree_hashes(*dirs) -> dict:
    """sha256 of every file under ``dirs`` (relative path -> hex digest)."""
    out = {}
    for d in dirs:
        for root, _, files in os.walk(os.path.join(ROOT, d)):
            for name in files:
                path = os.path.join(root, name)
                with open(path, "rb") as f:
                    out[os.path.relpath(path, ROOT)] = hashlib.sha256(
                        f.read()).hexdigest()
    return out


def latent_set(n: int, seed: int, K: int = 24, side: int = 64):
    """(n, side * side) float32 patches driven by one latent u in
    [-0.95, 0.95] and u: K Legendre polynomials of u, each on its own fixed
    random pixel pattern with a falling amplitude, plus faint noise.
    Functions of one variable have a simple slowness spectrum, so every
    layer's output columns are well determined (tests/
    test_torch_training_models.py uses the same construction at 16x16)."""
    from numpy.polynomial import legendre
    rng = np.random.RandomState(seed)
    u = rng.uniform(-0.95, 0.95, n)
    polys = np.stack([legendre.legval(u, np.eye(K + 1)[k])
                      for k in range(1, K + 1)], 1)
    patterns = np.random.RandomState(1000).randn(K, side, side)
    img = (0.5 + np.einsum("nk,k,kij->nij", polys, 0.1 * 0.9 ** np.arange(K),
                           patterns) + 0.003 * rng.randn(n, side, side))
    return img.reshape(n, -1).astype(np.float32), u


def card_vs_cpu(torch, x, labels, target, x_held, target_held, fit_kw):
    """``train_network`` of build_higsfa(64, top_dim=20) on ``x`` on the
    card and on the CPU, a 10-feature Gaussian regressor of ``target`` fit
    on each side's features, both applied to ``x_held``: per-layer
    differences up to sign, the share of columns within 1e-2, and the two
    regressions' largest difference and correlation."""
    from pyfaceanalysis_torch.models import builder
    from pyfaceanalysis_torch.models.network import apply_layer
    from pyfaceanalysis_torch.training import trainer
    sides = {"card": "cuda", "cpu": "cpu"}
    nets, regs, ms = {}, {}, {}
    for side, dev in sides.items():
        xd = x.to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nets[side] = trainer.train_network(
            builder.build_higsfa(64, top_dim=20), xd, labels=labels,
            **fit_kw)
        torch.cuda.synchronize()
        ms[side] = (time.perf_counter() - t0) * 1e3
        clf = trainer.fit_regressor_bins(trainer._execute(nets[side], xd),
                                         target, 10, 50)
        held = trainer._execute(nets[side], x_held.to(dev))
        regs[side] = clf.regression(torch.as_tensor(held[:, :10])).numpy()
    layer_err, layer_share = [], []
    cur = {side: x.to(dev) for side, dev in sides.items()}
    for li, spec in enumerate(nets["card"].specs):
        for side, net in nets.items():
            cur[side] = apply_layer(spec, net.params[li], net.indices[li],
                                    cur[side])
        a, b = cur["card"].cpu().double(), cur["cpu"].double()
        d = torch.minimum((a - b).abs().amax(0), (a + b).abs().amax(0))
        layer_err.append(float(d.max()))
        layer_share.append(float((d <= 1e-2).double().mean()))
    return {"patches": len(x), "ms_card": ms["card"], "ms_cpu": ms["cpu"],
            "layer_max_up_to_sign": layer_err,
            "layer_share_within_1e-2": layer_share,
            "reg_max_abs": float(np.abs(regs["card"] - regs["cpu"]).max()),
            "label_span": float(np.ptp(target_held)),
            "reg_corr": float(np.corrcoef(regs["card"], regs["cpu"])[0, 1])}


def train_phase(torch, scenes, reset_counts, counts, tmp) -> dict:
    """Phase 9 (see the module's text): ``apps.train.main`` on the card, the
    trained directory through both refinement routes, and ``train_network``
    on the card against the CPU."""
    from pyfaceanalysis_torch.apps import train as train_app
    from pyfaceanalysis_torch.config import DetectorConfig, NetGeometry
    from pyfaceanalysis_torch.engine.cascade import make_grid_state
    from pyfaceanalysis_torch.engine.detector import (
        DetectionModel,
        FaceDetector,
    )
    from pyfaceanalysis_torch.models import builder
    from pyfaceanalysis_torch.training import calibration, datasets, trainer
    from pyfaceanalysis_torch.training.sampler import Sampler

    shipped = ("SavedNetworksTPU", "SavedNetworksTPU_photo")
    hashes = tree_hashes(*shipped)
    t_phase = time.perf_counter()
    out_dir = os.path.join(tmp, "trained")
    argv = ["--quick", "--out_dir", out_dir, "--real_frac=0",
            "--real_bg_frac=0", f"--calib_scenes={TRAIN_CALIB_SCENES}"]
    text = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        rc = train_app.main(argv)            # no --device: the card
    torch.cuda.synchronize()
    wall_main = time.perf_counter() - t0
    launches_train = counts()
    peak_main = torch.cuda.max_memory_allocated()
    log = text.getvalue()
    for line in log.splitlines():
        if line.startswith("[train]") or line.startswith("calibration"):
            print(f"train| {line}")
    if rc != 0:
        fail(f"apps.train.main({argv}) returned {rc}")
    split = {}
    for m in re.finditer(r"\[train\] (\S+): done \(render ([\d.]+) s, fit "
                         r"([\d.]+) s, features ([\d.]+) s, gaussian "
                         r"([\d.]+) s\)", log):
        split[m.group(1)] = dict(zip(("render", "fit", "features",
                                      "gaussian"),
                                     map(float, m.groups()[1:])))
    m = re.search(r"\[train\] calibration: done in ([\d.]+) s", log)
    calib_s = float(m.group(1)) if m else None
    # (a) the calibration's launches, derived from the code: each scene is
    # one traced cascade (no eye pass) and one production run, through the
    # kernels when its grid has a pyramid path. The calibration's grid (320
    # px canvas, smallest_face 0.15) has crop origins outside their levels,
    # so make_grid_state gives no pyramid and both runs take the canvas
    # gather, in the JAX package as here: 0 launches.
    model = DetectionModel.load(out_dir, device="cuda")
    n_extract = sum(st.extract for st in model.plan)
    eye_iters = DetectorConfig().eye_iters
    defaults = {k: v.default for k, v in inspect.signature(
        calibration.calibrate_model).parameters.items()}
    calib_cfg = DetectorConfig(smallest_face=defaults["smallest_face"],
                               cut_offs_face=(2.0,) * 10,
                               last_cut_off_face=2.0)
    side = defaults["canvas"]
    _, _, calib_pyr = make_grid_state(side, side, model.spec.face_geom,
                                      calib_cfg)
    per_scene = ({"crop": 2, "gather": 2 * (n_extract - 1) + eye_iters}
                 if calib_pyr is not None else {"crop": 0, "gather": 0})
    want = {k: TRAIN_CALIB_SCENES * n for k, n in per_scene.items()}
    print(f"apps.train.main --quick: {wall_main:.1f} s, launches "
          f"{launches_train} (expected {TRAIN_CALIB_SCENES} calibration "
          f"scenes x {per_scene}: the calibration grid has "
          f"{'a' if calib_pyr is not None else 'no'} pyramid path), peak "
          f"device memory {peak_main / 1e6:.0f} MB; per network {split}; "
          f"calibration {calib_s} s")
    if launches_train != want:
        fail(f"apps.train.main must launch {want}, not {launches_train}")
    if sorted(split) != sorted({n for _, n, _, _ in trainer._STAGE_LAYOUT
                                if n != "None0"}):
        fail(f"the trainer's log has no time line for some network: "
             f"{sorted(split)}")
    # (b) the directory
    for _, net, clf, _ in trainer._STAGE_LAYOUT:
        for name in {net, clf} - {"None0"}:
            if not os.path.exists(os.path.join(out_dir, name + ".npz")):
                fail(f"the trained directory has no {name}.npz")
    if not os.path.exists(os.path.join(out_dir, "Pipeline_tpu.txt")):
        fail("the trained directory has no Pipeline_tpu.txt")
    with open(os.path.join(out_dir, "manifest.json")) as f:
        calib = json.load(f)["calibration"]
    if (len(calib.get("cut_offs_face", ())) != 10
            or "last_cut_off_face" not in calib
            or "tolerance_xy_eye" not in calib):
        fail(f"the manifest is not calibrated: {calib}")
    if len(model.classifiers) != 22:
        fail(f"DetectionModel.load read {len(model.classifiers)} "
             "classifiers")
    # (c) the trained directory through the kernels and the plain versions
    det = FaceDetector(model, DetectorConfig(), device="cuda")
    det_ref = FaceDetector(model, DetectorConfig(pallas_refine="ref"),
                           device="cuda")
    one_cascade = {"crop": 1, "gather": n_extract - 1 + eye_iters}
    got, ref = [], []
    for scene in scenes[:TRAIN_SCENES]:
        reset_counts()
        got.append(det.detect(scene))
        if counts() != one_cascade:
            fail(f"detect on the trained model launched {counts()}, not "
                 f"{one_cascade}")
        ref.append(det_ref.detect(scene))
    compare_lists("trained model: detect, kernel path vs ref path", got,
                  ref, 1e-3, attr_tol=1e-3)
    # (d) train_network on the card against the CPU, on one quick pose set
    # and on a set driven by one latent (well-separated spectra in every
    # layer), each drawn once on the CPU and copied.
    geom = NetGeometry()
    x, lab = datasets.pose_dataset(Sampler(11), 24, 16, geom, 40.0, 20.0,
                                   22.5, contrast_normalize=True,
                                   attr_cues="v2")
    x_held, lab_held = datasets.pose_dataset(Sampler(12), 24, 16, geom, 40.0,
                                             20.0, 22.5,
                                             contrast_normalize=True,
                                             attr_cues="v2")
    fit_kw = dict(graph="serial", num_groups=50, verbose=False)
    pose = card_vs_cpu(torch, x, np.stack([lab["dx"], lab["dy"]], axis=1),
                       lab["dx"], x_held, lab_held["dx"],
                       dict(fit_kw, label_weights=(1.0, 1.5)))
    lx, lu = latent_set(2000, 21)
    lx_held, lu_held = latent_set(500, 22)
    latent = card_vs_cpu(torch, torch.from_numpy(lx), lu, lu,
                         torch.from_numpy(lx_held), lu_held, fit_kw)
    for name, r in (("quick pose set", pose), ("one-latent set", latent)):
        print(f"train_network card vs CPU, {name}: build_higsfa(64, "
              f"top_dim=20) on {r['patches']} patches, {r['ms_card']:.1f} "
              f"ms on the card, {r['ms_cpu']:.1f} ms on the CPU; largest "
              f"per-layer difference up to sign "
              f"{[round(e, 6) for e in r['layer_max_up_to_sign']]}, share "
              f"of columns within 1e-2 "
              f"{[round(e, 4) for e in r['layer_share_within_1e-2']]}; "
              f"held-out regression max |diff| {r['reg_max_abs']} "
              f"({r['reg_max_abs'] / r['label_span']:.6f} of the label "
              f"range {r['label_span']:.3f}), correlation "
              f"{r['reg_corr']:.8f}")
        if (r["reg_max_abs"] > TRAIN_CARD_VS_CPU_REG * r["label_span"]
                or r["reg_corr"] < TRAIN_CARD_VS_CPU_CORR):
            fail(f"train_network on the card disagrees with the CPU on the "
                 f"{name} beyond the stated tolerance "
                 f"({TRAIN_CARD_VS_CPU_REG} of the label range, "
                 f"correlation {TRAIN_CARD_VS_CPU_CORR})")
    # (e) device busy time and GPU launches of one train_network call
    xd = x.to("cuda")
    labels = np.stack([lab["dx"], lab["dy"]], axis=1)
    spans, wall = device_spans(
        torch, lambda: trainer.train_network(builder.build_higsfa(
            64, top_dim=20), xd, labels=labels, label_weights=(1.0, 1.5),
            **fit_kw), 1)
    busy = launches = None
    if spans is not None:
        busy = sum(sum(d) for d in spans.values()) / 1e3
        launches = sum(len(d) for d in spans.values())
        print(f"train_network under the profiler: wall {wall:.1f} ms, "
              f"device busy {busy:.1f} ms (idle share "
              f"{1 - busy / wall:.4f}), {launches} GPU launches")
    else:
        print(f"train_network under the profiler: wall {wall:.1f} ms; "
              "device busy time and GPU launches not measured")
    if tree_hashes(*shipped) != hashes:
        fail("phase 9 changed a file of the shipped artifact directories")
    phase_s = time.perf_counter() - t_phase
    print(f"training phase: {phase_s:.1f} s; {len(hashes)} files of "
          f"{', '.join(shipped)} hash the same before and after")
    return {"wall_s_main_quick": wall_main, "per_network_s": split,
            "calibration_s": calib_s, "launches_main": launches_train,
            "launches_expected": want, "peak_bytes_main": peak_main,
            "train_network": {"patches": len(x),
                              "profiled_wall_ms": wall, "busy_ms": busy,
                              "gpu_launches": launches},
            "card_vs_cpu": {"quick_pose": pose, "one_latent": latent},
            "trained_detections": sum(len(d) for d in got),
            "phase_s": phase_s}


def exceeds(torch, got, want, rtol, atol) -> float:
    """Largest amount by which |got - want| exceeds atol + rtol * |want|
    (0 or less: within the tolerance), in float64 on the CPU."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float(((got - want).abs() - (atol + rtol * want.abs())).max())


def up_to_sign(torch, W, ref):
    """``W`` with each output column's sign flipped to agree with ``ref``
    ((F, D, O) weights)."""
    W, ref = W.detach().double().cpu(), ref.detach().double().cpu()
    return W * torch.sign((W * ref).sum(dim=-2, keepdim=True))


def mesh_phase(torch, model, det, scenes, reset_counts, counts, tmp, warm,
               dev) -> dict:
    """Phase 10 (see the module's text): the data mesh on the card ``dev``
    (cuda:0), a one-card mesh and MESH_SHARDS shards of the one card."""
    from pyfaceanalysis_torch.apps import train as train_app
    from pyfaceanalysis_torch.config import DetectorConfig
    from pyfaceanalysis_torch.engine import cascade as cascade_mod
    from pyfaceanalysis_torch.engine.detector import (
        DetectionModel,
        FaceDetector,
    )
    from pyfaceanalysis_torch.models import builder, moments
    from pyfaceanalysis_torch.ops.pyramid import build_pyramid
    from pyfaceanalysis_torch.parallel import dryrun, train_step
    from pyfaceanalysis_torch.parallel.mesh import (
        Mesh,
        make_mesh,
        shard_batch,
        sharded_cascade,
    )
    from pyfaceanalysis_torch.training import trainer

    t_phase = time.perf_counter()
    step_s = {}
    eye_iters = det.config.eye_iters

    def per_call(plan, n_shards):
        """Launches of one cascade call on ``n_shards`` shards: each shard
        crops its rows and gathers them at every later extraction; the eye
        pass runs once, on the first device, over all survivors."""
        n_extract = sum(st.extract for st in plan)
        return {"crop": n_shards,
                "gather": n_shards * (n_extract - 1) + eye_iters}

    mesh1 = make_mesh(1, device=dev)
    # MESH_SHARDS shards of the one card: make_mesh takes distinct cards,
    # so the mesh is built from an explicit device list, the counterpart
    # of the JAX dry run's explicit Mesh(...).
    meshN = Mesh(np.array([dev] * MESH_SHARDS, dtype=object), ("data",))
    print(f"mesh: {mesh1} and {meshN}")

    # (a) one-card mesh: the unsharded program, bit for bit
    t0 = time.perf_counter()
    img = scenes[0]
    im_h, im_w = img.shape
    state, _, pyr, pyr_scales = det._grid_state(im_w, im_h)
    canvas = det._to_canvas(img)
    geom = model.spec.face_geom
    args = (model.plan, model.det_nets, geom, det.config,
            (geom.subimage_height, geom.subimage_width), canvas,
            model.det_clfs, state)
    kw = dict(pyramid=build_pyramid(canvas, pyr.scales, pyr.level_hw),
              crops=pyr.crops, pyr_scales=pyr_scales)
    reset_counts()
    want = cascade_mod.run_cascade(*args, **kw)
    launches_plain = counts()
    reset_counts()
    got = sharded_cascade(mesh1, *args, **kw)
    launches_sharded = counts()
    for name, a, b in zip(want._fields, got, want):
        if (a is None) != (b is None) or (a is not None
                                          and not torch.equal(a, b)):
            fail(f"sharded_cascade on a one-card mesh: {name} differs")
    cascade_calls = {"crop": 1, "gather": per_call(model.plan, 1)["gather"]
                     - eye_iters}
    print(f"sharded_cascade on a one-card mesh: every field equal to "
          f"run_cascade; launches {launches_sharded} (unsharded "
          f"{launches_plain})")
    if launches_sharded != launches_plain or launches_plain != cascade_calls:
        fail(f"sharded_cascade must launch {cascade_calls}")
    det1 = FaceDetector(model, DetectorConfig(), device=dev)
    # data_mesh=1 takes no mesh, as in the JAX package: the one-card mesh
    # is set here to drive the mesh path.
    det1._mesh = mesh1
    reset_counts()
    dets1 = det1.detect(img)
    launches_detect1 = counts()
    compare_lists("detect on a one-card mesh vs unsharded (exact)", [dets1],
                  [det.detect(img)], 0.0, conf_tol=0.0, attr_tol=0.0)
    if launches_detect1 != per_call(model.plan, 1):
        fail(f"detect on a one-card mesh launched {launches_detect1}")
    step_s["a_one_card"] = time.perf_counter() - t0

    # (b) fused batch on MESH_SHARDS shards against unsharded
    t0 = time.perf_counter()
    want_calls = per_call(model.plan, MESH_SHARDS)
    drift, launches_batch = {}, None
    for op in ("bf16", "f32"):
        cfg = DetectorConfig(wire_format="f32", matmul_dtype=op)
        plain = FaceDetector(model, cfg, device=dev)
        sharded = FaceDetector(model, cfg, device=dev)
        sharded._mesh = meshN                   # see meshN above
        want_b = plain.detect_batch(scenes)
        reset_counts()
        got_b = sharded.detect_batch(scenes)
        launches_batch = counts()
        print(f"detect_batch of {B} on {MESH_SHARDS} shards ({op} "
              f"operands): launches {launches_batch} per call (expected "
              f"{want_calls})")
        if launches_batch != want_calls:
            fail(f"a fused batch on {MESH_SHARDS} shards must launch "
                 f"{want_calls}")
        drift[op] = compare_drift(
            f"detect_batch on {MESH_SHARDS} shards vs unsharded (f32 wire, "
            f"{op} operands)", got_b, want_b, FUSED_VS_SEQUENTIAL_SHARE,
            FUSED_VS_SEQUENTIAL_PX[op])
    step_s["b_fused_batch"] = time.perf_counter() - t0

    # (c) stream against batch, both on the sharded detector
    t0 = time.perf_counter()
    detN = FaceDetector(model, DetectorConfig(), device=dev)
    detN._mesh = meshN                          # see meshN above
    batches = [scenes[: B // 2], scenes[B // 2:]]
    want_s = [detN.detect_batch(b) for b in batches]
    reset_counts()
    got_s = list(detN.detect_stream(iter(batches)))
    launches_stream = counts()
    if len(got_s) != len(batches):
        fail(f"detect_stream on {MESH_SHARDS} shards yielded {len(got_s)} "
             "batches")
    for i, (g, w) in enumerate(zip(got_s, want_s)):
        compare_lists(f"detect_stream on {MESH_SHARDS} shards, batch {i}, "
                      "vs detect_batch on them", g, w, 1e-3, attr_tol=1e-3)
    want_stream = {k: len(batches) * n for k, n in want_calls.items()}
    print(f"detect_stream on {MESH_SHARDS} shards: launches "
          f"{launches_stream} (expected {want_stream})")
    if launches_stream != want_stream:
        fail(f"detect_stream on {MESH_SHARDS} shards must launch "
             f"{want_stream}")
    step_s["c_stream"] = time.perf_counter() - t0

    # (d) train_network on the meshes against unsharded (one-latent set)
    t0 = time.perf_counter()
    lx, lu = latent_set(2000, 21)
    lx_held, lu_held = latent_set(500, 22)
    x = torch.from_numpy(lx).to(dev)
    fit_kw = dict(graph="serial", labels=lu, num_groups=50, verbose=False)
    meshes = {"one card": mesh1, f"{MESH_SHARDS} shards": meshN}
    nets = {"unsharded": trainer.train_network(
        builder.build_higsfa(64, top_dim=20), x, **fit_kw)}
    for name, mesh in meshes.items():
        nets[name] = trainer.train_network(
            builder.build_higsfa(64, top_dim=20), x, mesh=mesh, **fit_kw)
    first = nets["unsharded"]
    inp = first.specs[0].expansion(x[:, first.indices[0]]).double()
    want_m = moments.gsfa_moments(inp, "serial", labels=lu, num_groups=50)
    regs = {}
    for name, net in nets.items():
        clf = trainer.fit_regressor_bins(trainer._execute(net, x), lu, 10,
                                         50)
        regs[name] = clf.regression(torch.as_tensor(trainer._execute(
            net, torch.from_numpy(lx_held).to(dev))[:, :10])).numpy()
    span = float(np.ptp(lu_held))
    train_cmp = {}
    for name, mesh in meshes.items():
        got_m = moments.gsfa_moments(shard_batch(mesh, inp), "serial",
                                     labels=lu, num_groups=50)
        excess = max(exceeds(torch, a, b, 1e-4, 1e-5)
                     for a, b in zip(got_m, want_m))
        d = float(np.abs(regs[name] - regs["unsharded"]).max())
        corr = float(np.corrcoef(regs[name], regs["unsharded"])[0, 1])
        train_cmp[name] = {"moments_excess": excess, "reg_max_abs": d,
                           "reg_share_of_range": d / span, "reg_corr": corr}
        print(f"train_network on {name} vs unsharded (one-latent set, "
              f"build_higsfa(64, top_dim=20)): first-layer moments exceed "
              f"atol 1e-5 / rtol 1e-4 by {excess} (<= 0 passes); held-out "
              f"regression max |diff| {d} ({d / span:.6f} of the range, "
              f"gate {TRAIN_CARD_VS_CPU_REG}), correlation {corr:.8f} "
              f"(gate {TRAIN_CARD_VS_CPU_CORR})")
        if (excess > 0 or d > TRAIN_CARD_VS_CPU_REG * span
                or corr < TRAIN_CARD_VS_CPU_CORR):
            fail(f"train_network on {name} disagrees with unsharded")
    step_s["d_train_network"] = time.perf_counter() - t0

    # (e) the GSFA step on the card against the CPU
    t0 = time.perf_counter()
    xs = np.random.RandomState(1).randn(64, 8, 6).astype(np.float32)
    ref_mean, ref_W = train_step.gsfa_step(torch.from_numpy(xs), 3)
    mesh2d = Mesh(np.array([dev] * 8, dtype=object).reshape(4, 2),
                  ("data", "model"))
    step_cmp = {}
    for name, (mean, W) in (
            ("gsfa_step", train_step.gsfa_step(
                torch.from_numpy(xs).to(dev), 3)),
            ("sharded_gsfa_step 4x2", train_step.sharded_gsfa_step(
                mesh2d, xs, 3))):
        e_mean = exceeds(torch, mean, ref_mean, 1e-4, 1e-5)
        e_W = exceeds(torch, up_to_sign(torch, W, ref_W), ref_W, 1e-2, 1e-3)
        step_cmp[name] = {"mean_excess": e_mean, "W_excess": e_W}
        print(f"{name} on the card vs gsfa_step on the CPU: mean exceeds "
              f"rtol 1e-4 / atol 1e-5 by {e_mean}, W up to sign exceeds "
              f"rtol 1e-2 / atol 1e-3 by {e_W} (<= 0 passes)")
        if e_mean > 0 or e_W > 0:
            fail(f"{name} on the card disagrees with the CPU")
    step_s["e_gsfa_step"] = time.perf_counter() - t0

    # (f) apps.train on a one-card mesh, then detect on what it trained
    t0 = time.perf_counter()
    out_dir = os.path.join(tmp, "mesh_trained")
    argv = ["--quick", "--data_mesh=1", "--no_calibrate", "--out_dir",
            out_dir, "--real_frac=0", "--real_bg_frac=0",
            f"--device={dev.type}"]
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = train_app.main(argv)
    torch.cuda.synchronize()
    wall_train_main = time.perf_counter() - t0
    if rc != 0 or "sharded over a 1-device data mesh" not in text.getvalue():
        fail(f"apps.train.main({argv}) returned {rc} or trained off the "
             "mesh")
    trained = DetectionModel.load(out_dir, device=dev)
    det_t = FaceDetector(trained, DetectorConfig(), device=dev)
    reset_counts()
    dets_t = det_t.detect(scenes[0])
    launches_trained = counts()
    print(f"apps.train --quick --data_mesh=1: {wall_train_main:.1f} s; "
          f"detect on its directory: {len(dets_t)} detections, launches "
          f"{launches_trained}")
    if launches_trained != per_call(trained.plan, 1):
        fail(f"detect on the mesh-trained directory launched "
             f"{launches_trained}")
    step_s["f_apps_train"] = time.perf_counter() - t0

    # (g) the dry run on one card
    t0 = time.perf_counter()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        dryrun.dryrun_multichip(1, dev.type)
    for line in text.getvalue().splitlines():
        print(f"dryrun| {line}")
    step_s["g_dryrun"] = time.perf_counter() - t0

    # Wall times: one-card mesh against unsharded
    wall = {}
    for name, fn in (
            ("detect, unsharded", lambda: det.detect(img)),
            ("detect, one-card mesh", lambda: det1.detect(img)),
            (f"detect_batch {B}, unsharded", lambda: det.detect_batch(scenes)),
            (f"detect_batch {B}, one-card mesh",
             lambda: det1.detect_batch(scenes)),
            (f"detect_batch {B}, {MESH_SHARDS} shards",
             lambda: detN.detect_batch(scenes)),
            ("train_network, unsharded", lambda: trainer.train_network(
                builder.build_higsfa(64, top_dim=20), x, **fit_kw)),
            ("train_network, one-card mesh", lambda: trainer.train_network(
                builder.build_higsfa(64, top_dim=20), x, mesh=mesh1,
                **fit_kw)),
            (f"train_network, {MESH_SHARDS} shards",
             lambda: trainer.train_network(
                 builder.build_higsfa(64, top_dim=20), x, mesh=meshN,
                 **fit_kw))):
        times = wall_ms(torch, fn, warm)
        wall[name] = statistics.median(times)
        print(f"wall time ({name}): median {wall[name]:.3f} ms over {warm} "
              f"warm runs {[round(t, 3) for t in times]}")
    phase_s = time.perf_counter() - t_phase
    print(f"mesh phase: {phase_s:.1f} s; steps (s) "
          f"{ {k: round(v, 2) for k, v in step_s.items()} }")
    return {"shards": MESH_SHARDS, "launches_detect_one_card":
            launches_detect1, "launches_batch": launches_batch,
            "launches_stream": launches_stream,
            "launches_trained_detect": launches_trained,
            "drift": drift, "train_network": train_cmp,
            "gsfa_step": step_cmp, "wall_ms": wall,
            "wall_s_apps_train_quick": wall_train_main, "step_s": step_s,
            "phase_s": phase_s}


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
        from pyfaceanalysis_torch.ops import (
            cuda_crop,
            cuda_gather,
            cuda_net_layer,
        )
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
    # The layer kernel runs in every network forward, the "ref" routes'
    # included, so it is counted apart from the two pyramid kernels.
    layer = cuda_net_layer.KERNEL
    t0 = time.perf_counter()
    build_all(list(kernels.values()) + [layer])
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(kernels) + 1} "
          "kernels (nvcc in parallel; 0 when already built)")
    for name, k in {**kernels, "net_layer": layer}.items():
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
    state, n_real, pyr_info, scales = det._grid_state(im_w, im_h)
    if pyr_info is None:
        fail("the default grid has no pyramid path")
    canvas = det._to_canvas(img)
    pyramid = build_pyramid(canvas, pyr_info.scales, pyr_info.level_hw)
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
    state_b, n_real_b, pyr_b, scales_b = det._grid_state(im_w, im_h,
                                                         batch=B)
    stack = det._to_canvas_batch(scenes)
    pyramid_b = build_pyramid_batch(stack, pyr_b.scales, pyr_b.level_hw)
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
    errs = {"crop": 0.0, "gather": 0.0, "net_layer": 0.0}
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
    # The layer kernel: every network of the model, bf16 and float32
    # operands, on the grid's crops of one image and of the fused batch
    # (96x96 networks on uniform noise), held bit for bit to the plain path.
    layer_rows = {"single": crop_patches(pyramid, crops, (64, 64)),
                  "fused": crop_patches(pyramid_b, crops_b, (64, 64))}
    for label, p64 in layer_rows.items():
        n_rows = p64.shape[0]
        for net_name, net in sorted(model.nets.items()):
            hw = net.input_hw
            x = (p64.reshape(n_rows, -1) if hw == (64, 64) else
                 torch.rand(n_rows, hw[0] * hw[1], generator=g).to(dev))
            for cd in (torch.bfloat16, None):
                errs["net_layer"] = max(errs["net_layer"], net_layer_chain(
                    torch, net, x, cd, f"{net_name} {label} B={n_rows} {cd}"))
        print(f"check net_layer {label} B={n_rows}: the operand of every "
              f"layer and the output of {len(model.nets)} networks, bf16 "
              f"and float32, equal to the plain path bit for bit")
    del layer_rows
    # Its spow column on every float32 bit pattern, at each exponent of the
    # model's spow layers (the pow's shortcut at 0.8 falls back to
    # libdevice's pow where the rounding is close; other exponents take it).
    exponents = sorted({float(np.float32(spec.expansion.exponent))
                        for net in model.nets.values() for spec in net.specs
                        if spec.expansion.name == "spow"})
    chunk = 1 << 27
    for e in exponents:
        for lo in range(-(1 << 31), 1 << 31, chunk):
            xs = torch.arange(lo, lo + chunk, dtype=torch.int32,
                              device=dev).view(torch.float32)
            want = torch.sign(xs) * (torch.abs(xs).double()
                                     ** e).to(xs.dtype)
            if not torch.equal(
                    cuda_net_layer.spow_kernel(xs, e).view(torch.int32),
                    want.view(torch.int32)):
                fail(f"the layer kernel's spow at {e} differs from the "
                     f"plain path on the bit patterns {lo} .. {lo + chunk}")
        del xs, want
    print(f"check net_layer spow: all 2^32 float32 bit patterns at the "
          f"exponents {exponents} equal to the plain path bit for bit")

    # -- 4. one image, with attributes: kernels, then plain versions ----------
    det_ref = FaceDetector(model, DetectorConfig(pallas_refine="ref"),
                           device=dev)
    reset_counts()
    layer_before = layer.launches
    t0 = time.perf_counter()
    dets = det.detect(img)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = counts()
    layer_detect = layer.launches - layer_before
    print(f"detect (kernels): {det.windows_scanned} windows scanned, "
          f"{len(dets)} detections, first call {first_s * 1e3:.1f} ms, "
          f"launches {launches}, layer kernel {layer_detect}")
    if layer_detect == 0:
        fail("detect never launched the layer kernel")
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
    layer_before = layer.launches
    t0 = time.perf_counter()
    batch = det.detect_batch(scenes)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches_batch = counts()
    layer_batch = layer.launches - layer_before
    peak_batch = torch.cuda.max_memory_allocated()
    print(f"detect_batch of {B} (fused, kernels): "
          f"{sum(len(d) for d in batch)} detections, first call "
          f"{first_s * 1e3:.1f} ms, launches {launches_batch} (expected 1 "
          f"crop, {n_gathers} gathers), layer kernel {layer_batch}, peak "
          f"device memory {peak_batch / 1e6:.0f} MB")
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
    disc = model.nets["net_disc"]
    layer_1 = time_net_layer(torch, "single", disc, crop_patches(
        pyramid, crops, (64, 64)).reshape(crops.shape[0], -1),
        torch.bfloat16, 50)
    layer_b = time_net_layer(torch, "fused", disc, crop_patches(
        pyramid_b, crops_b, (64, 64)).reshape(rows_b, -1),
        torch.bfloat16, 20)
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
    # -- 9. training ------------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        train = train_phase(torch, scenes, reset_counts, counts, tmp)
    print(json.dumps({"train": train}))
    # -- 10. the data mesh ------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        mesh = mesh_phase(torch, model, det, scenes, reset_counts, counts,
                          tmp, args.warm, torch.device("cuda", 0))
    print(json.dumps({"mesh": mesh}))
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
            "launches_train": train["launches_main"][name],
            "launches_mesh": {"fused_batch": mesh["launches_batch"][name],
                              "one_card_detect":
                                  mesh["launches_detect_one_card"][name]},
            "fused": fused})
    entries.append({
        "name": "net_layer", "route": "cuda",
        "source": "pyfaceanalysis_torch/ops/csrc/net_layer.cu",
        "replaces": None, "max_abs_err": errs["net_layer"],
        "launches": layer_detect, "launches_fused_batch": layer_batch,
        "single": layer_1, "fused": layer_b})
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
