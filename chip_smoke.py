#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--warm K]

Phases (any failure exits non-zero; nothing is caught and skipped):

1. Builds the CUDA kernels of ``pyfaceanalysis_torch/ops/csrc`` (one nvcc
   per source, started together) and prints ptxas' register/memory report.
2. Loads ``SavedNetworksTPU/`` onto the card, renders a 1000x800 synthetic
   scene from ``--seed`` (random texture plus a few drawn faces) and takes
   the main path's kernel inputs from it: the pyramid and grid crops of
   the crop kernel; refinement-sized (512 and 256 rows) and eye-sized box
   batches (with out-of-level boxes and coarse-level boxes) for the gather
   kernel.
3. Holds each kernel against its plain PyTorch version on the card: crop
   exact (atol 0); gather nearest and bilinear at 64x64 and 96x96 within
   1e-5, rounding ties excluded, on a B=512 refinement batch (levels as a
   strided int32 column), a B=256 batch (int64 levels, angles over +-45
   degrees) and a B=128 eye batch. The gather computes its affine
   coefficients itself, so the count of output pixels that differ at all is
   reported inside and outside the tie mask (outside must be 0), and the
   coefficients are held bit for bit against ``pyramid_affine``.
4. Runs ``FaceDetector(model, device="cuda").detect(img,
   estimate_attributes=False)`` with the kernels on, launch counts set to
   0 just before and read just after; fails if a kernel was not launched.
   Then runs it again with ``pallas_refine="ref"`` (plain versions) and
   requires the same detections (1e-3 px, 1e-4 confidence).
5. Times ``detect`` (host clock around a synchronised call, median of
   ``--warm`` runs), and each kernel, its plain version and one PyTorch
   library call computing the same function in device time (the sum of
   their GPU kernels' durations in a ``torch.profiler`` trace; each kernel
   also between CUDA events around back-to-back calls), and
   computes each kernel's bound from this run's inputs (bytes over
   3.35 TB/s HBM, or float32 operations over 67 TFLOP/s). The same trace
   counts the GPU launches of one wrapper call: more than one fails.

The last lines are one JSON object ``{"kernels": [...]}``, the output of
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` and the
result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM peaks (NVIDIA data sheet; at the 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


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


def device_ms(torch, fn, iters: int):
    """Device time per call of ``fn`` and its GPU launches per call: the
    GPU kernels, copies and sets that ``iters`` warm calls run, read from a
    ``torch.profiler`` trace, as the sum over kernel names of (mean
    duration x launches per call). Host launch overhead, which exceeds a
    microsecond-scale kernel, stays out of the time, and an event the
    profiler drops at the edge of the window biases neither number."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.setdefault(e.name, []).append(e.time_range.elapsed_us())
    us = sum(statistics.fmean(d) * round(len(d) / iters)
             for d in spans.values())
    if us <= 0:
        fail(f"the profiler saw no device work in {iters} calls")
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


def profile_detect(torch, det, img, n: int) -> None:
    """Where a warm ``detect`` spends its time: wall time per call under
    ``torch.profiler``, the device's busy time (the summed durations of the
    GPU work; one stream, so they do not overlap), the idle share, and the
    GPU kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            det.detect(img, estimate_attributes=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    by_name: dict = {}
    count = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / n
            count += 1
    busy = sum(by_name.values())
    print(f"detect under the profiler: wall {wall_ms:.3f} ms/call, device "
          f"busy {busy:.3f} ms/call, idle share {1 - busy / wall_ms:.4f}, "
          f"{count / n:.0f} GPU launches/call")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  device {ms:.4f} ms/call  {name[:100]}")


def tie_mask(torch, coeffs, out_hw):
    """Output pixels whose level coordinate lies within 1e-4 of a .5
    rounding tie (nearest may legally round either way there)."""
    from pyfaceanalysis_torch.ops.patches import level_coords
    lx, ly = level_coords(coeffs, out_hw)
    return (((lx - torch.floor(lx) - 0.5).abs() < 1e-4)
            | ((ly - torch.floor(ly) - 0.5).abs() < 1e-4))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--warm", type=int, default=5)
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
        from pyfaceanalysis_torch.ops.patches import (
            level_coords,
            pyramid_affine,
            sample_patches_pyramid_ref,
        )
        from pyfaceanalysis_torch.ops.pyramid import (
            build_pyramid,
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

    # -- 2. model, scene, main-path inputs -----------------------------------
    model = DetectionModel.load(artifact_dir, device=dev)
    img = synthetic_scene(args.seed)
    det = FaceDetector(model, DetectorConfig(), device=dev)
    if det.config.detection_contrast_normalize is not True:
        fail("manifest calibration was not resolved")
    im_h, im_w = img.shape
    state, n_real, pyr_info = det._grid_state(im_w, im_h)
    if pyr_info is None:
        fail("the default grid has no pyramid path")
    canvas = det._to_canvas(img)
    pyramid = build_pyramid(canvas, pyr_info.scales, pyr_info.level_hw)
    scales = torch.tensor(pyr_info.scales, dtype=torch.float32, device=dev)
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

    # -- 3. kernels against their plain versions ------------------------------
    errs = {}
    got = cuda_crop.crop_patches_kernel(pyramid, crops, (64, 64))
    want = crop_patches(pyramid, crops, (64, 64))
    torch.cuda.synchronize()
    errs["crop"] = float((got - want).abs().max())
    print(f"check crop B={crops.shape[0]} 64x64: max_abs_err "
          f"{errs['crop']} (atol 0)")
    if errs["crop"] != 0.0:
        fail("crop kernel differs from crop_patches")
    errs["gather"] = 0.0
    for name, (lv, bx, an) in {"refine": (ref_levels, ref_boxes, ref_angles),
                               "rung2": (r2_levels, r2_boxes, r2_angles),
                               "eye": (eye_levels, eye_boxes, eye_angles)
                               }.items():
        for hw in ((64, 64), (96, 96)):
            # The kernel's own coefficients against their specification.
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
            for method in ("nearest", "bilinear"):
                got = cuda_gather.sample_patches_pyramid(
                    pyramid, scales, lv, bx, an, hw, method=method)
                want = sample_patches_pyramid_ref(pyramid, scales, lv, bx,
                                                  an, hw, method=method)
                torch.cuda.synchronize()
                diff = (got - want).abs()
                ties = tie_mask(torch, want_c, hw)
                n_tie = int(ties.sum())
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
                errs["gather"] = max(errs["gather"], err)

    # -- 4. main path through the kernels, then through the plain versions ---
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    dets = det.detect(img, estimate_attributes=False)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    print(f"main path (kernels): {det.windows_scanned} windows scanned, "
          f"{len(dets)} detections, first call {first_s * 1e3:.1f} ms, "
          f"launches {launches}")
    if level_samplers(det.config, dev) is None:
        fail("the default config does not route through the kernels")
    for name, n in launches.items():
        if n == 0:
            fail(f"the main path never launched the {name} kernel")

    def rows(ds):
        return np.asarray([(*d.box, d.angle, *d.eye_left, *d.eye_right,
                            d.confidence) for d in ds], np.float64)

    det_ref = FaceDetector(model, DetectorConfig(pallas_refine="ref"),
                           device=dev)
    for k in kernels.values():
        k.launches = 0
    dets_ref = det_ref.detect(img, estimate_attributes=False)
    if any(k.launches for k in kernels.values()):
        fail("the ref path launched a kernel")
    a, b = rows(dets), rows(dets_ref)
    if a.shape != b.shape:
        fail(f"kernel path found {len(a)} detections, ref path {len(b)}")
    if len(a):
        if not np.isfinite(a).all():
            fail("non-finite detection values")
        dpx = float(np.abs(a[:, :9] - b[:, :9]).max())
        dconf = float(np.abs(a[:, 9] - b[:, 9]).max())
        print(f"kernel path vs ref path: {len(a)} detections each, "
              f"max |d coord| {dpx} px, max |d conf| {dconf}")
        if dpx > 1e-3 or dconf > 1e-4:
            fail("kernel path and ref path detections differ")
    else:
        print("kernel path vs ref path: 0 detections each")
    for d in dets:
        print("detection:", json.dumps({
            "box": [round(v, 3) for v in d.box], "angle": round(d.angle, 3),
            "eye_left": [round(v, 3) for v in d.eye_left],
            "eye_right": [round(v, 3) for v in d.eye_right],
            "confidence": round(d.confidence, 5)}))

    # -- 5. timings and bounds -----------------------------------------------
    wall = {}
    for name, d in (("kernels", det), ("ref", det_ref)):
        times = []
        for _ in range(args.warm):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d.detect(img, estimate_attributes=False)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        wall[name] = statistics.median(times)
        print(f"detect wall time ({name} path): median {wall[name]:.3f} ms "
              f"over {args.warm} warm runs {[round(t, 3) for t in times]}")
    profile_detect(torch, det, img, args.warm)

    entries = []
    B = crops.shape[0]
    crop_bytes = 2 * B * 64 * 64 * 4 + B * 3 * 4
    crop_idx = (crops[:, 0].long()[:, None, None],
                (crops[:, 1].long()[:, None]
                 + torch.arange(64, device=dev))[:, :, None],
                (crops[:, 2].long()[:, None]
                 + torch.arange(64, device=dev))[:, None, :])
    crop_ms, crop_n = device_ms(torch, lambda: cuda_crop.crop_patches_kernel(
        pyramid, crops, (64, 64)), 100)
    crop_plain, _ = device_ms(torch, lambda: crop_patches(pyramid, crops,
                                                          (64, 64)), 50)
    crop_lib, _ = device_ms(torch, lambda: pyramid[crop_idx], 50)
    crop_ev = event_ms(torch, lambda: cuda_crop.crop_patches_kernel(
        pyramid, crops, (64, 64)), 100)
    print(f"crop B={B} 64x64: device {crop_ms:.6f} ms in {crop_n} GPU "
          f"launches per call, CUDA events {crop_ev:.6f} ms/call, bound "
          f"{crop_bytes / HBM_BYTES_PER_S * 1e3:.6f} ms")
    entries.append({
        "name": "crop", "route": "cuda",
        "source": "pyfaceanalysis_torch/ops/csrc/crop.cu",
        "replaces": "pyfaceanalysis_tpu/ops/pallas_crop.py:73",
        "launches": launches["crop"], "launches_per_call": crop_n,
        "max_abs_err": errs["crop"],
        "ms": crop_ms, "plain_ms": crop_plain,
        "bound_ms": crop_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": crop_lib})

    # Gather at the refinement shape (nearest 64x64, as the main path):
    # bytes = distinct texels the samples read + the outputs + the per-patch
    # inputs; operations = the ~12 flops of the affine map per output pixel
    # plus ~60 per patch for its coefficients.
    hw = (64, 64)
    coeffs = pyramid_affine(scales, ref_levels, ref_boxes, ref_angles, hw)
    lx, ly = level_coords(coeffs, hw)
    ix, iy = torch.round(lx).long(), torch.round(ly).long()
    inb = (ix >= 0) & (ix < lw) & (iy >= 0) & (iy < lh)
    flat_idx = (ref_levels.long()[:, None, None] * lh + iy) * lw + ix
    texels = int(torch.unique(flat_idx[inb]).numel())
    n_out = n_ref * hw[0] * hw[1]
    g_bytes = texels * 4 + n_out * 4 + n_ref * (4 * 4 + 4 + 4) + L * 4
    g_flops = 12 * n_out + 60 * n_ref
    g_bound = max(g_bytes / HBM_BYTES_PER_S, g_flops / FP32_FLOPS_PER_S)
    g_by = ("bytes" if g_bytes / HBM_BYTES_PER_S >= g_flops / FP32_FLOPS_PER_S
            else "operations")
    gather_ms, gather_n = device_ms(
        torch, lambda: cuda_gather.sample_patches_pyramid(
            pyramid, scales, ref_levels, ref_boxes, ref_angles, hw), 100)
    if gather_n > 1:
        fail(f"one gather wrapper call made {gather_n} GPU launches")
    gather_plain, plain_n = device_ms(
        torch, lambda: sample_patches_pyramid_ref(
            pyramid, scales, ref_levels, ref_boxes, ref_angles, hw), 30)
    # Library yardstick: one 3-D grid_sample over the stacked levels, with
    # the sampling grid precomputed (align_corners maps -1..1 to texel
    # centres 0..n-1; the level axis lands exactly on a level).
    grid = torch.stack([lx / (lw - 1) * 2 - 1, ly / (lh - 1) * 2 - 1,
                        (ref_levels.float()[:, None, None] / (L - 1) * 2 - 1
                         ).expand_as(lx)], dim=-1)[None]
    vol = pyramid[None, None]
    gather_lib, _ = device_ms(torch, lambda: torch.nn.functional.grid_sample(
        vol, grid, mode="nearest", padding_mode="zeros",
        align_corners=True), 50)
    gather_ev = event_ms(torch, lambda: cuda_gather.sample_patches_pyramid(
        pyramid, scales, ref_levels, ref_boxes, ref_angles, hw), 100)
    print(f"gather B={n_ref} 64x64 nearest: device: wrapper {gather_ms:.6f} "
          f"ms in {gather_n} GPU launch per call (plain version "
          f"{gather_plain:.6f} ms in {plain_n}), grid_sample "
          f"{gather_lib:.6f} ms, bound {g_bound * 1e3:.6f} ms by {g_by} "
          f"({texels} distinct texels read); CUDA events {gather_ev:.6f} "
          f"ms/call (wrapper)")
    # The other shapes of the main path, for the record (not in the JSON).
    for label, (lv, bx, an), shape, method in (
            ("rung2", (r2_levels, r2_boxes, r2_angles), (64, 64), "nearest"),
            ("eye", (eye_levels, eye_boxes, eye_angles), (64, 64), "nearest"),
            ("refine", (ref_levels, ref_boxes, ref_angles), (96, 96),
             "bilinear")):
        ms, n = device_ms(
            torch, lambda: cuda_gather.sample_patches_pyramid(
                pyramid, scales, lv, bx, an, shape, method), 100)
        print(f"gather {label} B={bx.shape[0]} {shape[0]}x{shape[1]} "
              f"{method}: device {ms:.6f} ms in {n} GPU launch per call")
        if n > 1:
            fail(f"one gather wrapper call ({label}) made {n} GPU launches")
    entries.append({
        "name": "gather", "route": "cuda",
        "source": "pyfaceanalysis_torch/ops/csrc/gather.cu",
        "replaces": "pyfaceanalysis_tpu/ops/pallas_gather.py:145",
        "launches": launches["gather"], "launches_per_call": gather_n,
        "max_abs_err": errs["gather"],
        "ms": gather_ms, "plain_ms": gather_plain,
        "bound_ms": g_bound * 1e3, "bound_by": g_by,
        "library_ms": gather_lib})
    torch.cuda.synchronize()

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
