"""Runs one cell of ``BENCHMARK.json`` once and prints one JSON line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. A run:

1. finds the cell in ``BENCHMARK.json``, its configuration
   (``configs/<name>.json``), its traffic mix (``mixes/<name>.json``), the
   mix's scene generator and request loop (``generators/<name>.py``,
   ``entries/<name>.py``) and its limits (``limits/<cell>.json``);
2. renders the mix's pool of scenes on the card from ``--seed`` and moves
   it to the host, as the API takes it;
3. loads the configuration's model, builds the detector, and warms the
   cell's own shapes through its own loop (set-up ends here: ``setup_s``
   runs from the start of this module);
4. measures for ``--seconds`` (``--trace 0``: the end-to-end metrics) or
   profiles a steady sub-window of the mix's ``trace_seconds``
   (``--trace 1``: the per-layer metrics, ``busy_s``, ``window_s`` and the
   breakdown);
5. reads the peak device memory, frees the detector, and holds a sample
   of the completed requests, drawn from the seed, against the plain
   reference (``reference/``), limit by limit;
6. prints the numbers compared, each beside its limit, as the last lines
   of standard error, and the result as the last line of standard output.

It exits non-zero and prints no result without a CUDA card, with fewer
cards than the cell asks for, when the program or its artifacts are not
in the checkout, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from portbench import core  # noqa: E402

BENCH = core.BENCH
ROOT = os.path.dirname(BENCH)
PROGRAM = "pyfaceanalysis_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "pyfaceanalysis_tpu")
# Requests of a run held against the reference.
SAMPLE = 16
# Caches of compilers the program may use, at fixed paths in the checkout.
CACHES = {"TRITON_CACHE_DIR": "triton",
          "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "nv"}


class Refused(RuntimeError):
    """The run cannot measure: no result is printed."""


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cell_files(name: str, root: str = ROOT, bench: str = BENCH) -> dict:
    """The cell, its configuration, mix and limits, found by name."""
    manifest = core.load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    return dict(
        manifest=manifest, cell=cell,
        config=core.load_json(core.find("configs", cell["config"], ".json",
                                        bench)),
        mix=core.load_json(core.find("mixes", cell["traffic"], ".json",
                                     bench)),
        limits=core.load_json(core.find("limits", name, ".json", bench)))


def cell_metrics(manifest: dict, cell: str, kind: str) -> List[dict]:
    """The ``kind`` ("end_to_end" or "per_layer") metrics a cell reports:
    those listing it, and those without a list whose moved metric it
    reports (the manifest's rule for a metric without ``workloads``)."""
    e2e = [m["name"] for m in manifest["end_to_end"]
           if cell in m.get("workloads", [cell])]
    out = []
    for m in manifest[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def metric_reader(name: str, bench: str = BENCH):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, or
    for ``<quantity>.<variant>`` without a file of its own (one quantity
    split by the end-to-end metric it moves), ``metrics/<quantity>.py``."""
    base = name.rsplit(".", 1)[0]
    if base != name and not os.path.isfile(
            os.path.join(bench, "metrics", name + ".py")):
        name = base
    return core.load_module("metrics", name, bench)


def make_pool(mix: dict, seed: int, device, bench: str = BENCH):
    """The mix's pool of scenes from ``seed`` and the run's request
    order."""
    import numpy as np
    gen = core.load_module("generators", mix["generator"], bench)
    pool = gen.render(mix, seed, int(mix["pool"]), device)
    order = [int(i) for i in np.random.default_rng(
        [seed, 0]).permutation(len(pool))]
    return pool, order


def make_detector(config: dict, device):
    """The program's detector for a configuration."""
    from pyfaceanalysis_torch.config import DetectorConfig
    from pyfaceanalysis_torch.engine.detector import (
        DetectionModel,
        FaceDetector,
    )
    fields = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in config["detector"].items()}
    model = DetectionModel.load(os.path.join(ROOT, config["artifacts"]),
                                device=device)
    return FaceDetector(model, DetectorConfig(**fields), device=device)


def make_loop(det, mix: dict, pool, order, bench: str = BENCH):
    """The mix's request loop over ``pool``, warmed."""
    entry = core.load_module("entries", mix["entry"], bench)
    loop = entry.Loop(det, pool, order, mix)
    loop.warm()
    return loop


def reference_detector(config: dict, device, cascade=None,
                       precision: str = "f32"):
    from portbench.reference.detect import ReferenceDetector, Settings
    from portbench.reference.model import load_model
    model = load_model(os.path.join(ROOT, config["artifacts"]), device)
    settings = Settings.resolve(config["detector"], model.calibration)
    return ReferenceDetector(model, settings, device,
                             cascade_precision=cascade, precision=precision)


def sample(window: core.Window, seed: int, n: int = SAMPLE
           ) -> List[core.Request]:
    """Up to ``n`` completed requests, drawn from the seed by their index
    over the whole window."""
    import numpy as np
    reqs = window.requests
    rng = np.random.default_rng([seed, 1])
    pick = rng.choice(len(reqs), size=min(n, len(reqs)), replace=False)
    return [reqs[i] for i in sorted(pick)]


def judge(reqs: List[core.Request], pool, ref, limits: dict,
          texels: Optional[list] = None):
    """The reference's detections of the sampled requests' scenes, the
    numbers compared and whether each is within its limit. With
    ``texels`` (a list) the reference's per-call texel counts of each
    scene are appended to it."""
    from portbench.reference import compare
    # The reference's answer depends on the scene alone.
    by_scene: Dict[int, tuple] = {}
    want = []
    for r in reqs:
        if r.scene not in by_scene:
            ref.texels = [] if texels is not None else None
            by_scene[r.scene] = (ref.detect(pool[r.scene]), ref.texels)
        dets, counted = by_scene[r.scene]
        want.append(dets)
        if texels is not None:
            texels.append(counted)
    numbers = compare.compare([r.dets for r in reqs], want,
                              compare.label_ranges(ref.model))
    lim = {k: float(v["limit"]) for k, v in limits["numbers"].items()}
    seen = {"requests": len(reqs),
            "program_detections": sum(len(r.dets) for r in reqs),
            "reference_detections": sum(len(w) for w in want)}
    # Nothing compared is nothing shown correct.
    return numbers, lim, bool(reqs) and compare.judge(numbers, lim), seen


def _launch_counters():
    from pyfaceanalysis_torch.ops import cuda_crop, cuda_gather
    return lambda: {"crop": cuda_crop.KERNEL.launches,
                    "gather": cuda_gather.KERNEL.launches}


KERNELS = {"crop": ("crop_kernel",), "gather": ("gather_kernel",
                                                "coeffs_kernel")}


def run(workload: str, seed: int, seconds: float, trace: bool,
        device="cuda", root: str = ROOT, bench: str = BENCH) -> dict:
    """One run of a cell; returns the result line's object."""
    import torch

    files = cell_files(workload, root, bench)
    cell, mix, config = files["cell"], files["mix"], files["config"]
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise Refused("CUDA is not available")
        if torch.cuda.device_count() < int(cell["chips"]):
            raise Refused(f"{torch.cuda.device_count()} CUDA devices, the "
                          f"cell asks for {cell['chips']}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    threads = config.get("assumed", {}).get("torch_threads")
    if dev.type == "cuda" and threads:
        torch.set_num_threads(int(threads))
    import pyfaceanalysis_torch
    if not os.path.abspath(pyfaceanalysis_torch.__file__).startswith(
            os.path.join(ROOT, PROGRAM)):
        raise Refused(f"{PROGRAM} is not this checkout's "
                      f"({pyfaceanalysis_torch.__file__})")
    build = os.path.join(ROOT, PROGRAM, "_build")
    cold = not (os.path.isdir(build) and any(
        f.endswith(".so") for f in os.listdir(build)))
    sync = (torch.cuda.synchronize if dev.type == "cuda" else lambda: None)

    phases = {"imports_s": time.perf_counter() - T_START}
    t = time.perf_counter()
    pool, order = make_pool(mix, seed, dev, bench)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    phases["pool_s"] = time.perf_counter() - t
    t = time.perf_counter()
    det = make_detector(config, dev)
    phases["model_s"] = time.perf_counter() - t
    t = time.perf_counter()
    loop = make_loop(det, mix, pool, order, bench)
    phases["warm_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - T_START
    tr = None
    if trace:
        from portbench import trace as trace_mod
        seconds = float(mix["trace_seconds"])
        win, tr = trace_mod.traced(lambda span: loop.run(seconds, span),
                                   _launch_counters(), KERNELS, sync, log)
    else:
        win = loop.run(seconds)
        setup_s = win.t0 - T_START
    sync()
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
            else 0)
    loop.close()
    del loop, det
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_detector(config, dev)
    reqs = sample(win, seed)
    texels: Optional[list] = [] if trace else None
    numbers, limits, correct, seen = judge(reqs, pool, ref,
                                           files["limits"], texels)
    # A request that raises ends the run without a result; a wrong one
    # shows in the sample's numbers, which are judged as a whole.
    failed = 0

    manifest = files["manifest"]
    metrics: Dict[str, dict] = {}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": int(cell["chips"]), "memory_peak_bytes": peak}
    out = {"correct": bool(correct),
           "attempted": len(win.requests),
           "failed": failed}
    if not trace:
        for m in cell_metrics(manifest, workload, "end_to_end"):
            reader = core.load_module("e2e", m["name"], bench)
            value = reader.read(win, setup_s)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    elif tr is not None:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        ctx = Context(files["mix"], ref, win, tr, texels,
                      device_info["kind"])
        for m in cell_metrics(manifest, workload, "per_layer"):
            reader = metric_reader(m["name"], bench)
            value = reader.read(ctx) if tr.whole else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["breakdown"] = tr.breakdown()
    out["metrics"] = metrics
    out["device"] = device_info
    out["setup"] = dict(cold_build=cold, setup_s=setup_s, **phases)
    out["sample"] = seen
    if trace:
        out["trace"] = {"window_s": tr.window_s if tr else None,
                        "whole": bool(tr and tr.whole),
                        "requests": len(win.requests)}
    out["sample"]["numbers"] = numbers
    out["check"] = {k: {"value": numbers[k], "limit": v}
                    for k, v in limits.items()}
    return out


class Context:
    """What a per-layer metric reads: the trace, the traced window and its
    images and faces, the model's operations for them, the kernels'
    least bytes per call, and the card's peaks."""

    def __init__(self, mix, ref, win, tr, texels, kind):
        from portbench import work
        self.mix = mix
        self.trace, self.window = tr, win
        self.images = len(win.requests)
        self.faces = sum(len(r.dets) for r in win.requests)
        peaks = core.load_json(os.path.join(BENCH, "peaks.json"))
        self.peaks = peaks.get(kind)
        model, s = ref.model, ref.s
        h, w = int(self.mix["height"]), int(self.mix["width"])
        grid = ref.grid(w, h)
        # Linear in the faces returned: a per-image and a per-face part.
        base = work.flops_per_image(model, s, grid, 0.0)
        per_face = work.flops_per_image(model, s, grid, 1.0) - base
        self.flops = self.images * base + self.faces * per_face
        hw = (model.face.subimage_height, model.face.subimage_width)
        b = int(self.mix.get("batch", 1))
        self.crop_bytes = (work.crop_bytes(grid, s, b, hw)
                           if grid.scales is not None else None)
        self.gather_bytes = None
        if texels and grid.scales is not None:
            per_call = [statistics.fmean(t[i] for t in texels)
                        for i in range(len(texels[0]))]
            self.gather_bytes = work.gather_bytes(model, grid, s, b,
                                                  per_call, hw)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(BENCH, ".cache", sub)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    try:
        out = run(args.workload, args.seed, args.seconds, bool(args.trace))
    except (Refused, FileNotFoundError, ImportError) as e:
        log(f"no result: {e}")
        return 2
    bad = forbidden_modules()
    if bad:
        log(f"no result: loaded {', '.join(bad)}")
        return 3
    for name, c in out["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
