"""The readings that a cell's correctness limits are set from, in one
process.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,...
        --control-seeds 7,8,9 [--seconds 3] [--out FILE]

For each of ``--seeds``: a pool from the seed, the cell's own loop over a
window of ``--seconds`` (the timed path at the cell's own load), and the
numbers of ``reference/compare.py`` for the run's sample -- the program's
readings, whose largest per number is the lower reading. For each of
``--control-seeds``: the same sample of scenes run through the control,
which is the reference put in the program's place one precision step
below the configuration (cascade operands float8 e4m3 for bfloat16, the
other products TF32 for float32), against the reference -- whose smallest
per number is the upper reading. Prints one JSON line per reading and a
summary line; ``--out`` writes them to a file too.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from portbench import run as R

CONTROL = {"cascade": "fp8", "precision": "tf32"}


def readings(workload: str, seeds, control_seeds, seconds: float,
             device="cuda", root: str = R.ROOT, bench: str = R.BENCH,
             control=CONTROL):
    import numpy as np
    import torch

    from portbench.reference import compare

    files = R.cell_files(workload, root, bench)
    mix, config = files["mix"], files["config"]
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    ref = R.reference_detector(config, dev)
    ranges = compare.label_ranges(ref.model)
    out = []
    if seeds:
        det = R.make_detector(config, dev)
        for seed in seeds:
            pool, order = R.make_pool(mix, seed, dev, bench)
            loop = R.make_loop(det, mix, pool, order, bench)
            win = loop.run(seconds)
            loop.close()
            sync()
            t = time.perf_counter()
            numbers, _, _, seen = R.judge(R.sample(win, seed), pool, ref,
                                          files["limits"])
            out.append(dict(kind="program", seed=seed, **numbers, **seen,
                            window_requests=len(win.requests),
                            reference_s=time.perf_counter() - t))
            print(json.dumps(out[-1]), flush=True)
        del det
    ctl = R.reference_detector(config, dev, cascade=control["cascade"],
                               precision=control["precision"])
    for seed in control_seeds:
        pool, _ = R.make_pool(mix, seed, dev, bench)
        rng = np.random.default_rng([seed, 1])
        scenes = sorted(rng.choice(len(pool), size=min(R.SAMPLE, len(pool)),
                                   replace=False))
        got = [ctl.detect(pool[i]) for i in scenes]
        want = [ref.detect(pool[i]) for i in scenes]
        numbers = compare.compare(got, want, ranges)
        out.append(dict(kind="control", seed=seed, **numbers,
                        requests=len(scenes),
                        program_detections=sum(len(g) for g in got),
                        reference_detections=sum(len(w) for w in want)))
        print(json.dumps(out[-1]), flush=True)
    summary = {"workload": workload}
    for name in compare.NUMBERS:
        prog = [r[name] for r in out if r["kind"] == "program"]
        ctrl = [r[name] for r in out if r["kind"] == "control"]
        summary[name] = {"lower": max(prog) if prog else None,
                         "upper": min(ctrl) if ctrl else None}
    if dev.type == "cuda":
        summary["card"] = torch.cuda.get_device_name(dev)
    return out, summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    for var, sub in R.CACHES.items():
        os.environ[var] = os.path.join(R.BENCH, ".cache", sub)
    if R.ROOT not in sys.path:
        sys.path.insert(0, R.ROOT)

    def ints(s):
        return [int(v) for v in s.split(",") if v]

    rows, summary = readings(args.workload, ints(args.seeds),
                             ints(args.control_seeds), args.seconds)
    print(json.dumps({"summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for r in rows + [{"summary": summary}]:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
