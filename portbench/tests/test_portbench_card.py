"""The benchmark on the card: one short run of a cell through the command
line, and the control at the cells' own size. These skip without a CUDA
card (``python -m pytest -m cuda portbench/tests`` on the card's
machine)."""

import json
import os
import subprocess
import sys

import pytest

from portbench import calibrate, core
from portbench.reference import compare

ROOT = os.path.dirname(core.BENCH)


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_prints_a_correct_result(trace):
    _card()
    done = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "shipped.single", "--seed", str(2 ** 31 + 99), "--seconds", "2",
         "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
        timeout=360)
    assert done.returncode == 0, done.stderr[-2000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["attempted"] > 0
    assert out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "check"
    if trace:
        assert out["device"]["busy_s"] > 0 and out["breakdown"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["shipped.stream16", "groupphoto.single"])
def test_control_fails_at_the_cells_own_size(cell):
    _card()
    rows, _ = calibrate.readings(cell, [], [5, 6, 7], 0)
    limits = {k: v["limit"] for k, v in core.load_json(os.path.join(
        core.BENCH, "limits", cell + ".json"))["numbers"].items()}
    for row in rows:
        assert not compare.judge({k: row[k] for k in compare.NUMBERS},
                                 limits), row
