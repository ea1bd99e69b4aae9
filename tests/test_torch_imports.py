"""Import hygiene of the PyTorch port: every module of
``pyfaceanalysis_torch`` imports in a fresh interpreter without pulling in
``jax`` or the JAX package and without touching a card.
"""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "pyfaceanalysis_torch")


def _modules():
    names = []
    for root, dirs, files in os.walk(PACKAGE):
        dirs[:] = sorted(d for d in dirs if d not in ("__pycache__", "_build",
                                                      "csrc"))
        for fn in sorted(files):
            if not fn.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, fn), REPO)[:-3]
            parts = rel.split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            names.append(".".join(parts))
    return names


MODULES = _modules()

_PROBE = """
import importlib, sys
importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'pyfaceanalysis_tpu'))
assert not bad, bad
import torch
assert not torch.cuda.is_initialized()
"""


def test_module_list_holds_the_command_line_layer():
    assert len(MODULES) == len(set(MODULES)) > 40
    assert {"pyfaceanalysis_torch", "pyfaceanalysis_torch.apps",
            "pyfaceanalysis_torch.apps.detect",
            "pyfaceanalysis_torch.apps.normalize",
            "pyfaceanalysis_torch.apps.frgc",
            "pyfaceanalysis_torch.apps.camera",
            "pyfaceanalysis_torch.engine.evaluation",
            "pyfaceanalysis_torch.viz",
            "pyfaceanalysis_torch.utils.benchmark",
            "pyfaceanalysis_torch.utils.profiling",
            "pyfaceanalysis_torch.utils.compile_cache",
            "pyfaceanalysis_torch.parallel",
            "pyfaceanalysis_torch.parallel.multihost",
            "pyfaceanalysis_torch.ops.cuda_gather"} <= set(MODULES)


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_without_jax(module, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", _PROBE, module], env=env,
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def _scripts():
    tools = os.path.join(REPO, "tools")
    return ["chip_smoke.py"] + sorted(
        os.path.join("tools", fn) for fn in os.listdir(tools)
        if fn.startswith("torch_") and fn.endswith(".py"))


@pytest.mark.parametrize("script", _scripts())
def test_script_imports_nothing_of_jax(script):
    """The card-side scripts run where the JAX package is not used: no
    import statement of theirs names ``jax`` or the JAX package."""
    with open(os.path.join(REPO, script)) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "torch" in roots
    assert not roots & {"jax", "jaxlib", "pyfaceanalysis_tpu"}
