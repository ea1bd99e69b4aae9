"""The benchmark's modules load neither JAX nor the JAX package, and the
reference loads nothing of the program it judges (top-level module names
compared whole: the port's name begins with the JAX package's)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

PROBE = """
import sys
{imports}
top = {{m.split(".")[0] for m in sys.modules}}
print(",".join(sorted(top & {{"jax", "jaxlib", "flax", "pyfaceanalysis_tpu",
                             "pyfaceanalysis_torch"}})))
"""


def _loaded(imports: str) -> set:
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", PROBE.format(
        imports=imports)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300, check=True).stdout.strip()
    return set(out.split(",")) - {""}


def test_run_and_its_program_load_no_jax():
    loaded = _loaded("import portbench.run, portbench.calibrate, "
                     "portbench.trace, portbench.work\n"
                     "import pyfaceanalysis_torch.engine.detector")
    assert not loaded & {"jax", "jaxlib", "flax", "pyfaceanalysis_tpu"}


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded("import portbench.reference.detect, "
                     "portbench.reference.model, "
                     "portbench.reference.compare, portbench.work")
    assert loaded == set()


def test_forbidden_modules_compares_top_level_names_whole():
    from portbench import run as R
    fake = ("pyfaceanalysis_tpu_probe", "jaxprobe", "pyfaceanalysis_tpu.x")
    for name in fake:
        sys.modules[name] = sys
    try:
        assert R.forbidden_modules() == ["pyfaceanalysis_tpu"]
    finally:
        for name in fake:
            del sys.modules[name]
