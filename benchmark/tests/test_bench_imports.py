"""Nothing the benchmark runs loads JAX or the JAX package: a whole run's
modules, compared by their top-level names whole (``gsplat_tpu_torch`` is
not ``gsplat_tpu``); and the reference loads nothing of the program."""

import json
import subprocess
import sys

from harness.spec import HERE

PROBE = """
import json, sys
sys.path[:0] = [{here!r}, {root!r}]
from conftest import tiny, SEED
from harness import bench
bench.run_cell(tiny("trained_1m.serve"), SEED, 0.1, False, "cpu")
bench.run_cell(tiny("trained_1m.train"), SEED, 0.1, False, "cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REF = """
import json, sys
sys.path[:0] = [{here!r}]
import reference.render, reference.train
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_names(code):
    out = subprocess.run([sys.executable, "-c", code.format(here=str(HERE), root=str(HERE.parent))],
                         cwd=str(HERE / "tests"), capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    names = _top_names(PROBE)
    assert "gsplat_tpu_torch" in names
    assert not names & set(__import__("harness.bench").bench.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    names = _top_names(REF)
    assert not names & {"gsplat_tpu_torch", "gsplat_tpu", "jax", "harness"}
