"""On the card: one short run of a cell through the command the driver
runs, and its result line as the contract reads it."""

import json
import subprocess
import sys

import pytest

from harness.spec import ROOT


@pytest.mark.gpu
def test_a_short_run_is_correct(card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "trained_1m.serve", "--seed",
                          "2147483659", "--seconds", "1", "--trace", "0"], cwd=str(ROOT), capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu" and res["metrics"]["frame_ms"]["value"] > 0
