"""Fixtures of the benchmark's tests: the benchmark's folder and the
checkout on the import path, cells cut to a size the CPU runs in seconds,
and the card where a test needs one (decided inside the fixture)."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness import spec  # noqa: E402

SEED = 2_147_483_659   # above 2**31, as the driver's seeds are


def tiny(name: str):
    """Cell ``name`` at a size the CPU runs in seconds: 3,000 splats at
    160x96 (96x64 for training), a few poses."""
    cell = spec.load(name)
    cell.config["scene"]["splats"] = 3000
    if cell.traffic["kind"] == "serve":
        cell.config["render"].update(width=160, height=96)
        cell.traffic.update(poses=6)
    else:
        cell.config["render"].update(width=96, height=64)
        cell.traffic.update(poses=4, target_grid=[6, 8], loss_every=2)
    return cell


@pytest.fixture
def tiny_cell():
    return tiny


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
