#!/usr/bin/env python3
"""The benchmark of gsplat_tpu_torch on NVIDIA GPUs: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Set-up builds the cell's inputs from the
seed, fits the program to them and warms up every shape the window uses;
the window measures for ``--seconds``; the outputs are then compared with
the plain reference (``reference/``).  The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, traced, ``breakdown``; ``checks`` comes last, each number
compared beside its limit, and the same goes to standard error.  Build and
kernel caches live under ``benchmark/.cache``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CACHE = HERE / ".cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["GSPLAT_TPU_TORCH_BUILD_DIR"] = str(CACHE / "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(HERE), str(HERE.parent)]

    import torch

    from harness import spec

    cell = spec.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        sys.stderr.write(f"benchmark: the cell needs {cell.chips} CUDA device(s), found {found}\n")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from harness import bench

    result = bench.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    loaded = bench.forbidden_modules()
    if loaded:
        sys.stderr.write(f"benchmark: JAX or the JAX package was loaded: {loaded}\n")
        return 3
    for name, c in result["checks"].items():
        sys.stderr.write(f"check {name} = {c['value']!r} (limit {c['limit']!r})\n")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
