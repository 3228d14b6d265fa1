#!/usr/bin/env python3
"""Readings that set a cell's correctness limits, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...] [--control <k>]
                                   [--fault half_batch]

For each seed, in one process: one run of the cell as ``run.py`` makes it
(set-up, a window of ``--seconds``, the comparison of what the window
produced with the reference: the program's reading) and, on the first
``--control`` seeds, the control: the reference computed in bfloat16
against the reference in float32 on the same inputs.  ``--fault
half_batch`` plants a fault in the training step under test
(``harness/faults.py``).  One JSON line a seed.  The benchmark's own runs
never run the control or a fault.
"""

import argparse
import json
import os
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--fault", choices=("half_batch",))
    args = ap.parse_args(argv)
    os.environ["GSPLAT_TPU_TORCH_BUILD_DIR"] = str(HERE / ".cache" / "build")
    sys.path[:0] = [str(HERE), str(HERE.parent)]

    import torch

    from harness import bench, faults, spec

    if not torch.cuda.is_available():
        sys.stderr.write("calibrate: no CUDA device\n")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load(args.workload)
    if args.fault == "half_batch":
        from gsplat_tpu_torch.train import trainer

        trainer.render_loss = faults.half_batch(trainer.render_loss)
    for i, seed in enumerate(args.seeds):
        run, res = bench.execute(cell, seed, args.seconds, False, "cuda")
        line = {"seed": seed, "attempted": res["attempted"], "failed": res["failed"],
                "program": {k: c["value"] for k, c in res["checks"].items()}, "reference_s": res["reference_s"],
                "setup_s": res["metrics"]["setup_s"]["value"], "counts": getattr(run, "counts", None)}
        if i < args.control:
            line["control"] = run.control()
        print(json.dumps(line), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
