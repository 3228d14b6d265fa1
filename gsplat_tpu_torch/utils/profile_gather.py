"""Scattered against contiguous payload access on the card (counterpart of
``scripts/profile_dma_gather.py``): the four accesses of ``gather_probe``
(contiguous columns, the (16, N) column gather the compositors and the
segment sum make today, the (N, 16) row gather, the scattered column write)
on two index sets — the main path's own ``pair_splat`` at 1,000,000 splats
and 1920×1080 (nearly ascending within each tile's segment) and uniform
random columns — each beside ``torch.index_select`` on the same layout.

    python -m gsplat_tpu_torch.utils.profile_gather [--cols-log2 K]

``--cols-log2 K`` probes a (16, 2^K) matrix instead of (16, 2^20): at K = 18
(16 MB) the whole matrix sits in the card's 50 MB L2, so the gap between a
probe and its library call there says how much of it is the working set.
The path's indices are then taken modulo 2^K.

Prints one line per access and index set (ms, ns per query, bytes per
second) and, last, one JSON object with everything and the card's name and
power limit.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import sol_calibrate as cal


def random_indices(p: int = cal.SORT_PAIRS, n_cols: int = cal.N_COLS, seed: int = 1, device="cuda") -> torch.Tensor:
    """Uniform random columns, as the TPU probe draws them."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, n_cols, (p,), generator=g, device=device, dtype=torch.int32)


def profile(n_cols: int = cal.N_COLS) -> dict:
    """The four accesses on both index sets, over a (16, ``n_cols``) matrix."""
    pair_splat = cal.path_pair_splat()
    if n_cols < cal.N_COLS:
        pair_splat = pair_splat % n_cols
    return {
        "card": cal.card(),
        "path": cal.gather_rates(pair_splat.contiguous(), n_cols=n_cols),
        "random": cal.gather_rates(random_indices(pair_splat.numel(), n_cols=n_cols, device=pair_splat.device),
                                   n_cols=n_cols),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cols-log2", type=int, default=cal.N_COLS.bit_length() - 1,
                    help="probe a (16, 2^K) matrix (default 20)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.stderr.write("profile_gather: torch.cuda.is_available() is False - this measures the card\n")
        return 1
    if not 1 <= args.cols_log2 <= 20:
        sys.stderr.write("profile_gather: --cols-log2 must lie in [1, 20]\n")
        return 2
    res = profile(1 << args.cols_log2)
    for which in ("path", "random"):
        r = res[which]
        print(f"{which}: {r['queries']} queries over {r['columns']} columns")
        for access in ("contiguous", "column", "row", "column_write"):
            a = r[access]
            print(f"  {access:13s} {a['ms']:8.4f} ms  {a['ns_per_query']:7.3f} ns/query  "
                  f"{a['bytes_per_s'] / 1e9:8.1f} GB/s  ({a['library']} {a['library_ms']:.4f} ms)")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
