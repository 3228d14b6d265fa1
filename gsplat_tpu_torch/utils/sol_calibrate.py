"""Calibrate the constants of the H100 speed-of-light model (``utils/sol.py``)
on the card (counterpart of ``scripts/sol_calibrate.py``).

    python -m gsplat_tpu_torch.utils.sol_calibrate

Measures, each at the access pattern the pipeline uses:

* the float32 issue rate (``alu_probe`` "fma"), the separately rounded
  mul + add rate (the compositors' ``-fmad=false`` form) and the ``expf`` rate,
  with the SM clock that ``nvidia-smi`` reads while they run;
* the gather rate (``gather_probe``'s four accesses) on the main path's own
  ``pair_splat`` at 1,000,000 splats and 1920×1080 (``utils/profile_gather.py``
  adds random indices);
* ``torch.sort`` of (int32 key, int32 payload) at 2,359,296 — the binning's
  pair sort;
* the HBM rate of a 256 MB read and write.

Prints one JSON object with the card's name and power limit.  Needs one CUDA
card; nothing falls back to the CPU.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import torch

from ..ops.kernels import probes
from .profiling import cuda_time_ms

N_COLS = 1 << 20         # columns of the probed (16, N) matrix
SORT_PAIRS = 2_359_296   # the binning's pair budget at 1M splats, 1080p
HBM_BYTES = 256 << 20


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0].strip()


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return nvidia_smi("name,power.limit")


def sm_clock_hz() -> float:
    """The SM clock now (nvidia-smi ``clocks.sm``, e.g. "1980 MHz")."""
    return float(nvidia_smi("clocks.sm").split()[0]) * 1e6


def sm_clock_during(fn, calls: int) -> float:
    """The SM clock, read while ``calls`` queued calls of ``fn`` run."""
    for _ in range(calls):
        fn()
    clk = sm_clock_hz()
    torch.cuda.synchronize()
    return clk


def alu_rates(device="cuda", blocks_per_sm: int = 8, reps: int = 10, clock_window_s: float = 1.0,
              steps=(("fma", 8192), ("mul_add", 4096), ("expf", 2048))) -> dict:
    """The three ALU probes over one full wave of blocks (every SM busy),
    each launch some 0.6 ms.  The SM clock is read by nvidia-smi while a
    second batch of the same launches, ``clock_window_s`` long, runs."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n = sms * blocks_per_sm * probes.THREADS
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.rand((n,), generator=g, device=device) * 0.5 + 0.25
    out = {"threads": n, "sms": sms}
    clocks = []
    for variant, st in steps:
        def run():
            return probes.alu_probe(x, st, variant)

        ms, _ = cuda_time_ms(run, reps, warmup=1)
        clk = sm_clock_during(run, max(1, int(clock_window_s * 1e3 / ms)))
        clocks.append(clk)
        work = probes.alu_ops(n, st, variant)
        rate = work["links"] / (ms / 1e3)
        out[variant] = {"steps": st, "ms": ms, "links": work["links"], "links_per_s": rate,
                        "links_per_sm_clock": rate / (sms * clk), "sm_clock_hz": clk}
        if "issue_slots" in work:
            out[variant]["issue_slots_per_s"] = work["issue_slots"] / (ms / 1e3)
            out[variant]["flops_per_s"] = work["flops"] / (ms / 1e3)
    out["sm_clock_hz"] = sum(clocks) / len(clocks)
    return out


def expf_sass_slots() -> float:
    """Instructions of one accurate expf in the compiled ``expf`` probe:
    the kernel's SASS (``cuobjdump``) between its first and last MUFU.EX2
    over the links between them, less the link's own subtraction — the
    issue slots one expf takes.  None where ``cuobjdump`` is missing."""
    from ..ops.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = _build.build_all() / "libprobes.so"
    try:
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=120).stdout
    except OSError:
        return None
    for block in sass.split("Function : ")[1:]:
        if "alu_probe_kernelILi2E" not in block.splitlines()[0]:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", block)
        mufu = sum(1 for o in ops if o.startswith("MUFU.EX2"))
        # the unrolled loop body holds the expf links; count only it: the
        # instructions between the first and the last MUFU, over the MUFUs
        # between them, is the steady-state cost of one link
        idx = [i for i, o in enumerate(ops) if o.startswith("MUFU.EX2")]
        if mufu < 2:
            return None
        span = [o for o in ops[idx[0]:idx[-1]] if o != "NOP"]
        return len(span) / (len(idx) - 1) - 1
    return None


def gather_rates(idx: torch.Tensor, n_cols: int = N_COLS, reps: int = 10, seed: int = 0) -> dict:
    """The four accesses of ``gather_probe`` on ``idx`` (int32 on the card),
    each held against its plain version, then timed beside
    ``torch.index_select`` on the same layout (``index_copy_`` for the
    write)."""
    dev = idx.device
    g = torch.Generator(device=dev).manual_seed(seed)
    mat = torch.randn((probes.PROBE_ROWS, n_cols), generator=g, device=dev)
    mat_t = mat.t().contiguous()
    dest = torch.zeros_like(mat)
    p = idx.numel()
    cols = torch.arange(p, device=dev, dtype=torch.int64) % n_cols
    idx64 = idx.long()
    src = torch.randn((probes.PROBE_ROWS, p), generator=g, device=dev)
    out = {"queries": p, "columns": n_cols}
    cases = (
        ("contiguous", mat, lambda: torch.index_select(mat, 1, cols)),
        ("column", mat, lambda: torch.index_select(mat, 1, idx64)),
        ("row", mat_t, lambda: torch.index_select(mat_t, 0, idx64)),
        ("column_write", dest, lambda: dest.index_copy_(1, idx64, src)),
    )
    out["max_abs_err"] = {}
    for access, m, library in cases:
        if access == "column_write":
            m.zero_()
        got = probes.gather_probe(m, idx, access)
        want = probes.gather_probe_plain(torch.zeros_like(m) if access == "column_write" else m, idx, access)
        if access == "column_write":
            ok = bool(torch.equal(got, want))
            err = 0.0 if ok else float((got - want).abs().max())
        else:  # float64 sums in another order: relative to the sum of |values|
            scale = float(probes.gather_probe_plain(m.abs(), idx, access))
            err = abs(float(got) - float(want))
            ok = err <= 1e-9 * max(scale, 1.0)
        if not ok:
            raise RuntimeError(f"gather_probe[{access}] differs from its plain version by {err}")
        out["max_abs_err"][access] = err
        ms, _ = cuda_time_ms(lambda: probes.gather_probe(m, idx, access), reps, warmup=1)
        lib_ms, _ = cuda_time_ms(library, reps, warmup=1)
        nbytes = probes.gather_bytes(p, access)
        out[access] = {"ms": ms, "ns_per_query": ms * 1e6 / p, "queries_per_s": p / (ms / 1e3),
                       "bytes": nbytes, "bytes_per_s": nbytes / (ms / 1e3),
                       "library_ms": lib_ms,
                       "library": "index_copy_" if access == "column_write" else "index_select"}
    return out


def sort_rate(p: int = SORT_PAIRS, reps: int = 10, device="cuda") -> dict:
    """``torch.sort`` of int32 keys with an int32 payload carried along (the
    binning's pair sort: stable sort, then the payload gathered by the
    returned order)."""
    g = torch.Generator(device=device).manual_seed(0)
    keys = torch.randint(0, 2**30, (p,), generator=g, device=device, dtype=torch.int32)
    payload = torch.arange(p, device=device, dtype=torch.int32)

    def run():
        k, order = torch.sort(keys, stable=True)
        return k, payload[order]

    ms, _ = cuda_time_ms(run, reps, warmup=1)
    return {"pairs": p, "ms": ms, "pairs_per_s": p / (ms / 1e3)}


def hbm_rate(nbytes: int = HBM_BYTES, reps: int = 10, device="cuda") -> dict:
    """Streaming read + write of ``nbytes`` (``torch.add`` into a second
    buffer)."""
    x = torch.ones((nbytes // 4,), device=device)
    y = torch.empty_like(x)
    ms, _ = cuda_time_ms(lambda: torch.add(x, 1.0, out=y), reps, warmup=1)
    return {"bytes": nbytes, "ms": ms, "bytes_per_s": 2 * nbytes / (ms / 1e3)}


def path_pair_splat(n: int = 1_000_000, width: int = 1920, height: int = 1080, seed: int = 0,
                    device="cuda") -> torch.Tensor:
    """The main path's ``pair_splat`` (tile-sorted pair → depth-rank column)
    for ``chip_smoke.py``'s scene: random splats from seed 0 seen from
    [0, 0.4, 3], packed payload, eps 1e-3, the budget tuned with 2 % room."""
    import gsplat_tpu_torch as gt
    from ..ops.binning import bin_splats
    from ..ops.projection import project_splats
    from ..ops.rasterize_ref import quantize_payload, sanitize_projected
    from ..ops.rasterize_tiles import sort_by_depth

    g = torch.Generator(device=device).manual_seed(seed)
    splats = gt.random_splats(g, n, extent=1.2, scale_range=(0.002, 0.01), sh_scale=0.1, device=device)
    cam = gt.make_camera(eye=[0.0, 0.4, 3.0], target=[0, 0, 0], width=width, height=height, device=device)
    cfg = gt.RenderConfig(payload_dtype="packed", transmittance_eps=1e-3)
    cfg = gt.tune_pair_budget(splats, [cam], cfg, headroom=1.02)
    p = project_splats(splats, cam, cfg.sh_order, tight_footprint=True)
    p = sort_by_depth(quantize_payload(sanitize_projected(p), cfg))
    return bin_splats(p, width, height, cfg, with_tiles=False).pair_splat


def calibrate(pair_splat: torch.Tensor = None) -> dict:
    """All rates of the model on the current card.  ``pair_splat``: the
    gather probe's indices, the main path's own (built by
    ``path_pair_splat`` when not given)."""
    if not torch.cuda.is_available():
        raise RuntimeError("sol_calibrate measures the card: torch.cuda.is_available() is False")
    if pair_splat is None:
        pair_splat = path_pair_splat()
    dev = pair_splat.device
    out = {"card": card(), "device": torch.cuda.get_device_name(0)}
    out["alu"] = alu_rates(dev)
    out["expf_sass_slots"] = expf_sass_slots()
    out["gather"] = gather_rates(pair_splat.contiguous())
    out["sort"] = sort_rate(device=dev)
    out["hbm"] = hbm_rate(device=dev)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        sys.stderr.write("sol_calibrate: torch.cuda.is_available() is False - this measures the card\n")
        return 1
    print(json.dumps(calibrate()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
