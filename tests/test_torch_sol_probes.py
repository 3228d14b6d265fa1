"""The measurement path on the CPU: ``utils/profiling.py``, the H100
speed-of-light model (``utils/sol.py``) and the plain versions of the two
probe kernels (``ops/kernels/probes.py``), held against the same arithmetic
in numpy and in ``jnp`` — the FMA chain against the body of the JAX
package's ``vpu_rate`` probe (``scripts/sol_calibrate.py``), restated here.

Tolerances: the two float32 chains are bit-equal to numpy's (the fused one
is exact in float64 and rounded once); the ``expf`` chain (``e^(1 - acc)``,
numpy's float64 ``exp`` rounded once) within 1e-6 relative; the gather sums within 1e-9 of the summed magnitudes
(float64 in another order).  Times here are the CPU's and stand for nothing
on the card.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu_torch.ops.kernels import probes
from gsplat_tpu_torch.utils import profiling, sol

N, W, H = 1_000_000, 1920, 1080
BUDGET = 2_359_296


def test_phase_timer_trace_span_trace_files_and_fps(tmp_path):
    t = profiling.PhaseTimer()
    x = torch.ones(64)
    for _ in range(2):
        with t.phase("sort", block_on=x * 2):
            sum(range(1000))
    s = t.summary()
    assert s["sort"]["count"] == 2 and 0 <= s["sort"]["min_ms"] <= s["sort"]["max_ms"]
    with profiling.trace_span("projection"):
        pass
    profiling.start_trace(str(tmp_path))
    with profiling.trace_span("inside"):
        torch.ones(8).sum()
    path = profiling.stop_trace()
    assert "inside" in open(path).read()
    with pytest.raises(RuntimeError):
        profiling.stop_trace()
    r = profiling.measure_fps(lambda a: a * 2, torch.ones((8, 8)), iters=3, warmup=1)
    assert r["fps"] > 0 and r["iters"] == 3 and r["clock"] == "host"


def test_speed_of_light_is_positive_per_stage_and_monotone():
    fwd = sol.speed_of_light(N, W, H, BUDGET, fwd_only=True)
    full = sol.speed_of_light(N, W, H, BUDGET)
    assert all(ms > 0 for ms, _ in full["stages"].values())
    assert fwd["sol_ms"] <= full["sol_ms"]
    assert set(fwd["stages"]) < set(full["stages"])
    assert "payload gather" not in full["stages"] and "image unpack" not in full["stages"]
    for mode in ("beauty", "depth"):
        a = sol.speed_of_light(N, W, H, BUDGET, mode=mode)["sol_ms"]
        assert sol.speed_of_light(2 * N, W, H, BUDGET, mode=mode)["sol_ms"] > a
        assert sol.speed_of_light(N, W, H, 2 * BUDGET, mode=mode)["sol_ms"] > a
    assert sol.speed_of_light(N, W, H, BUDGET, True, mode="wire")["sol_ms"] > 0
    with pytest.raises(ValueError):
        sol.speed_of_light(N, W, H, BUDGET, fwd_only=False, mode="wire")


def test_compositor_bound_counts_issue_slots_above_the_flop_bound():
    pix = 847_609 * 1024
    b = sol.compositor_bound(pix, 0.0, sol.FWD_SLOTS["beauty"], 1, sol.FWD_FLOPS["beauty"])
    # an FMA counts two flops but takes one slot; the rest one each
    assert b["issue_datasheet_ms"] > b["flops_datasheet_ms"] > 0
    assert b["issue_slots"] == pix * (sol.FWD_SLOTS["beauty"] + sol.H100["expf_slots"])
    # measured rates below the data sheet's raise the bound
    slow = dict(sol.H100, f32_issue_rate=0.8 * sol.H100["f32_issue_rate_datasheet"])
    assert sol.compositor_bound(pix, 0.0, 17, 1, 24, slow)["issue_ms"] > b["issue_ms"]


def test_device_from_calibration_and_report():
    calib = {
        "card": "NVIDIA H100 80GB HBM3, 700.00 W",
        "alu": {"fma": {"links_per_s": 30e12}, "mul_add": {"links_per_s": 15e12},
                "expf": {"links_per_s": 3.7e12}, "sm_clock_hz": 1.75e9},
        "expf_sass_slots": 8.0,
        "hbm": {"bytes_per_s": 3.0e12}, "sort": {"pairs_per_s": 5e9},
        "gather": {"column": {"queries_per_s": 4e9}, "row": {"queries_per_s": 9e9}},
    }
    base = dict(sol.H100)
    dev = sol.device_from_calibration(calib)
    assert dev["f32_issue_rate"] == 30e12 and dev["measured_on"] == calib["card"]
    assert sol.H100 == base  # the base dictionary is not changed
    r = sol.report(N, W, H, BUDGET, achieved_ms=10.0, fwd_only=True, device=dev, pairs_walked=847_609)
    assert 0 < r["sol_fraction"] < 1 and r["sol_device"] == calib["card"]
    json.dumps(r)


def _numpy_chain(x, steps, variant):
    a, b = np.float32(probes.FMA_A), np.float32(probes.FMA_B)
    acc = np.stack([x * np.float32(1.0 + 0.001 * k) for k in range(probes.ILP)])
    for _ in range(steps):
        if variant == "mul_add":
            acc = (acc * a).astype(np.float32) + b
        elif variant == "fma":
            acc = (acc.astype(np.float64) * np.float64(a) + np.float64(b)).astype(np.float32)
        else:
            acc = np.exp(1.0 - acc.astype(np.float64)).astype(np.float32)
    out = acc[0]
    for k in range(1, probes.ILP):
        out = out + acc[k]
    return out


@pytest.mark.parametrize("variant", probes.ALU_VARIANTS)
def test_alu_probe_plain_matches_numpy(variant):
    x = np.random.default_rng(0).uniform(0.25, 0.75, 777).astype(np.float32)
    got = probes.alu_probe(torch.from_numpy(x), 200, variant).numpy()  # a CPU tensor: the plain version
    want = _numpy_chain(x, 200, variant)
    # both float32 chains exactly (the fused one is exact in float64 here)
    tol = 1e-6 if variant == "expf" else 0.0
    assert np.abs(got / want - 1.0).max() <= tol
    assert probes.launches[variant] == 0
    # The value depends on every link and on x, so a kernel that ran fewer
    # links, or lost its start, cannot match: one link less moves every
    # element by more than the tolerance, 1/50 of the links too, and nearly
    # every x gives its own value.
    for fewer in (199, 4):
        moved = np.abs(_numpy_chain(x, fewer, variant) / want - 1.0)
        assert moved.min() > tol, (fewer, moved.min())
    assert len(np.unique(want)) > 0.9 * x.size


def test_fma_chain_matches_the_body_of_jax_vpu_rate():
    """``vpu_rate``'s kernel body in ``jnp``: 8 accumulators x·(1 + 0.001k),
    ``STEPS`` links of ``a·1.0000001 + 0.0000001``, their sum."""
    steps = 512
    x = np.random.default_rng(1).uniform(0.5, 1.5, (8, 512)).astype(np.float32)

    def body(x):
        accs = [x * (1.0 + 0.001 * k) for k in range(8)]
        link = lambda i, a: tuple(v * 1.0000001 + 0.0000001 for v in a)
        accs = jax.lax.fori_loop(0, steps, link, tuple(accs))
        return sum(accs)

    want = np.asarray(jax.jit(body)(jnp.asarray(x))).ravel()
    err = {v: np.abs(probes.alu_probe_plain(torch.from_numpy(x.ravel()), steps, v).numpy() / want - 1.0).max()
           for v in ("fma", "mul_add")}
    # Each link adds about one ulp, so the rounding shows: XLA on the CPU
    # contracts the body into FMAs (the fused chain matches it), and the
    # separately rounded chain drifts from it by ~steps ulps.
    assert min(err.values()) <= 1e-6, err
    assert max(err.values()) > 1e-6, err


def test_gather_probe_plain_matches_numpy():
    rng = np.random.default_rng(2)
    n_cols, p = 4099, 20_011
    mat = rng.standard_normal((16, n_cols)).astype(np.float32)
    idx = rng.integers(0, n_cols, p).astype(np.int32)
    t_idx = torch.from_numpy(idx)
    for access in ("contiguous", "column", "row"):
        m = mat.T.copy() if access == "row" else mat
        got = float(probes.gather_probe(torch.from_numpy(m), t_idx, access))
        picked = mat[:, np.arange(p) % n_cols] if access == "contiguous" else mat[:, idx]
        want = picked.astype(np.float64).sum()
        assert abs(got - want) <= 1e-9 * np.abs(picked).astype(np.float64).sum(), access
        assert probes.gather_bytes(p, access) == p * 64 + (0 if access == "contiguous" else 4 * p)
    got = probes.gather_probe(torch.zeros((16, n_cols)), t_idx, "column_write").numpy()
    want = np.zeros_like(mat)
    want[:, idx] = (idx[None, :].astype(np.int64) * 16 + np.arange(16)[:, None]).astype(np.float32)
    assert np.array_equal(got, want)
    assert sum(probes.launches.values()) == 0


def test_probe_wrappers_raise_on_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        probes.alu_probe(torch.ones(4), 3, "fdiv")
    with pytest.raises(TypeError):
        probes.alu_probe(torch.ones(4, dtype=torch.float64), 3)
    with pytest.raises(TypeError):
        probes.gather_probe(torch.ones((8, 10)), torch.zeros(3, dtype=torch.int32), "column")
    with pytest.raises(TypeError):
        probes.gather_probe(torch.ones((16, 10)), torch.zeros(3, dtype=torch.int32), "row")
    with pytest.raises(ValueError, match="out-of-range"):
        probes.gather_probe(torch.ones((16, 10)), torch.full((3,), 10, dtype=torch.int32), "column")
