"""Each per-layer metric's reader: its operations and bytes at small
shapes, and nothing read where there is nothing to read."""

import json

import pytest

from harness import bench, roofline
from harness.spec import HERE, ROOT


class FakeTrace:
    def __init__(self, times):
        self.times = times

    def kernel_s(self, *subs):
        return sum(t for n, t in self.times.items() if any(s in n for s in subs))


def ctx(times, **facts):
    base = dict(busy_s=0.9, window_s=1.0, submit_us=42.0, pool_bytes=3 * 2 ** 20,
                counts={"splats": 1000, "pairs": 5000, "pairs_walked": 800, "live_pixel_updates": 100_000},
                render={"width": 64, "height": 32, "sh_order": 3})
    base.update(facts)
    return bench.LayerContext(FakeTrace(times), **base)


def test_share_prices_the_data_sheet():
    assert roofline.share(3.35e12, 0.0, 1.0) == pytest.approx(100.0)
    assert roofline.share(0.0, 67e12, 2.0) == pytest.approx(50.0)
    assert roofline.share(1.0, 1.0, 0.0) is None


@pytest.mark.parametrize("name, kernel, nbytes, flops", [
    ("project_fwd_roofline", "project_fwd_kernel<3>", 1000 * 300, 250 * 1000),
    ("project_bwd_roofline", "project_bwd_kernel<3>", 1000 * 528, 0),
    ("gather_payload_roofline", "gather_payload_kernel<0>", 1000 * 104, 0),
    ("scatter_payload_roofline", "scatter_payload_kernel", 1000 * 88, 0),
    ("composite_fwd_roofline", "composite_fwd_kernel<true>", 4 * 800 + 16 * 64 * 32, 24 * 100_000),
    ("composite_bwd_roofline", "composite_bwd_kernel<true>", 40 * 800 + 16 * 64 * 32, 49 * 100_000),
    ("segsum_roofline", "segsum_kernel<true>", 40 * 800 + 36 * 1000, 0),
])
def test_rooflines(name, kernel, nbytes, flops):
    t = 1e-5
    want = 100.0 * max(nbytes / 3.35e12, flops / 67e12) / t
    assert bench.read_metric(name, ctx({kernel: t})) == pytest.approx(want)
    assert bench.read_metric(name, ctx({})) is None            # the kernel did not run
    assert bench.read_metric(name, ctx({kernel: t}, counts=None)) is None


def test_times_idle_and_pool():
    assert bench.read_metric("sort_us.serve", ctx({"DeviceRadixSortOnesweepKernel": 2e-4})) == pytest.approx(200.0)
    assert bench.read_metric("ssim_conv_us.train", ctx({"conv_depthwise2d_forward": 1e-3})) == pytest.approx(1e3)
    assert bench.read_metric("adam_us.train", ctx({"multi_tensor_apply_kernel<3>": 5e-4})) == pytest.approx(500.0)
    assert bench.read_metric("adam_us.train", ctx({})) is None
    assert bench.read_metric("device_idle.serve", ctx({})) == pytest.approx(10.0)
    assert bench.read_metric("device_idle.train", ctx({}, busy_s=0.5)) == pytest.approx(50.0)
    assert bench.read_metric("graph_pool_mib", ctx({})) == pytest.approx(3.0)
    assert bench.read_metric("graph_pool_mib", ctx({}, pool_bytes=None)) is None
    assert bench.read_metric("host_submit_us.serve", ctx({})) == pytest.approx(42.0)


def test_every_per_layer_metric_has_its_reader():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_trace_window_busy_share_and_breakdown():
    from harness.trace import RANGE, Trace

    events = [{"ph": "X", "name": RANGE, "ts": 100, "dur": 100, "cat": "user_annotation"},
              {"ph": "X", "name": "k1", "ts": 110, "dur": 20, "cat": "kernel"},
              {"ph": "X", "name": "k2", "ts": 120, "dur": 30, "cat": "kernel"},
              {"ph": "X", "name": "k1", "ts": 170, "dur": 10, "cat": "kernel"},
              {"ph": "X", "name": "cudaStreamSynchronize", "ts": 150, "dur": 20, "cat": "cuda_runtime"},
              {"ph": "X", "name": "k0", "ts": 50, "dur": 10, "cat": "kernel"}]      # before the window
    t = Trace(events, calls=2, sessions=1, lost={})
    assert t.window_s == pytest.approx(1e-4)
    assert t.busy_s() == pytest.approx(5e-5)                 # 110-150 and 170-180
    assert t.kernel_s("k1") == pytest.approx(15e-6)          # 30 us over 2 calls
    b = t.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(3e-5)]
    assert dict((k, v) for k, v in b["idle_gaps"]) == {"host: between calls": pytest.approx(3e-5),
                                                      "cudaStreamSynchronize": pytest.approx(2e-5)}
