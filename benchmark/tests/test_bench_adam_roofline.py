"""The optimizer's roofline reader: 28 B an element over a splat's 59
float32 elements, read alike from torch's multi-tensor kernels and from
the port's own Adam kernels, and nothing read where nothing ran."""

import pytest

from harness import bench

from test_bench_metrics import ctx


@pytest.mark.parametrize("kernel", [
    "fused_adam_kernel",
    "adam_count_kernel",
    "multi_tensor_apply_kernel<3>",            # torch.optim.Adam's, read alike
])
def test_adam_roofline(kernel):
    t = 1e-5
    want = 100.0 * (28 * 59 * 1000 / 3.35e12) / t
    assert bench.read_metric("adam_roofline", ctx({kernel: t})) == pytest.approx(want)
    assert bench.read_metric("adam_roofline", ctx({})) is None
    assert bench.read_metric("adam_roofline", ctx({kernel: t}, counts=None)) is None
