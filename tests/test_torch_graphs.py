"""The compiled step (``gsplat_tpu_torch/graphs.py``, ``make_train_step``): the
port's counterpart of ``jax.jit``.

On the CPU the step stays eager and is held to the JAX package's jitted step
on shared numpy inputs; its overflow warning is read one call late (the
deferred read), once, as the JAX step's callback warns once; the graph's
bookkeeping (launch counters, the optimizer's ``capturable`` switch, the
render's host read under capture) is checked without a card.  The tests
marked ``gpu`` capture on the card and skip here:

    python -m pytest --noconftest tests/test_torch_graphs.py -q -m gpu
"""

import dataclasses
import logging
import types

import numpy as np
import pytest
import torch

import gsplat_tpu_torch as gt
from gsplat_tpu_torch import graphs
from gsplat_tpu_torch.ops import binning
from gsplat_tpu_torch.ops.kernels import composite as kcomp
from gsplat_tpu_torch.ops.kernels import scan as kscan
from gsplat_tpu_torch.ops.kernels import segsum as ksegsum
from gsplat_tpu_torch.train import trainer as t_trainer
from gsplat_tpu_torch.train.params import FIELDS
from gsplat_tpu_torch.utils.logging import get_logger

CPU = "cpu"


def _jax_fit_case(budget=None):
    """A perturbed 40-splat scene, its 48x48 target and the config, from
    the JAX package (imported here: the card's machine has no JAX)."""
    import jax
    import jax.numpy as jnp

    import gsplat_tpu as gj
    from gsplat_tpu.train import params as j_params

    cfg = gj.RenderConfig(tile_capacity=512, transmittance_eps=0.0, pair_budget_override=budget or 0)
    splats = gj.random_splats(jax.random.PRNGKey(3), 40, extent=0.6, sh_scale=0.1)
    cam = gj.make_camera([0.3, 0.2, 2.4], [0, 0, 0], 48, 48)
    img = gj.render_tiles(splats, cam, dataclasses.replace(cfg, pair_budget_override=0))
    target = img[..., :3] + (1.0 - img[..., 3:4])
    moved = dataclasses.replace(
        splats,
        pos=splats.pos + 0.04 * jax.random.normal(jax.random.PRNGKey(4), (3, 40)),
        color=jnp.clip(splats.color + 0.2 * jax.random.normal(jax.random.PRNGKey(5), (3, 40)), 0.0, 1.0),
    )
    return j_params.params_from_splats(moved), cam, target, cfg


def _port_case(jp, jcam, target, jcfg):
    params = gt.params_from_numpy({f: np.asarray(getattr(jp, f)) for f in FIELDS}, device=CPU)
    cam = gt.camera_from_numpy(np.asarray(jcam.view), np.asarray(jcam.proj), jcam.width, jcam.height,
                               device=CPU)
    cfg = gt.RenderConfig(**dataclasses.asdict(jcfg))
    return params, cam, torch.from_numpy(np.array(target)), cfg


def test_cpu_step_with_default_optimizer_tracks_the_jitted_jax_step():
    """On CPU tensors ``make_train_step`` is eager, and with
    ``default_optimizer`` (not capturable there) its five losses and the
    parameters stay within 1e-3 relative of the JAX package's ``jax.jit``
    step through ``render_tiles``."""
    from gsplat_tpu.train import trainer as j_trainer

    jp, jcam, target, jcfg = _jax_fit_case()
    params, cam, t, cfg = _port_case(jp, jcam, target, jcfg)
    jopt = j_trainer.default_optimizer()
    jstate = jopt.init(jp)
    jstep = j_trainer.make_train_step(jopt, jcam, jcfg, backend="tiles", lambda_dssim=0.2)
    want = []
    for _ in range(5):
        jp, jstate, loss = jstep(jp, jstate, target)
        want.append(float(loss))
    opt = gt.default_optimizer(params)
    assert not any(g["capturable"] for g in opt.param_groups)
    step = gt.make_train_step(opt, cam, cfg, backend="auto", lambda_dssim=0.2)
    got = [float(step(params, t)) for _ in range(5)]
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert got[-1] < got[0]
    for f in FIELDS:
        a = np.asarray(getattr(jp, f))
        assert np.abs(getattr(params, f).detach().numpy() - a).max() <= 1e-2 * max(1.0, np.abs(a).max()), f


def test_overflow_warns_once_through_the_deferred_read(caplog):
    """A pair budget far too small: the JAX step's callback warns once over
    three steps; the port's step warns once too, read at the start of the
    call after the one that dropped (never inside a call's render)."""
    from gsplat_tpu.train import trainer as j_trainer
    from gsplat_tpu.utils.logging import get_logger as j_get_logger

    jp, jcam, target, jcfg = _jax_fit_case(budget=64)
    params, cam, t, cfg = _port_case(jp, jcam, target, jcfg)
    j_get_logger("binning").reset_once("dropped_pairs")
    get_logger("binning").reset_once("dropped_pairs")

    def warnings(pkg):
        return [r for r in caplog.records
                if r.name == f"{pkg}.binning" and r.levelno == logging.WARNING and "pair budget" in r.getMessage()]

    caplog.set_level(logging.WARNING)
    jopt = j_trainer.default_optimizer()
    jstate = jopt.init(jp)
    jstep = j_trainer.make_train_step(jopt, jcam, jcfg, backend="tiles", lambda_dssim=0.2)
    for _ in range(3):
        jp, jstate, loss = jstep(jp, jstate, target)
        float(loss)
    assert len(warnings("gsplat_tpu")) == 1
    step = gt.make_train_step(gt.default_optimizer(params), cam, cfg, backend="auto", lambda_dssim=0.2)
    float(step(params, t))
    assert warnings("gsplat_tpu_torch") == []  # the first call's counter waits for the next call
    seen = []
    for _ in range(2):
        float(step(params, t))
        seen.append(len(warnings("gsplat_tpu_torch")))
    assert seen == [1, 1]
    assert "dropped" in warnings("gsplat_tpu_torch")[0].getMessage()


def test_default_optimizer_is_capturable_exactly_on_cuda():
    """``default_optimizer`` sets ``capturable`` from the parameters'
    device; ``make_train_step`` switches a user's optimizer on before any
    state exists and raises, naming ``capturable=True``, once it has state."""
    params = gt.params_from_splats(gt.random_splats(torch.Generator().manual_seed(0), 8, device=CPU))
    assert [g["capturable"] for g in gt.default_optimizer(params).param_groups] == [False] * 6
    on_card = types.SimpleNamespace(device=torch.device("cuda"), as_dict=params.as_dict)
    assert [g["capturable"] for g in gt.default_optimizer(on_card).param_groups] == [True] * 6
    fresh = torch.optim.Adam(list(params.as_dict().values()), lr=1e-3)
    t_trainer._require_capturable(fresh)
    assert fresh.param_groups[0]["capturable"] is True
    used = torch.optim.Adam(list(params.as_dict().values()), lr=1e-3)
    for p in params.as_dict().values():
        p.grad = torch.ones_like(p)
    used.step()
    with pytest.raises(ValueError, match="capturable=True"):
        t_trainer._require_capturable(used)
    sgd = torch.optim.SGD(list(params.as_dict().values()), lr=0.1)  # no such option: left as it is
    t_trainer._require_capturable(sgd)
    assert "capturable" not in sgd.param_groups[0]


def test_replay_adds_the_launches_its_capture_recorded(monkeypatch):
    """A replay adds each counter's move during the capture (here a fake
    graph's), the counters of every kernel module are read, and nothing
    else moves."""
    keys = graphs.counter_values()
    assert (kscan, "launches_by_kind", "max") in keys and (kcomp, "launches_bwd", None) in keys
    assert (ksegsum, "launches", None) in keys
    monkeypatch.setattr(kscan, "launches", 3)
    monkeypatch.setattr(kscan, "launches_by_kind", {"add": 1, "max": 2})
    monkeypatch.setattr(kcomp, "launches", 7)
    before = graphs.counter_values()
    replays = []
    fake = types.SimpleNamespace(replay=lambda: replays.append(1))
    moved = {(kscan, "launches", None): 2, (kscan, "launches_by_kind", "add"): 1,
             (kscan, "launches_by_kind", "max"): 1, (kcomp, "launches", None): 1}
    g = graphs.CapturedGraph(fake, "out", moved, 0)
    assert g.replay() == "out" and g.replay() == "out" and len(replays) == 2
    after = graphs.counter_values()
    assert (kscan.launches, kscan.launches_by_kind, kcomp.launches) == (7, {"add": 3, "max": 4}, 9)
    assert {k: v for k, v in after.items() if v != before[k]}.keys() == moved.keys()


def test_render_makes_no_host_read_while_captured(monkeypatch):
    """Under capture ``warn_if_dropped`` reads nothing (a host read is
    illegal there); outside it reads the counter as before."""

    class DeviceCounter:
        is_cuda = True

        def __int__(self):
            raise AssertionError("read on the host")

    binned = types.SimpleNamespace(dropped_pairs=DeviceCounter())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    binning.warn_if_dropped(binned, gt.RenderConfig())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    with pytest.raises(AssertionError, match="host"):
        binning.warn_if_dropped(binned, gt.RenderConfig())


# ----------------------------------------------------------------- on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the kernels have no CPU build")
    return "cuda"


def _scene(card, n=20000, w=320, h=200):
    g = torch.Generator(device=card).manual_seed(3)
    splats = gt.random_splats(g, n, extent=0.8, scale_range=(0.01, 0.03), sh_scale=0.1, device=card)
    cams = [gt.make_camera([0.2 + 0.3 * k, 0.4, 3.0], [0, 0, 0], w, h, device=card) for k in range(2)]
    cfg = gt.RenderConfig(payload_dtype="packed", transmittance_eps=1e-3, pairs_per_splat=8.0)
    return splats, cams, cfg


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["add", "max"])
def test_scan_capture_replays_bit_equal_across_epoch_wraps(card, kind):
    """A captured scan replayed with new inputs copied in: bit-equal to its
    plain version every time, across the device-side wrap (epoch end 3: the
    scratch is zeroed every second call), one launch counted a replay."""
    g = torch.Generator(device=card).manual_seed(11)
    hi, lo = (40, 0) if kind == "add" else (2**31 - 1, -(2**31))
    x = torch.randint(lo, hi, (300_001,), generator=g, device=card, dtype=torch.int64).to(torch.int32)
    kscan.set_epoch_end(3)
    try:
        graph = graphs.capture(lambda: kscan.scan_i32(x, kind))
        before = kscan.launches
        for _ in range(7):
            x.copy_(torch.randint(lo, hi, x.shape, generator=g, device=card, dtype=torch.int64))
            assert torch.equal(graph.replay(), kscan.scan_i32_plain(x, kind))
        assert kscan.launches == before + 7
    finally:
        kscan.set_epoch_end(None)


@pytest.mark.gpu
def test_captured_frame_equals_the_eager_frame_for_two_cameras(card):
    """One captured frame serves two cameras whose matrices are copied into
    the captured camera's tensors: each replay bit-equal to the eager
    ``render`` of that camera, 2 scans and 1 forward a replay."""
    splats, cams, cfg = _scene(card)
    live = gt.Camera(view=cams[0].view.clone(), proj=cams[0].proj.clone(), width=cams[0].width,
                     height=cams[0].height, derived_pos=cams[0].derived_pos.clone())
    graph = graphs.capture(lambda: gt.render(splats, live, cfg, with_stats=True))
    assert graph.launches[(kscan, "launches", None)] == 2 and graph.launches[(kcomp, "launches", None)] == 1
    for cam in (cams[1], cams[0], cams[1]):
        want = gt.render(splats, cam, cfg)
        for a, b in ((live.view, cam.view), (live.proj, cam.proj), (live.derived_pos, cam.derived_pos)):
            a.copy_(b)
        before = (kscan.launches, kcomp.launches)
        image, stats = graph.replay()
        assert (kscan.launches, kcomp.launches) == (before[0] + 2, before[1] + 1)
        assert torch.equal(image, want) and int(stats.dropped_pairs) == 0


@pytest.mark.gpu
def test_captured_step_losses_equal_the_eager_steps(card):
    """``make_train_step`` captures on its second call: five losses and the
    parameters after them bit-equal to the same four lines run eagerly
    with the same capturable optimizer from the same start; 4 scans, 1
    checkpointed forward, 1 backward and 1 segment sum a call."""
    from gsplat_tpu_torch.train.loss import render_loss

    splats, cams, cfg = _scene(card)
    with torch.no_grad():
        img = gt.render(splats, cams[1], cfg)
    target = torch.clamp(img[..., :3] + (1.0 - img[..., 3:4]), 0.0, 1.0)
    params = gt.params_from_splats(splats)
    step = gt.make_train_step(gt.default_optimizer(params), cams[0], cfg)
    before = (kscan.launches, kcomp.launches_checkpoint, kcomp.launches_bwd, ksegsum.launches)
    got = [float(step(params, target)) for _ in range(5)]
    after = (kscan.launches, kcomp.launches_checkpoint, kcomp.launches_bwd, ksegsum.launches)
    assert after == (before[0] + 20, before[1] + 5, before[2] + 5, before[3] + 5)
    eager_params = gt.params_from_splats(splats)
    opt = gt.default_optimizer(eager_params)
    want = []
    for _ in range(5):
        opt.zero_grad(set_to_none=True)
        out = gt.render(gt.splats_from_params(eager_params), cams[0], cfg)
        loss = render_loss(out[..., :3] + (1.0 - out[..., 3:4]), target, 0.2)
        loss.backward()
        opt.step()
        want.append(float(loss.detach()))
    assert got == want and got[-1] < got[0]
    for f in FIELDS:
        assert torch.equal(getattr(params, f), getattr(eager_params, f)), f
