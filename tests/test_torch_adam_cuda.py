"""The Adam kernel (``csrc/adam.cu``) on the card: against its plain version
and against ``torch.optim.Adam(capturable=True)``, eagerly and captured in
``make_train_step``.

These need one CUDA card and nvcc, so they carry the ``gpu`` marker and skip
where there is none (the decision is taken inside the fixture).  Run them on a
machine with a card:

    python -m pytest --noconftest tests/test_torch_adam_cuda.py -q

Tolerances: the kernel, the plain version run on the card and torch's
capturable path compute the same float32 formula with the same powers, so
they may differ only where a compiler contracts or rounds an operation
otherwise (ATen divides by a Python number as a product with its
reciprocal): each moment within 4 ulp of itself; each parameter, whose
update may differ by a few ulp of its size (at most the rate) and then round
to the other neighbour, within 1 ulp of itself plus 4 ulp of its rate for
every step taken.
"""

import gc

import pytest
import torch

import gsplat_tpu_torch as gt
from gsplat_tpu_torch.ops.kernels import adam as kadam
from gsplat_tpu_torch.train.params import FIELDS

pytestmark = pytest.mark.gpu

ULP = 2.0 ** -23
RATES = (1.6e-4, 1e-3, 5e-3, 5e-2, 2.5e-3, 1.25e-4, 1e-2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return "cuda"


def _close(got, want, lr=None, steps=0, label=""):
    tol = 4 * ULP * want.abs() if lr is None else steps * (ULP * want.abs() + 4 * ULP * lr)
    bad = (got - want).abs() > tol
    worst = float((got - want).abs().max())
    assert not bool(bad.any()), f"{label}: {int(bad.sum())} values beyond tolerance, worst {worst}"


def _leaves(n, g, dev):
    """Six leaves of the port's shapes, and a seventh of n + 3 elements."""
    shapes = [(3, n), (4, n), (3, n), (n,), (3, n), (45, n), (n + 3,)]
    return [torch.randn(s, generator=g, device=dev) for s in shapes]


def _copies(leaves):
    """Copies of the leaves, the last one 4 bytes past a 16-byte boundary
    (all of it through the kernel's scalar loop)."""
    out = [t.clone() for t in leaves[:-1]]
    last = leaves[-1]
    out.append(torch.empty(last.numel() + 4, device=last.device)[1:1 + last.numel()].copy_(last))
    assert out[-1].data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize("n", [1, 1001, 4099, 2 ** 16])
def test_kernel_matches_plain_and_torch_capturable(card, n):
    """Seven leaves (tails, unaligned lengths, an unaligned pointer, the SH
    leaf), per-leaf rates: 5 steps, the state zeroed, 2 more; one launch
    a step."""
    g = torch.Generator(device=card).manual_seed(n)
    start = _leaves(n, g, card)
    hyper = [(lr, 0.9, 0.999, 1e-8) for lr in RATES]
    runs = {}
    for name in ("kernel", "plain"):
        p = _copies(start)
        runs[name] = (p, [torch.zeros_like(t) for t in p], [torch.zeros_like(t) for t in p],
                      [torch.zeros((), device=card) for _ in p])
    ref_p = [t.requires_grad_(True) for t in _copies(start)]
    ref = torch.optim.Adam([{"params": [t], "lr": lr} for t, lr in zip(ref_p, RATES)], capturable=True)
    before = kadam.launches
    for k in range(7):
        grads = [torch.randn(t.shape, generator=g, device=card) for t in start]
        if k == 5:
            for p, m, v, s in runs.values():
                for t in m + v + s:
                    t.zero_()
            for st in ref.state.values():
                for t in st.values():
                    t.zero_()
        kadam.fused_adam(runs["kernel"][0], grads, *runs["kernel"][1:], hyper)
        kadam.fused_adam_plain(runs["plain"][0], grads, *runs["plain"][1:], hyper)
        for t, gr in zip(ref_p, grads):
            t.grad = gr.clone()
        ref.step()
    torch.cuda.synchronize()
    assert kadam.launches == before + 7
    (kp, km, kv, ks), (pp, pm, pv, ps) = runs["kernel"], runs["plain"]
    for i, lr in enumerate(RATES):
        st = ref.state[ref_p[i]]
        assert float(ks[i]) == float(ps[i]) == float(st["step"]) == 2.0
        for label, want_m, want_v, want_p in (("plain", pm[i], pv[i], pp[i]),
                                              ("torch", st["exp_avg"], st["exp_avg_sq"], ref_p[i].detach())):
            _close(km[i], want_m, label=f"leaf {i} exp_avg against {label}")
            _close(kv[i], want_v, label=f"leaf {i} exp_avg_sq against {label}")
            _close(kp[i], want_p, lr, steps=7, label=f"leaf {i} param against {label}")


def _state_before(opt, t):
    """Copies of (param, exp_avg, exp_avg_sq, step) as they stand: zeros
    before the optimizer's first step."""
    st = opt.state.get(t) or {"exp_avg": torch.zeros_like(t), "exp_avg_sq": torch.zeros_like(t),
                              "step": torch.zeros((), device=t.device)}
    return t.detach().clone(), st["exp_avg"].clone(), st["exp_avg_sq"].clone(), st["step"].clone()


def test_captured_step_restarts_after_zeroed_state(card):
    """``make_train_step`` with ``default_optimizer``: three calls (eager,
    captured, replayed), the parameters restored and the state zeroed, three
    replays.  Each call's update, held against the plain version and against
    ``torch.optim.Adam(capturable=True)`` applied to the state before it
    with the gradients the call left (the graph's buffers), within the
    tolerance of one step; the kernel launches once a call; the second epoch
    repeats the first bit for bit (the bias correction starts again from the
    zeroed step).  (Whole trajectories are not compared with torch's:
    Adam scales each element's update to about its rate whatever its
    gradient's size, so an ulp that moves a pair across a tile's edge moves
    a later update by up to the rate.)"""
    g = torch.Generator(device=card).manual_seed(3)
    splats = gt.random_splats(g, 20000, extent=0.8, scale_range=(0.01, 0.03), sh_scale=0.1, device=card)
    cam = gt.make_camera([0.2, 0.4, 3.0], [0, 0, 0], 320, 200, device=card)
    other = gt.make_camera([0.5, 0.4, 3.0], [0, 0, 0], 320, 200, device=card)
    cfg = gt.RenderConfig(payload_dtype="packed", transmittance_eps=1e-3, pairs_per_splat=8.0)
    with torch.no_grad():
        img = gt.render(splats, other, cfg)
    target = torch.clamp(img[..., :3] + (1.0 - img[..., 3:4]), 0.0, 1.0)
    params = gt.params_from_splats(splats)
    start = {f: t.detach().clone() for f, t in params.as_dict().items()}
    opt = gt.default_optimizer(params)
    rates = [grp["lr"] for grp in opt.param_groups]
    step = gt.make_train_step(opt, cam, cfg)
    before = kadam.launches
    epochs = []
    for _ in range(2):
        with torch.no_grad():
            for f, t in params.as_dict().items():
                t.copy_(start[f])
                for s in opt.state.get(t, {}).values():
                    s.zero_()
        losses = []
        for _ in range(3):
            leaves = list(params.as_dict().values())
            prior = [_state_before(opt, t) for t in leaves]
            losses.append(float(step(params, target)))
            grads = [t.grad.clone() for t in leaves]
            plain = [tuple(x.clone() for x in leaf) for leaf in prior]
            kadam.fused_adam_plain([q[0] for q in plain], grads, [q[1] for q in plain], [q[2] for q in plain],
                                   [q[3] for q in plain], [(lr, 0.9, 0.999, 1e-8) for lr in rates])
            ref = [q[0].clone().requires_grad_(True) for q in prior]
            ref_opt = torch.optim.Adam([{"params": [t], "lr": lr} for t, lr in zip(ref, rates)],
                                       betas=(0.9, 0.999), eps=1e-8, capturable=True)
            for t, q, gr in zip(ref, prior, grads):
                ref_opt.state[t] = {"step": q[3].clone(), "exp_avg": q[1].clone(), "exp_avg_sq": q[2].clone()}
                t.grad = gr
            ref_opt.step()
            for i, (t, lr) in enumerate(zip(leaves, rates)):
                st = opt.state[t]
                for label, want in (("plain", plain[i][:3]),
                                    ("torch", (ref[i].detach(), ref_opt.state[ref[i]]["exp_avg"],
                                               ref_opt.state[ref[i]]["exp_avg_sq"]))):
                    _close(st["exp_avg"], want[1], label=f"{FIELDS[i]} exp_avg against {label}")
                    _close(st["exp_avg_sq"], want[2], label=f"{FIELDS[i]} exp_avg_sq against {label}")
                    _close(t.detach(), want[0], lr, steps=1, label=f"{FIELDS[i]} param against {label}")
        epochs.append((losses, {f: t.detach().clone() for f, t in params.as_dict().items()}))
    assert kadam.launches == before + 6
    assert step.graph is not None
    assert epochs[0][0] == epochs[1][0]
    for f in FIELDS:
        assert torch.equal(epochs[0][1][f], epochs[1][1][f]), f
    # The step refers to itself, so only the collector frees its graph: free
    # it here, not inside the next test's capture.
    del step
    gc.collect()


@pytest.mark.parametrize("fault", ["non_contiguous", "float64", "bfloat16"])
def test_wrapper_raises_on_a_leaf_it_does_not_take(card, fault):
    """A CUDA leaf that is not contiguous float32 raises before any launch."""
    p = torch.zeros(3, 64, device=card)
    leaf = {"non_contiguous": lambda t: t.t(), "float64": lambda t: t.double(),
            "bfloat16": lambda t: t.to(torch.bfloat16)}[fault]
    before = kadam.launches
    with pytest.raises((TypeError, ValueError)):
        kadam.fused_adam([leaf(p)], [leaf(torch.ones_like(p))], [leaf(torch.zeros_like(p))],
                         [leaf(torch.zeros_like(p))], [torch.zeros((), device=card)], [(1e-3, 0.9, 0.999, 1e-8)])
    assert kadam.launches == before
