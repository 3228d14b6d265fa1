"""The port's Adam (``train/adam.py``, ``ops/kernels/adam.py``) on the CPU.

The kernel's plain version against ``torch.optim.Adam`` and against the JAX
package's ``default_optimizer`` (``optax.adam``) on shared numpy inputs;
``default_optimizer``'s class, groups and state; checkpoints between the
port's class and ``torch.optim.Adam``; the options the kernel leaves out.
The kernel itself is held to the plain version on the card in
``tests/test_torch_adam_cuda.py``.

The plain version computes the bias corrections as torch's capturable path
does, in float32 (``1 - b^t`` from a float32 power: at small ``t`` the
difference keeps only a few digits of the power's rounding, up to ~3e-5 of
itself), where ``torch.optim.Adam`` on the CPU and ``optax.adam`` take them
otherwise.  So the parameters are held to the others within that share of
their steps, and the moments, which no bias correction touches, at rtol 1e-6.
"""

import types

import numpy as np
import pytest
import torch

import gsplat_tpu_torch as gt
from gsplat_tpu_torch.io.checkpoint import restore_checkpoint, save_checkpoint
from gsplat_tpu_torch.ops.kernels import adam as kadam
from gsplat_tpu_torch.train.adam import Adam
from gsplat_tpu_torch.train.params import FIELDS

RATES = {"pos": 1.6e-4, "quat": 1e-3, "log_scale": 5e-3, "logit_opacity": 5e-2, "color": 2.5e-3,
         "sh": 2.5e-3 / 20.0}
SHAPES = {"pos": (3,), "quat": (4,), "log_scale": (3,), "logit_opacity": (), "color": (3,), "sh": (45,)}
# Share of a leaf's summed step sizes by which the float32 bias correction
# may move its parameters (see the module's docstring).
BIAS_SHARE = 5e-5


def _leaves(n, seed):
    rng = np.random.default_rng(seed)
    return {f: rng.standard_normal(SHAPES[f] + (n,)).astype(np.float32) for f in FIELDS}


def _grads(n, steps, seed):
    rng = np.random.default_rng(seed)
    return [{f: rng.standard_normal(SHAPES[f] + (n,)).astype(np.float32) for f in FIELDS} for _ in range(steps)]


class PlainAdam:
    """The plain version driven as an optimizer: state per leaf, zeroed by
    :meth:`zero`."""

    def __init__(self, arrays):
        self.p = {f: torch.from_numpy(a.copy()) for f, a in arrays.items()}
        self.m = {f: torch.zeros_like(t) for f, t in self.p.items()}
        self.v = {f: torch.zeros_like(t) for f, t in self.p.items()}
        self.s = {f: torch.zeros(()) for f in self.p}

    def step(self, grads):
        kadam.fused_adam([self.p[f] for f in FIELDS], [torch.from_numpy(grads[f]) for f in FIELDS],
                         [self.m[f] for f in FIELDS], [self.v[f] for f in FIELDS], [self.s[f] for f in FIELDS],
                         [(RATES[f], 0.9, 0.999, 1e-8) for f in FIELDS])

    def zero(self):
        for d in (self.m, self.v, self.s):
            for t in d.values():
                t.zero_()


def test_plain_update_matches_torch_adam():
    """Six leaves of the port's shapes (N = 37: no length a multiple of 4),
    per-field rates; 5 steps, the state zeroed (the bias correction starts
    again), 2 more."""
    n = 37
    start = _leaves(n, 0)
    grads = _grads(n, 7, 1)
    plain = PlainAdam(start)
    leaves = {f: torch.from_numpy(a.copy()).requires_grad_(True) for f, a in start.items()}
    ref = torch.optim.Adam([{"params": [leaves[f]], "lr": RATES[f]} for f in FIELDS], betas=(0.9, 0.999), eps=1e-8)
    for k, g in enumerate(grads):
        if k == 5:
            plain.zero()
            for st in ref.state.values():
                for t in st.values():
                    t.zero_()
        plain.step(g)
        for f in FIELDS:
            leaves[f].grad = torch.from_numpy(g[f])
        ref.step()
    for f in FIELDS:
        st = ref.state[leaves[f]]
        torch.testing.assert_close(plain.m[f], st["exp_avg"], rtol=1e-6, atol=0)
        torch.testing.assert_close(plain.v[f], st["exp_avg_sq"], rtol=1e-6, atol=0)
        assert float(plain.s[f]) == float(st["step"]) == 2.0
        torch.testing.assert_close(plain.p[f], leaves[f].detach(), rtol=1e-6, atol=BIAS_SHARE * 7 * RATES[f])


def test_plain_update_matches_optax_adam():
    """The JAX package's ``default_optimizer`` (``optax.multi_transform`` of
    ``optax.adam``) on the same start and gradients, 5 steps: optax adds
    the moments as ``(1 - b) g + b m`` and divides by the bias corrections
    before the square root, so each step may differ by a few float32
    roundings of itself beside the bias correction's share."""
    import jax.numpy as jnp
    import optax

    from gsplat_tpu.train import params as j_params
    from gsplat_tpu.train import trainer as j_trainer

    n = 37
    start = _leaves(n, 2)
    grads = _grads(n, 5, 3)
    plain = PlainAdam(start)
    jp = j_params.SplatParams(**{f: jnp.asarray(a) for f, a in start.items()})
    jopt = j_trainer.default_optimizer()
    jstate = jopt.init(jp)
    for g in grads:
        plain.step(g)
        updates, jstate = jopt.update(j_params.SplatParams(**{f: jnp.asarray(a) for f, a in g.items()}), jstate, jp)
        jp = optax.apply_updates(jp, updates)
    for f in FIELDS:
        want = np.asarray(getattr(jp, f))
        np.testing.assert_allclose(plain.p[f].numpy(), want, rtol=1e-6, atol=BIAS_SHARE * 5 * RATES[f])


def test_default_optimizer_is_the_ports_adam():
    """``default_optimizer`` returns the port's class, still a
    ``torch.optim.Adam``: one group a field at its rate, ``capturable``
    exactly on CUDA parameters, torch's state keys after one step, which on
    CPU parameters is ``torch.optim.Adam.step`` itself."""
    params = gt.params_from_splats(gt.random_splats(torch.Generator().manual_seed(0), 8, device="cpu"))
    opt = gt.default_optimizer(params)
    assert type(opt) is Adam and isinstance(opt, torch.optim.Adam)
    assert [g["name"] for g in opt.param_groups] == list(FIELDS)
    assert [g["lr"] for g in opt.param_groups] == [RATES[f] for f in FIELDS]
    assert [g["capturable"] for g in opt.param_groups] == [False] * 6
    assert all(g["betas"] == (0.9, 0.999) and g["eps"] == 1e-8 for g in opt.param_groups)
    on_card = types.SimpleNamespace(device=torch.device("cuda"), as_dict=params.as_dict)
    assert [g["capturable"] for g in gt.default_optimizer(on_card).param_groups] == [True] * 6
    calls = []
    torch_step = torch.optim.Adam.step
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.optim.Adam, "step", lambda self, closure=None: calls.append(self) or torch_step(self))
        for p in params.as_dict().values():
            p.grad = torch.ones_like(p)
        opt.step()
    assert calls == [opt]
    for p in params.as_dict().values():
        st = opt.state[p]
        assert set(st) == {"step", "exp_avg", "exp_avg_sq"}
        assert st["step"].dtype == torch.float32 and st["step"].dim() == 0 and float(st["step"]) == 1.0


@pytest.mark.parametrize("save_with", ["port", "torch"])
def test_checkpoint_round_trip_between_the_classes(tmp_path, save_with):
    """Three steps with one class, ``save_checkpoint``, ``restore_checkpoint``
    into fresh parameters under the other class: the next step repeats
    exactly."""
    splats = gt.random_splats(torch.Generator().manual_seed(1), 16, device="cpu")
    grads = _grads(16, 4, 4)
    make = {"port": gt.default_optimizer,
            "torch": lambda p: torch.optim.Adam([{"params": [t], "lr": RATES[f], "name": f}
                                                 for f, t in p.as_dict().items()])}
    other = "torch" if save_with == "port" else "port"

    def step(params, opt, g):
        for f, t in params.as_dict().items():
            t.grad = torch.from_numpy(g[f]).clone()
        opt.step()

    params = gt.params_from_splats(splats)
    opt = make[save_with](params)
    for g in grads[:3]:
        step(params, opt, g)
    save_checkpoint(str(tmp_path), 3, params, opt)
    fresh = gt.params_from_splats(splats)
    fresh_opt = make[other](fresh)
    at, fresh, fresh_opt = restore_checkpoint(str(tmp_path), fresh, fresh_opt)
    assert at == 3
    step(params, opt, grads[3])
    step(fresh, fresh_opt, grads[3])
    for f in FIELDS:
        assert torch.equal(getattr(params, f), getattr(fresh, f)), f
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[getattr(params, f)][k], fresh_opt.state[getattr(fresh, f)][k]), (f, k)


@pytest.mark.parametrize("option, value", [("amsgrad", True), ("maximize", True), ("weight_decay", 1e-4),
                                           ("differentiable", True)])
def test_options_the_kernel_leaves_out_raise(option, value):
    """The constructor, and a group added later, raise on each option the
    kernel does not implement; nothing is routed elsewhere."""
    leaf = torch.zeros(4, requires_grad=True)
    with pytest.raises(ValueError, match=option):
        Adam([leaf], **{option: value})
    opt = Adam([leaf])
    with pytest.raises(ValueError, match=option):
        opt.add_param_group({"params": [torch.zeros(3, requires_grad=True)], option: value})


def test_wrapper_checks_its_leaves():
    """The wrapper raises on a dtype other than float32, a non-contiguous
    leaf, a shape that differs from its parameter's and a missing state."""
    p, g, m, v, s = torch.zeros(3, 5), torch.ones(3, 5), torch.zeros(3, 5), torch.zeros(3, 5), torch.zeros(())
    hyper = [(1e-3, 0.9, 0.999, 1e-8)]
    kadam.fused_adam([p], [g], [m], [v], [s], hyper)
    assert float(s) == 1.0 and float(p.abs().max()) > 0.0
    with pytest.raises(TypeError, match="float32"):
        kadam.fused_adam([p.double()], [g.double()], [m.double()], [v.double()], [s], hyper)
    with pytest.raises(ValueError, match="contiguous"):
        kadam.fused_adam([p.t()], [g.t()], [m.t()], [v.t()], [s], hyper)
    with pytest.raises(ValueError, match="shape"):
        kadam.fused_adam([p], [torch.ones(3, 4)], [m], [v], [s], hyper)
    with pytest.raises(ValueError, match="a leaf"):
        kadam.fused_adam([p], [g], [m], [v], [], hyper)
