"""Adam's update (``kernels/adam.py``) on the CPU: the plain version
against ``torch.optim.Adam(capturable=False)``, the options the kernel
does not implement, the state it makes, and the training step's dispatch
(on the CPU ``optimizer.step()``, as before the kernel).

Tolerance: parameters and moments rtol 1e-6, the moments with an atol
of 1e-6 of the leaf's largest. The plain version computes the bias
corrections in float32 on the step tensor, as torch's capturable chain
does, where ``capturable=False`` computes them in double on the host:
the update moves by an ulp or two, under 1e-9 of a parameter near 1.
With weight decay that ulp of a parameter enters the next gradient, and
a moment that the decay's term nearly cancels carries it as a larger
share of itself. The kernel is held bit for bit to
``torch.optim.Adam(capturable=True)`` on the card by
``tests/test_torch_cuda.py``.
"""

import copy

import numpy as np
import pytest
import torch

import torch_port_helpers  # noqa: F401  (one intra-op thread)
from cpuperformanceraytracer_tpu_torch.config import RenderConfig
from cpuperformanceraytracer_tpu_torch.diff.grad import render_for_params
from cpuperformanceraytracer_tpu_torch.diff.inverse import (
    InverseProblem,
    make_train_step,
    make_train_step_k,
)
from cpuperformanceraytracer_tpu_torch.kernels.adam import adam, adam_step
from cpuperformanceraytracer_tpu_torch.scene.presets import scene_by_name
from cpuperformanceraytracer_tpu_torch.texture.procedural import gradient_sky
from cpuperformanceraytracer_tpu_torch.texture.texture import texture_from_array

# the main path's three leaves, the env cut to 3 x 1000 texels
SHAPES = ((11, 3), (7, 3), (1000, 3))
STEPS = 5


def _leaves(seed: int = 0):
    """Three float32 leaves of magnitude 0.5 to 1.5, either sign."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(((0.5 + rng.rand(*s)) * rng.choice([-1, 1], s))
                             .astype(np.float32)).requires_grad_()
            for s in SHAPES]


def _grads(seed: int = 1):
    """STEPS gradient sets, falling in size over the steps."""
    rng = np.random.RandomState(seed)
    return [[torch.from_numpy((rng.randn(*s) * 10.0 ** -k).astype(np.float32))
             for s in SHAPES] for k in range(STEPS)]


@pytest.mark.parametrize("weight_decay,maximize", [(0.0, False), (0.1, False),
                                                   (0.0, True), (0.1, True)])
@pytest.mark.parametrize("eps", [1e-8, 1e-2])
def test_plain_adam_matches_torch_adam(eps, weight_decay, maximize):
    """3 leaves over 5 steps: ``adam_step`` (on the CPU the plain version)
    against ``torch.optim.Adam(capturable=False)``, parameters, moments
    and steps."""
    opts = dict(lr=0.01, eps=eps, weight_decay=weight_decay, maximize=maximize)
    got, want = _leaves(), _leaves()
    opt_got = torch.optim.Adam(got, **opts)
    opt_want = torch.optim.Adam(want, **opts)
    for grads in _grads():
        for a, b, g in zip(got, want, grads):
            a.grad, b.grad = g.clone(), g.clone()
        adam_step(opt_got)
        opt_want.step()
    for a, b in zip(got, want):
        sa, sb = opt_got.state[a], opt_want.state[b]
        assert sa["step"].item() == sb["step"].item() == STEPS
        torch.testing.assert_close(a.detach(), b.detach(), rtol=1e-6, atol=0)
        for k in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(sa[k], sb[k], rtol=1e-6,
                                       atol=1e-6 * sb[k].abs().max().item())


def test_adam_step_makes_torch_state_and_round_trips():
    """The first step makes ``step`` (a float32 scalar), ``exp_avg`` and
    ``exp_avg_sq`` as torch's does; a leaf without a gradient is skipped;
    ``state_dict()`` loads into a fresh optimizer, which steps on
    identically."""
    got, want = _leaves(), _leaves()
    opt_got, opt_want = torch.optim.Adam(got), torch.optim.Adam(want)
    grads = _grads()
    for a, b, g in zip(got[:2], want[:2], grads[0]):
        a.grad, b.grad = g.clone(), g.clone()
    adam_step(opt_got)
    opt_want.step()
    assert got[2] not in opt_got.state and want[2] not in opt_want.state
    for a, b in zip(got[:2], want[:2]):
        sa, sb = opt_got.state[a], opt_want.state[b]
        assert list(sa) == list(sb) == ["step", "exp_avg", "exp_avg_sq"]
        for k in sa:
            assert (sa[k].dtype, sa[k].shape, sa[k].device) == (
                sb[k].dtype, sb[k].shape, sb[k].device), k
    again = [p.detach().clone().requires_grad_() for p in got]
    opt_again = torch.optim.Adam(again)
    opt_again.load_state_dict(copy.deepcopy(opt_got.state_dict()))
    for opt, leaves in ((opt_got, got), (opt_again, again)):
        for p, g in zip(leaves, grads[1]):
            p.grad = g.clone()
        adam_step(opt)
    for a, b in zip(got, again):
        assert torch.equal(a.detach(), b.detach())
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt_got.state[a][k], opt_again.state[b][k]), k


@pytest.mark.parametrize("case", ["amsgrad", "differentiable", "float64_leaf",
                                  "tensor_lr", "tensor_betas"])
def test_adam_step_raises_for_what_the_kernel_lacks(case):
    leaves = _leaves()
    if case == "float64_leaf":
        leaves[1] = leaves[1].detach().double().requires_grad_()
    opt = torch.optim.Adam(leaves, amsgrad=case == "amsgrad",
                           differentiable=case == "differentiable")
    if case == "tensor_lr":
        opt.param_groups[0]["lr"] = torch.tensor(1e-3)
    if case == "tensor_betas":
        opt.param_groups[0]["betas"] = (torch.tensor(0.9), 0.999)
    for p, g in zip(leaves, _grads()[0]):
        p.grad = g.to(p.dtype)
    before = [p.detach().clone() for p in leaves]
    with pytest.raises(ValueError, match="adam_step"):
        adam_step(opt)
    assert all(torch.equal(p.detach(), b) for p, b in zip(leaves, before))


def test_adam_wrapper_raises_off_cpu_and_cuda():
    t = [torch.zeros(4, device="meta") for _ in range(4)]
    step = torch.zeros((), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        adam(t[:1], t[1:2], t[2:3], t[3:], [step], lr=0.01, beta1=0.9,
             beta2=0.999, eps=1e-8)


def _problem():
    cfg = RenderConfig(width=16, height=8, bounces=1, rng="counter",
                       backend="torch")
    scene, cam = scene_by_name("glass_spheres")
    tex = texture_from_array(gradient_sky(16, 8))
    with torch.no_grad():
        target = render_for_params({}, scene, cam, tex, cfg, 0)
    a = scene.materials.albedo
    params = {"albedo": (torch.stack([a.x, a.y, a.z], -1) + 0.05)
              .requires_grad_()}
    return InverseProblem(scene, cam, tex, cfg, target), params


@pytest.mark.parametrize("k", [1, 2])
def test_train_step_on_cpu_calls_optimizer_step(monkeypatch, k):
    """On CPU leaves the training step's ``step.adam`` is
    ``optimizer.step()``: a patched ``torch.optim.Adam.step`` sees every
    step, per step and K steps a dispatch."""
    calls = []
    real = torch.optim.Adam.step

    def counted(self, *args, **kwargs):
        calls.append(self)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(torch.optim.Adam, "step", counted)
    problem, params = _problem()
    opt = torch.optim.Adam(list(params.values()), lr=0.01)
    if k == 1:
        make_train_step(problem, opt)(params, 0)
    else:
        make_train_step_k(problem, opt, k)(params, 0)
    assert calls == [opt] * k
    assert opt.state[params["albedo"]]["step"].item() == k
