"""The port's public fused adaptive engine (`ops/fused_field.py`) and the
GP field's registration on it (`ops/gp_field.py`) against the JAX
package's (`ops/gp_field.py`, run in interpret mode), on the same numpy
inputs; the engine's contracts on a toy field.

Gates, at rtol=1e-5 / atol=1e-7 in float32: trajectories within
1e-4 * max|y| and step counts as `torch_parity.check_solve` says, for
DOPRI5 and TSIT5; the replay gradient at TSIT5 within 1e-3 max-rel of
`jax.grad` through the JAX engine (the JAX package's float32 gate for its
fused adjoint).  The JAX engine's two GP paths differ in their start
step's operation order; the port's are one path, so they agree bit for
bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu.ops.gp_field import (
    gp_field_solve_stats as jgp_field_solve_stats,
    gp_field_trajectory as jgp_field_trajectory,
)
from bayesian_ode_tpu_torch.ode.tableaus import ButcherTableau
from bayesian_ode_tpu_torch.ops import fused_adaptive as fa
from bayesian_ode_tpu_torch.ops.fused_field import (
    FusedField,
    fused_dopri5_stats,
    fused_dopri5_trajectory,
)
from bayesian_ode_tpu_torch.ops.gp_dopri5_grad import gp_dopri5_trajectory
from bayesian_ode_tpu_torch.ops.gp_field import (
    gp_field,
    gp_field_solve_stats,
    gp_field_trajectory,
    gp_weights,
)
from torch_parity import (  # noqa: F401
    check_solve,
    gp_problem,
    max_rel,
    one_torch_thread,
)

TOL = {"rtol": 1e-5, "atol": 1e-7}


@pytest.fixture(scope="module")
def problem():
    # chains jittered by 3e-2, not 3e-3: near-copies of one chain cross a
    # step decision's rounding threshold together, which makes a mean
    # step count one sample
    return gp_problem(C=128, jitter=3e-2)


@pytest.fixture(scope="module")
def jax_ref(problem):
    """The JAX engine's GP solves at both tableaus and its TSIT5
    gradient, once per module."""
    p = problem
    A, x0, ts = (jnp.asarray(p[k]) for k in ("A", "x0", "t"))
    out = {}
    for method in ("dopri5", "tsit5"):
        out[method] = jgp_field_solve_stats(
            A, x0, ts, p["jstatic32"], method=method, interpret=True, **TOL)
    W = np.random.RandomState(5).randn(*out["tsit5"][0].shape).astype(
        np.float32)
    out["W"] = W
    out["grad"] = jax.grad(lambda a: jnp.sum(jgp_field_trajectory(
        a, x0, ts, p["jstatic32"], method="tsit5", interpret=True, **TOL)
        * W))(A)
    return out


def _inputs(p):
    return (torch.tensor(p["A"]), torch.tensor(p["x0"]),
            torch.tensor(p["t"]), p["tstatic"])


@pytest.mark.parametrize("method", ["dopri5", "tsit5"])
def test_gp_field_matches_jax(problem, jax_ref, method):
    ys, st = gp_field_solve_stats(*_inputs(problem), method=method,
                                      **TOL)
    check_solve(ys, st, *jax_ref[method])
    assert st["reached_final_time"]


def test_gp_field_tsit5_gradient_matches_jax(problem, jax_ref):
    A, x0, ts, st = _inputs(problem)
    A.requires_grad_(True)
    ys = gp_field_trajectory(A, x0, ts, st, method="tsit5", **TOL)
    (ys * torch.tensor(jax_ref["W"])).sum().backward()
    assert max_rel(A.grad, jax_ref["grad"]) <= 1e-3


def test_gp_adapter_is_the_gp_field_at_dopri5(problem):
    """gp_dopri5_trajectory and gp_field_trajectory are one path: equal
    trajectories and gradients, bit for bit."""
    W = torch.tensor(np.random.RandomState(6).randn(12, 128, 5, 2),
                     dtype=torch.float32)
    out = []
    for fn in (gp_dopri5_trajectory, gp_field_trajectory):
        A, x0, ts, st = _inputs(problem)
        A.requires_grad_(True)
        ys = fn(A, x0, ts, st, **TOL)
        (ys * W).sum().backward()
        out.append((ys.detach(), A.grad))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


def test_method_and_controller_validation(problem):
    A, x0, ts, st = _inputs(problem)
    field, w = gp_field(st.sf, st.ell), gp_weights(A, st)
    for fn in (fused_dopri5_trajectory, fused_dopri5_stats):
        with pytest.raises(ValueError, match="unknown fused method"):
            fn(field, w, x0, ts, method="bosh3")
        with pytest.raises(ValueError, match="controller"):
            fn(field, w, x0, ts, controller="pid")
    three_stage = ButcherTableau(alpha=[0.5, 1.0], beta=[[0.5], [0.0, 1.0]],
                                 c_sol=[0.0, 1.0, 0.0],
                                 c_error=[0.1, -0.1, 0.0], order=2,
                                 c_mid=[0.0, 0.5, 0.0])
    with pytest.raises(ValueError, match="7-stage FSAL"):
        fa._check_tableau(three_stage)


def _toy_field():
    """f(y) = a y + k per chain, a (C,) per chain with a cotangent and k
    (1,) shared by all chains (a trailing block, no cotangent); the
    closed form is y(t) = (y0 + k/a) e^{a t} - k/a."""
    def make_rhs(w):
        a, k = w
        return lambda y: a[:, None, None] * y + k

    def make_rhs_vjp(w):
        a, _ = w
        return lambda y, cot: (a[:, None, None] * cot,
                               ((y * cot).sum(dim=(1, 2)),))

    return FusedField(name="toy", n_wbar=1, make_rhs=make_rhs,
                      make_rhs_vjp=make_rhs_vjp,
                      rhs_ref=lambda w, pts: make_rhs(w)(pts),
                      shapes=lambda w: ((w[0].shape[0],), (1,)))


def test_shared_constant_blocks_get_zero_cotangent():
    """The n_wbar contract (as the JAX package's
    test_fused_field_shared_constant_blocks): a trailing shared block
    flows into the field but gets a zero cotangent, and the leading
    block's gradient matches the closed form's."""
    f64 = torch.float64
    a = torch.tensor([0.3, -0.4, 0.8, 0.1], requires_grad=True)
    k = torch.tensor([0.7], requires_grad=True)
    x0 = torch.tensor([[0.5, -0.25]])
    ts = torch.linspace(0.0, 1.5, 6)
    ys = fused_dopri5_trajectory(_toy_field(), (a, k), x0, ts, rtol=1e-6,
                                 atol=1e-9)
    W = torch.tensor(np.random.RandomState(2).randn(*ys.shape),
                     dtype=torch.float32)
    ga, gk = torch.autograd.grad((ys * W).sum(), (a, k))
    assert not gk.any()

    a64 = a.detach().to(f64).requires_grad_(True)
    tt = ts.to(f64)[:, None, None, None]
    kk = float(k.detach())
    want = ((x0.to(f64)[None, None] + kk / a64[None, :, None, None])
            * torch.exp(a64[None, :, None, None] * tt)
            - kk / a64[None, :, None, None])
    np.testing.assert_allclose(ys.detach().numpy(), want.detach().numpy(),
                               rtol=1e-4, atol=1e-5)
    (ga_ref,) = torch.autograd.grad((want * W.to(f64)).sum(), (a64,))
    np.testing.assert_allclose(ga.numpy(), ga_ref.numpy(), rtol=5e-3,
                               atol=1e-5)


def test_stats_count_each_chains_accepted_steps(problem):
    """n_iterations is each chain's accepted-step count (the port records
    per chain); a budget below the worst chain makes the recording
    forward raise."""
    A, x0, ts, st = _inputs(problem)
    _, stats = gp_field_solve_stats(A, x0, ts, st, **TOL)
    assert torch.equal(stats["n_iterations"], stats["n_accepted"])
    worst = int(stats["n_iterations"].max())
    ys = gp_field_trajectory(A, x0, ts, st, store_steps=worst, **TOL)
    assert bool(torch.isfinite(ys).all())
    with pytest.raises(RuntimeError, match="store_steps"):
        gp_field_trajectory(A, x0, ts, st, store_steps=worst - 1, **TOL)
