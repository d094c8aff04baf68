"""Parity of the port's implicit methods (sdirk4, trbdf2: the batched
per-system Jacobian, one LU a step, masked simplified Newton, the raw and
Shampine-filtered error) with the JAX package's, in float64 on the CPU.

A batch of stiff linear systems y' = -lam (y - c(t)), one lam a system
(10 to 10^4) and c the quartic Taylor polynomial of cos (libm's cos and
XLA's differ by an ulp, which lam = 10^4 scales past the bar), and of
Van der Pol systems, in the port against the JAX
solve vmapped over them: the same steps on every system and trajectories
within 1e-10 max|y| (`torch_parity.check_solve64`); no Newton decision
flips on LU rounding here.  Gradients through the steps are the implicit
function theorem's (the JAX package's custom_root), held to JAX's and to
the closed form.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu import odeint_adjoint as jadjoint
from bayesian_ode_tpu.ode import odeint as jodeint
from bayesian_ode_tpu.ode import odeint_with_stats as jstats
from bayesian_ode_tpu_torch.ode import odeint, odeint_adjoint, \
    odeint_with_stats
from torch_parity import check_solve64, one_torch_thread, vdp_both  # noqa: F401

METHODS = ["sdirk4", "trbdf2"]
LAMS = np.array([10.0, 200.0, 3000.0, 1e4])
TS = np.linspace(0.0, 1.0, 4)


def _c(t):
    return 1 - t * t / 2 + t ** 4 / 24


def _stiff_both(method, options=None, rtol=1e-6, atol=1e-9):
    def one(lam):
        return jstats(lambda t, y: -lam * (y - _c(t)), jnp.zeros(1),
                      jnp.asarray(TS), rtol=rtol, atol=atol, method=method,
                      options=options)

    ys_j, st_j = jax.vmap(one)(jnp.asarray(LAMS))
    lam = torch.tensor(LAMS)[:, None]
    ys, st = odeint_with_stats(
        lambda t, y: -lam * (y - _c(t)[:, None]),
        torch.zeros(len(LAMS), 1, dtype=torch.float64), torch.tensor(TS),
        rtol=rtol, atol=atol, method=method, options=options, batched=True)
    return ys.transpose(0, 1), st, ys_j, st_j


@pytest.mark.parametrize("method,options", [
    ("sdirk4", None), ("trbdf2", None),
    ("sdirk4", {"error_filter": "shampine", "newton_iters": 2,
                "newton_kappa": 1e-3}),
    ("trbdf2", {"controller": "pi"})])
def test_stiff_batch_matches_jax(method, options):
    """The same steps on every system, and trajectories within 1e-10
    max|y| or 10x the JAX solve's own move when atol moves by 1e-14
    relative, whichever is larger (that move is solved only where the
    first bar fails): trbdf2 under the PI controller on lam = 10^4 moves
    by 1.7e-8 on [0, 1.5] (the port, by the same perturbation, alike),
    and the port was 1.5e-9 from JAX on that system."""
    ys, st, ys_j, st_j = _stiff_both(method, options)
    scale = np.abs(np.asarray(ys_j)).max()
    bar = 1e-10
    if np.abs(ys.numpy() - np.asarray(ys_j)).max() > bar * scale:
        _, _, ys_p, _ = _stiff_both(method, options,
                                    atol=1e-9 * (1 + 1e-14))
        spread = np.abs(np.asarray(ys_p) - np.asarray(ys_j)).max() / scale
        bar = max(bar, 10 * spread)
    check_solve64(ys, st, ys_j, st_j, traj_tol=bar)


@pytest.mark.parametrize("method", METHODS)
def test_vdp_batch_matches_jax(method):
    """A 2-D state: each system's 2x2 Jacobian from two JVPs over the
    batch, one batched LU a step."""
    check_solve64(*vdp_both(method, rtol=1e-6, atol=1e-9))


@pytest.mark.parametrize("method", METHODS)
def test_bounded_gradient_is_the_ift_one(method):
    """d y(1) / d lam at lam = 500 through the steps (mode "bounded"):
    the JAX package's custom_root gradient, and the closed form within
    5e-3 (the truncated Newton iterations' own derivative is 20% off for
    sdirk4)."""
    lam0, ts = 500.0, np.linspace(0.0, 1.0, 3)
    opts = {"mode": "bounded", "max_steps_per_interval": 2048}

    def jloss(lam):
        return jodeint(lambda t, y: -lam * (y - jnp.cos(t)), jnp.zeros(1),
                       jnp.asarray(ts), rtol=1e-6, atol=1e-9, method=method,
                       options=opts)[-1, 0]

    g_j = float(jax.grad(jloss)(lam0))
    lam = torch.tensor(lam0, dtype=torch.float64, requires_grad=True)
    odeint(lambda t, y: -lam * (y - torch.cos(t)),
           torch.zeros(1, dtype=torch.float64), torch.tensor(ts), rtol=1e-6,
           atol=1e-9, method=method, options=opts)[-1, 0].backward()
    lam2 = lam0 ** 2
    d_a = 2 * lam0 / (1 + lam2) ** 2
    d_c = (1 - lam2) / (1 + lam2) ** 2
    g_true = (d_a * math.cos(1.0) + d_c * math.sin(1.0)
              - d_a * math.exp(-lam0))
    assert abs(float(lam.grad) - g_true) < 5e-3 * abs(g_true)
    np.testing.assert_allclose(float(lam.grad), g_j, rtol=1e-6)


def test_continuous_adjoint_through_sdirk4():
    """The backward solve of the augmented system with sdirk4 too (its
    Jacobian by forward differences: the augmented field calls autograd);
    against the JAX adjoint and within 5% of the closed form.  lam = 50
    (the JAX package's test takes 500: the same steps as JAX there, 5,138
    backward steps, 140 s on the CPU)."""
    lam0, ts = 50.0, np.linspace(0.0, 1.0, 3)

    def jloss(lam):
        return jadjoint(lambda t, y: -lam * (y - jnp.cos(t)), jnp.zeros(1),
                        jnp.asarray(ts), rtol=1e-6, atol=1e-9,
                        method="sdirk4")[-1, 0]

    g_j = float(jax.grad(jloss)(lam0))
    lam = torch.tensor([lam0], dtype=torch.float64, requires_grad=True)
    odeint_adjoint(lambda t, y: -lam * (y - torch.cos(t)),
                   torch.zeros(1, dtype=torch.float64), torch.tensor(ts),
                   rtol=1e-6, atol=1e-9, method="sdirk4",
                   adjoint_params=(lam,))[-1, 0].backward()
    lam2 = lam0 ** 2
    g_true = (2 * lam0 / (1 + lam2) ** 2 * math.cos(1.0)
              + (1 - lam2) / (1 + lam2) ** 2 * math.sin(1.0))
    assert abs(float(lam.grad) - g_true) < 0.05 * abs(g_true)
    np.testing.assert_allclose(float(lam.grad), g_j, rtol=1e-6)


def test_divergence_exits_and_errors():
    def aug(t, s):
        y, a = s
        return (-1000.0 * (y - torch.cos(t)), 1000.0 * a)

    _, st = odeint_with_stats(aug, (torch.zeros(1, dtype=torch.float64),
                                    torch.ones(1, dtype=torch.float64)),
                              torch.linspace(0.0, 1.0, 3,
                                             dtype=torch.float64),
                              rtol=1e-2, atol=1e-5, method="sdirk4")
    assert not bool(st["reached_final_time"])
    assert int(st["n_accepted"]) + int(st["n_rejected"]) < 100_000
    f = lambda t, y: -10.0 * y  # noqa: E731
    y0, t = torch.ones(1, dtype=torch.float64), torch.linspace(0, 1, 3)
    with pytest.raises(ValueError, match="compensated"):
        odeint(f, y0, t, method="sdirk4", options={"compensated": True})
    with pytest.raises(ValueError, match="error_filter"):
        odeint(f, y0, t, method="trbdf2", options={"error_filter": "l1"})
