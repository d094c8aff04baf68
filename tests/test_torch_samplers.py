"""Parity of the port's samplers, schedules and diagnostics with the JAX
package.  JAX and torch draw different random numbers, so the update rules
are compared without noise (pSGLD with add_noise=False) or against the
formula with the noise redrawn from a generator of the same seed."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu import samplers as jsamplers
from bayesian_ode_tpu.samplers import schedules as jsched
from bayesian_ode_tpu.samplers.base import (
    langevin_noise_scale as jlangevin_noise_scale,
)
from bayesian_ode_tpu.samplers.diagnostics import (
    autocovariance as jautocovariance,
)
from bayesian_ode_tpu_torch import samplers as tsamplers
from bayesian_ode_tpu_torch.samplers import schedules as tsched
from bayesian_ode_tpu_torch.utils.pytree import tree_random_normal


def test_schedules_match_jax():
    for t in (0, 1, 7, 250):
        assert tsched.constant(3e-4)(t) == pytest.approx(
            float(jsched.constant(3e-4)(t)), rel=1e-15)
        for lr0, gamma, t0, alpha in ((1e-5, 0.55, 100, 1.0),
                                      (5e-3, 0.51, 100, 0.1)):
            want = float(jsched.polynomial_decay(lr0, gamma, t0, alpha)(
                jnp.asarray(t, jnp.int32)))
            got = tsched.polynomial_decay(lr0, gamma, t0, alpha)(t)
            assert got == pytest.approx(want, rel=1e-12)
    assert tsched.resolve(0.1)(5) == 0.1
    f = tsched.polynomial_decay(1e-3)
    assert tsched.resolve(f) is f


def _quadratic(P, b):
    """A batch potential U_c(x) = 1/2 x^T P x - b.x over {'x': (C, d),
    'y': (C,)}, identical in both frameworks (`asarray` is jnp.asarray or
    torch.as_tensor, `np_mod` jnp or torch)."""
    def pot(params, np_mod):
        asarray = jnp.asarray if np_mod is jnp else torch.as_tensor
        x, y = params["x"], params["y"]
        Pm = asarray(P, dtype=x.dtype)
        quad = 0.5 * np_mod.einsum("ci,ij,cj->c", x, Pm, x)
        return quad - x @ asarray(b, dtype=x.dtype) + 0.5 * y ** 2 * 3.0
    return pot


def test_psgld_batched_matches_jax_without_noise():
    rng = np.random.RandomState(0)
    C, d = 6, 4
    M = rng.randn(d, d)
    P = M @ M.T + d * np.eye(d)
    b = rng.randn(d)
    pos = {"x": rng.randn(C, d), "y": rng.randn(C)}
    pot = _quadratic(P, b)
    sched = (0.05, 0.9, 10.0, 1.0)

    jk = jsamplers.psgld_batched(
        lambda p: pot(p, jnp), jsched.polynomial_decay(*sched), alpha=0.9,
        lambda_=1e-3, add_noise=False)
    js = jk.init(jax.tree.map(jnp.asarray, pos))
    tk = tsamplers.psgld_batched(
        lambda p: pot(p, torch), tsched.polynomial_decay(*sched), alpha=0.9,
        lambda_=1e-3, add_noise=False)
    ts = tk.init({k: torch.tensor(v) for k, v in pos.items()})
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        js, jinfo = jk.step(jax.random.PRNGKey(0), js)
        ts, tinfo = tk.step(gen, ts)
        for k in pos:
            np.testing.assert_allclose(ts.position[k].numpy(),
                                       np.asarray(js.position[k]),
                                       rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(ts.v[k].numpy(), np.asarray(js.v[k]),
                                       rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(tinfo["potential"].numpy(),
                                   np.asarray(jinfo["potential"]),
                                   rtol=1e-12)
        assert tinfo["step_size"] == pytest.approx(
            float(jinfo["step_size"]), rel=1e-12)
    assert ts.step == 3


def test_sgld_batched_step_is_the_langevin_update():
    rng = np.random.RandomState(1)
    C, d = 5, 3
    P = np.eye(d) * 2.0
    pot = _quadratic(P, rng.randn(d))
    pos = {"x": torch.tensor(rng.randn(C, d)), "y": torch.tensor(rng.randn(C))}
    lr = 1e-2
    k = tsamplers.sgld_batched(lambda p: pot(p, torch), lr)
    s0 = k.init(pos)
    s1, info = k.step(torch.Generator().manual_seed(7), s0)
    noise = tree_random_normal(torch.Generator().manual_seed(7), pos)
    for key in pos:
        want = (pos[key] - lr * s0.grad[key]
                - math.sqrt(2 * lr) * noise[key])
        torch.testing.assert_close(s1.position[key], want, rtol=0, atol=0)
    torch.testing.assert_close(info["potential"], s0.potential)
    # the state carries the potential and gradient at the new position
    u, g = tsamplers.batch_value_and_grad(lambda p: pot(p, torch))(
        s1.position)
    torch.testing.assert_close(s1.potential, u)
    torch.testing.assert_close(s1.grad["x"], g["x"])


def test_batch_value_and_grad_is_per_chain():
    P = np.diag([1.0, 2.0, 3.0])
    b = np.array([0.5, -1.0, 2.0])
    pot = _quadratic(P, b)
    x = torch.tensor(np.random.RandomState(2).randn(4, 3))
    u, g = tsamplers.batch_value_and_grad(lambda p: pot(p, torch))(
        {"x": x, "y": torch.zeros(4)})
    torch.testing.assert_close(g["x"], x @ torch.tensor(P) - torch.tensor(b))
    assert u.shape == (4,) and not u.requires_grad


def test_sample_chain_burn_in_and_thinning():
    pot = _quadratic(np.eye(2), np.zeros(2))
    k = tsamplers.sgld_batched(lambda p: pot(p, torch), 1e-3)
    s0 = k.init({"x": torch.zeros(3, 2), "y": torch.zeros(3)})
    final, positions, infos = tsamplers.sample_chain(
        k, s0, torch.Generator().manual_seed(0), num_samples=4, burn_in=2,
        thin=3)
    assert positions["x"].shape == (4, 3, 2)
    assert infos["potential"].shape == (4, 3)
    assert bool(infos["accepted"].all())
    assert final.step == 2 + 4 * 3
    torch.testing.assert_close(positions["x"][-1], final.position["x"])


def _ar1(m, n, phi, seed):
    rng = np.random.RandomState(seed)
    x = np.zeros((m, n))
    for i in range(1, n):
        x[:, i] = phi * x[:, i - 1] + rng.randn(m)
    return x + rng.randn(m, 1) * 0.1


@pytest.mark.parametrize("m,n,phi", [(4, 200, 0.9), (16, 51, 0.3),
                                     (1, 100, -0.4)])
def test_ess_and_rhat_match_jax(m, n, phi):
    x = _ar1(m, n, phi, seed=m + n)
    np.testing.assert_allclose(
        tsamplers.ess(torch.tensor(x)).item(),
        float(jsamplers.ess(jnp.asarray(x))), rtol=1e-10)
    np.testing.assert_allclose(
        tsamplers.split_rhat(torch.tensor(x)).item(),
        float(jsamplers.split_rhat(jnp.asarray(x))), rtol=1e-10)
    np.testing.assert_allclose(
        tsamplers.autocovariance(torch.tensor(x[0])).numpy(),
        np.asarray(jautocovariance(jnp.asarray(x[0]))),
        rtol=1e-10, atol=1e-12)


def test_langevin_noise_scale():
    assert tsamplers.langevin_noise_scale(0.02) == pytest.approx(
        float(jlangevin_noise_scale(0.02)), rel=1e-15)
