"""Parity of the port's low-order adaptive pairs (bosh3, fehlberg2,
adaptive_heun: cubic Hermite dense output, the non-FSAL pairs' extra
endpoint evaluation) with the JAX package's, in float64 on the CPU.

A batch of 4 Van der Pol systems (one stiffness a system) in the port
against the JAX solver vmapped over them: the same steps on every system
and trajectories within 1e-10 max|y| (`torch_parity.check_solve64`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu.ode import odeint as jodeint
from bayesian_ode_tpu_torch.ode import odeint, odeint_with_stats
from bayesian_ode_tpu_torch.ode.tableaus import ADAPTIVE_HEUN, BOSH3, \
    FEHLBERG2
from torch_parity import (VDP_TS, check_counts32, check_solve64,  # noqa
                          one_torch_thread, to_np, vdp_both)

METHODS = ["bosh3", "fehlberg2", "adaptive_heun"]


def test_fsal_classification_and_nfe_per_step():
    assert BOSH3.is_fsal and BOSH3.nfe_per_step == 3
    assert not FEHLBERG2.is_fsal and FEHLBERG2.nfe_per_step == 3
    assert not ADAPTIVE_HEUN.is_fsal and ADAPTIVE_HEUN.nfe_per_step == 2


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("options", [None, {"controller": "pi"}])
def test_batched_solves_match_jax(method, options):
    rtol = 1e-5 if method != "bosh3" else 1e-7
    ys, st, ys_j, st_j = vdp_both(method, options, rtol=rtol, atol=1e-8)
    check_solve64(ys, st, ys_j, st_j)
    # every attempt costs nfe_per_step, plus the start's two
    per = {"bosh3": 3, "fehlberg2": 3, "adaptive_heun": 2}[method]
    np.testing.assert_array_equal(
        to_np(st["nfe"]),
        2 + per * to_np(st["n_accepted"] + st["n_rejected"]))


@pytest.mark.parametrize("method", ["bosh3"])
def test_float32_solves_match_jax(method):
    ys, st, ys_j, st_j = vdp_both(method, rtol=1e-4, atol=1e-6,
                                  dtype=np.float32)
    assert ys.dtype == torch.float32
    scale = np.abs(np.asarray(ys_j)).max()
    assert np.abs(to_np(ys) - np.asarray(ys_j)).max() <= 1e-4 * scale
    check_counts32(st, st_j)


@pytest.mark.parametrize("method", ["adaptive_heun"])
def test_backwards_in_time_and_dense_output(method):
    """Decreasing output times on a time-dependent field, each output from
    the Hermite interpolant of the step that crosses it."""
    ts = VDP_TS[::-1].copy()

    def jf(t, y):
        return jnp.stack([-0.1 * y[0] + y[1], -y[0] + 0.3 * jnp.sin(t)])

    def tf(t, y):
        return torch.stack([-0.1 * y[:, 0] + y[:, 1],
                            -y[:, 0] + 0.3 * torch.sin(t)], dim=1)

    y0 = np.array([[1.0, 0.5], [-0.3, 0.8]])
    want = jax.vmap(lambda y: jodeint(jf, y, jnp.asarray(ts), method=method,
                                      rtol=1e-6, atol=1e-9))(jnp.asarray(y0))
    got = odeint(tf, torch.tensor(y0), torch.tensor(ts), method=method,
                 rtol=1e-6, atol=1e-9, batched=True)
    np.testing.assert_allclose(to_np(got.transpose(0, 1)), np.asarray(want),
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("method", METHODS)
def test_bounded_mode_gradient_matches_jax(method):
    W = np.random.RandomState(3).randn(len(VDP_TS), 2)

    def jloss(mu):
        ys = jodeint(lambda t, y: jnp.stack(
            [y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]]),
            jnp.asarray([1.0, 0.2]), jnp.asarray(VDP_TS), rtol=1e-5,
            atol=1e-8, method=method, options={"mode": "bounded"})
        return jnp.sum(ys * W)

    g_j = jax.grad(jloss)(jnp.asarray(0.8))
    mu = torch.tensor(0.8, dtype=torch.float64, requires_grad=True)
    ys = odeint(lambda t, y: torch.stack(
        [y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]]),
        torch.tensor([1.0, 0.2], dtype=torch.float64), torch.tensor(VDP_TS),
        rtol=1e-5, atol=1e-8, method=method, options={"mode": "bounded"})
    (ys * torch.tensor(W)).sum().backward()
    np.testing.assert_allclose(float(mu.grad), float(g_j), rtol=1e-8)


def test_one_system_matches_its_row_of_the_batch():
    ys, st = odeint_with_stats(
        lambda t, y: torch.stack([y[1], (1 - y[0] ** 2) * y[1] - y[0]]),
        torch.tensor([1.0, 0.2], dtype=torch.float64), torch.tensor(VDP_TS),
        method="bosh3")
    yb, sb = odeint_with_stats(
        lambda t, y: torch.stack([y[:, 1], (1 - y[:, 0] ** 2) * y[:, 1]
                                  - y[:, 0]], 1),
        torch.tensor([[1.0, 0.2], [2.0, 0.0]], dtype=torch.float64),
        torch.tensor(VDP_TS), method="bosh3", batched=True)
    torch.testing.assert_close(ys, yb[:, 0], rtol=0, atol=0)
    assert int(st["nfe"]) == int(sb["nfe"][0])
