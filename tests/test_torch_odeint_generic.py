"""Parity of the port's generic ODE core (`ode/`: tsit5, the PI
controller, the adaptive options, decreasing time, tree states, the step
API) with the JAX package's `odeint_with_stats` and `ode/adaptive.py`.

Inputs are numpy arrays from fixed seeds; both packages run in float64 on
the CPU.  A batch of systems in the port (one step size a system) is held
against the JAX solver vmapped over the same systems: the same steps on
every system and trajectories within 1e-10 max|y|
(`torch_parity.check_solve64`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu.ode import adaptive as jad
from bayesian_ode_tpu.ode import odeint_with_stats as jstats
from bayesian_ode_tpu.ode.tableaus import DOPRI5 as JDOPRI5
from bayesian_ode_tpu.ode.tableaus import TSIT5 as JTSIT5
from bayesian_ode_tpu_torch.ode import adaptive as tad
from bayesian_ode_tpu_torch.ode import odeint, odeint_with_stats
from bayesian_ode_tpu_torch.ode.tableaus import DOPRI5, TSIT5
from torch_parity import check_solve64, one_torch_thread, to_np  # noqa: F401

B = 4
Y0 = 1.5 * np.random.RandomState(1).randn(B, 2)
TS = np.linspace(0.0, 3.0, 9)
MU = np.array([0.5, 1.0, 2.0, 3.0])          # one stiffness a system


def jvdp(t, y, mu):
    return jnp.stack([y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]])


def tvdp(t, y):
    return torch.stack([y[:, 1], torch.tensor(MU) * (1 - y[:, 0] ** 2)
                        * y[:, 1] - y[:, 0]], dim=1)


def jspiral(t, y, mu):
    """A damped rotation, stable in both directions of time over TS."""
    return jnp.stack([-0.1 * y[0] + mu * y[1], -mu * y[0] - 0.1 * y[1]
                      + 0.3 * jnp.sin(t)])


def tspiral(t, y):
    mu = torch.tensor(MU)
    return torch.stack([-0.1 * y[:, 0] + mu * y[:, 1], -mu * y[:, 0]
                        - 0.1 * y[:, 1] + 0.3 * torch.sin(t)], dim=1)


def jax_batch(ts, method, options=None, rtol=1e-7, atol=1e-9, y0=Y0,
              field=jvdp):
    def one(y, mu):
        return jstats(lambda t, yy: field(t, yy, mu), y, jnp.asarray(ts),
                      rtol=rtol, atol=atol, method=method, options=options)

    return jax.vmap(one)(jnp.asarray(y0), jnp.asarray(MU))


def port_batch(ts, method, options=None, rtol=1e-7, atol=1e-9, y0=Y0,
               field=tvdp):
    return odeint_with_stats(field, torch.tensor(y0), torch.tensor(ts),
                             rtol=rtol, atol=atol, method=method,
                             options=options, batched=True)


@pytest.mark.parametrize("method,options", [
    ("tsit5", None),
    ("dopri5", {"controller": "pi"}),
    ("tsit5", {"controller": "pi"}),
    ("dopri5", {"first_step": 0.05, "safety": 0.8, "ifactor": 5.0,
                "dfactor": 0.3}),
    ("dopri5", {"ulp_floor": 4.0, "mode": "bounded"}),
    ("tsit5", {"mode": "while_scan"}),
])
def test_solves_match_jax(method, options):
    ys_j, st_j = jax_batch(TS, method, options)
    ys, st = port_batch(TS, method, options)
    check_solve64(ys.transpose(0, 1), st, ys_j, st_j)


def test_step_budget_stops_each_system():
    """max_num_steps is per system: the stiff systems stop short, their
    later outputs stay 0 as the JAX buffer's, and reached_final_time says
    which."""
    opts = {"max_num_steps": 50}
    ys_j, st_j = jax_batch(TS, "dopri5", opts)
    ys, st = port_batch(TS, "dopri5", opts)
    check_solve64(ys.transpose(0, 1), st, ys_j, st_j)
    reached = to_np(st["reached_final_time"])
    assert reached.any() and not reached.all()


@pytest.mark.parametrize("method", ["dopri5", "tsit5", "rk4"])
def test_decreasing_time_matches_jax(method):
    """t from 3 down to 0 on a time-dependent field (the reversal's
    dy/ds = -f(-s, y))."""
    ts = TS[::-1].copy()
    ys_j, st_j = jax_batch(ts, method, field=jspiral)
    ys, st = port_batch(ts, method, field=tspiral)
    if method == "rk4":
        np.testing.assert_allclose(to_np(ys.transpose(0, 1)),
                                   np.asarray(ys_j), rtol=0, atol=1e-12)
        return
    check_solve64(ys.transpose(0, 1), st, ys_j, st_j)


@pytest.mark.parametrize("method", ["dopri5", "tsit5", "rk4"])
def test_tree_states_and_norm_weights(method):
    """A dict state {'q': (B,), 'p': (B, 1)} with per-leaf norm weights:
    the error ratio is the max over leaves of each leaf's mean, each scaled
    by its weight; the fixed grid takes tree states too."""
    opts = ({"norm_weights": {"p": 1.0, "q": 0.5}}
            if method != "rk4" else None)

    def jf(t, y, mu):
        return {"q": y["p"][0], "p": jnp.stack(
            [mu * (1 - y["q"] ** 2) * y["p"][0] - y["q"]])}

    def tf(t, y):
        mu = torch.tensor(MU)
        return {"q": y["p"][:, 0], "p": torch.stack(
            [mu * (1 - y["q"] ** 2) * y["p"][:, 0] - y["q"]], dim=1)}

    def one(y, mu):
        return jstats(lambda t, yy: jf(t, yy, mu),
                      {"q": y[0], "p": y[1:]}, jnp.asarray(TS),
                      method=method, options=opts)

    ys_j, st_j = jax.vmap(one)(jnp.asarray(Y0), jnp.asarray(MU))
    y0 = {"q": torch.tensor(Y0[:, 0]), "p": torch.tensor(Y0[:, 1:])}
    ys, st = odeint_with_stats(tf, y0, torch.tensor(TS), method=method,
                               options=opts, batched=True)
    for k in ("q", "p"):
        if method == "rk4":
            # the stiffest systems blow up on this coarse grid, in both
            np.testing.assert_allclose(to_np(ys[k].transpose(0, 1)),
                                       np.asarray(ys_j[k]), rtol=1e-10,
                                       atol=1e-12)
        else:
            check_solve64(ys[k].transpose(0, 1), st, ys_j[k], st_j)


def test_one_system_and_tuple_state():
    """Unbatched: a tuple state (q, p) of one system, as the JAX call."""
    def jf(t, y):
        return (y[1], 1.5 * (1 - y[0] ** 2) * y[1] - y[0])

    def tf(t, y):
        return (y[1], 1.5 * (1 - y[0] ** 2) * y[1] - y[0])

    ys_j, st_j = jstats(jf, (jnp.asarray(1.2), jnp.asarray(-0.3)),
                        jnp.asarray(TS), method="tsit5")
    ys, st = odeint_with_stats(tf, (torch.tensor(1.2, dtype=torch.float64),
                                   torch.tensor(-0.3, dtype=torch.float64)),
                               torch.tensor(TS), method="tsit5")
    for a, b in zip(ys, ys_j):
        assert a.shape == (len(TS),)
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=0,
                                   atol=1e-10)
    for k in ("nfe", "n_accepted", "n_rejected"):
        assert int(st[k]) == int(st_j[k]), k


@pytest.mark.parametrize("tableau,jtab,kind,controller", [
    (DOPRI5, JDOPRI5, "quartic", "i"), (TSIT5, JTSIT5, "stages", "pi")])
def test_step_api_matches_jax(tableau, jtab, kind, controller):
    """init_adaptive_state, five adaptive_step calls and can_step: every
    field of every system against the JAX step vmapped over the
    systems."""
    jcfg = jad.AdaptiveConfig(rtol=1e-6, atol=1e-9, controller=controller)
    tcfg = tad.AdaptiveConfig(rtol=1e-6, atol=1e-9, controller=controller)

    def jrun(y, mu):
        f = lambda t, yy: jvdp(t, yy, mu)   # noqa: E731
        s = jad.init_adaptive_state(f, y, jnp.asarray(0.0), jtab, kind, jcfg)
        out = [s]
        for _ in range(5):
            s = jad.adaptive_step(f, s, jtab, kind, jcfg)
            out.append(s)
        return out, jad.can_step(s)

    jstates, jcan = jax.vmap(jrun)(jnp.asarray(Y0), jnp.asarray(MU))
    s = tad.init_adaptive_state(tvdp, torch.tensor(Y0),
                                torch.tensor(0.0, dtype=torch.float64),
                                tableau, kind, tcfg)
    states = [s]
    for _ in range(5):
        s = tad.adaptive_step(tvdp, s, tableau, kind, tcfg)
        states.append(s)
    np.testing.assert_array_equal(to_np(tad.can_step(s)), np.asarray(jcan))
    for ts_, js in zip(states, jstates):
        for name in ("y1", "f1", "t0", "t1", "dt"):
            np.testing.assert_allclose(to_np(getattr(ts_, name)),
                                       np.asarray(getattr(js, name)),
                                       rtol=1e-12, atol=1e-14, err_msg=name)
        for name in ("nfe", "n_accepted", "n_rejected"):
            np.testing.assert_array_equal(to_np(getattr(ts_, name)),
                                          np.asarray(getattr(js, name)))
        jleaves = jax.tree.leaves(js.interp_coeff)
        tleaves = [to_np(x) for x in _leaves(ts_.interp_coeff)]
        assert len(jleaves) == len(tleaves)
        for a, b in zip(tleaves, jleaves):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-12,
                                       atol=1e-13)
        if controller == "pi":
            np.testing.assert_allclose(to_np(ts_.err_prev),
                                       np.asarray(js.err_prev), rtol=1e-12)


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def test_bounded_mode_gradient_matches_jax():
    """mode='bounded': reverse-mode gradients through the step loop, the
    JAX package's discrete backprop through its bounded scan."""
    W = np.random.RandomState(3).randn(len(TS), 2)

    def jloss(mu):
        ys = jstats(lambda t, y: jvdp(t, y, mu), jnp.asarray(Y0[0]),
                    jnp.asarray(TS), method="dopri5",
                    options={"mode": "bounded"})[0]
        return jnp.sum(ys * W)

    g_j = jax.grad(jloss)(jnp.asarray(1.3))
    mu = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)

    def tf(t, y):
        return torch.stack([y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]])

    ys = odeint(tf, torch.tensor(Y0[0]), torch.tensor(TS), method="dopri5",
                options={"mode": "bounded"})
    (ys * torch.tensor(W)).sum().backward()
    np.testing.assert_allclose(float(mu.grad), float(g_j), rtol=1e-9)


def test_unported_solvers_and_options_raise():
    """Every name of the JAX registry and every adaptive option is ported:
    none raises, and the errors left are the JAX package's."""
    y0 = torch.tensor([1.0, -0.5], dtype=torch.float64)
    t = torch.linspace(0, 1, 3, dtype=torch.float64)
    f = lambda t, y: -y   # noqa: E731
    from bayesian_ode_tpu.ode import SOLVERS as JSOLVERS
    from bayesian_ode_tpu_torch.ode import SOLVERS

    assert sorted(SOLVERS) == sorted(JSOLVERS)
    for method in SOLVERS:
        if method in ("symplectic_euler", "leapfrog", "verlet", "yoshida4"):
            out = odeint(lambda t, y: (y[1], -y[0]), (y0, y0), t,
                         method=method)
        else:
            out = odeint(f, y0, t, method=method)
        assert all(bool(torch.isfinite(x).all()) for x in
                   (out if isinstance(out, tuple) else (out,)))
    for opt in ({"compensated": True}, {"max_steps_per_interval": 64,
                                        "mode": "bounded"},
                {"interp": "hermite"}, {"newton_iters": 3},
                {"error_filter": "raw"}, {"reverse": False}):
        ys = odeint(f, y0, t, method="dopri5", options=opt)
        np.testing.assert_allclose(to_np(ys[-1]), to_np(y0) * np.exp(-1.0),
                                   rtol=1e-6)
    odeint(f, y0, t, method="tsit5", options={"interp": "stages"})
    zs = odeint(lambda t, y: 1j * y, torch.ones(2, dtype=torch.complex128),
                t)
    np.testing.assert_allclose(to_np(zs[-1]), np.exp(1j) * np.ones(2),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="c_mid"):
        odeint(f, y0, t, method="bosh3", options={"interp": "quartic"})
    with pytest.raises(ValueError, match="compensated"):
        odeint(f, y0, t, method="sdirk4", options={"compensated": True})
    with pytest.raises(ValueError, match="error_filter"):
        odeint(f, y0, t, method="sdirk4", options={"error_filter": "l2"})
    with pytest.raises(ValueError, match="unknown method"):
        odeint(f, y0, t, method="rk45")
    with pytest.raises(ValueError, match="without specifying"):
        odeint(f, y0, t, options={"safety": 0.8})
    with pytest.raises(ValueError, match="controller"):
        odeint(f, y0, t, method="dopri5", options={"controller": "pid"})
