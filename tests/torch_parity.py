"""Shared inputs for the parity tests of the PyTorch port against the JAX
package: the same numpy arrays go to both.

The GP-ODE problem is the JAX package's fused-kernel test problem
(tests/test_pallas_ops.py::_gp_grad_setup) at the port's small test shape:
5 trajectories, a 6x6 inducing grid, T=12 output times to t=2.5, C=8
chains jittered around the gradient-matched initialization.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu.models import kernel_regression as jkr
from bayesian_ode_tpu.models import make_dataset
from bayesian_ode_tpu_torch.models import kernel_regression as tkr


def to_np(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def max_rel(a, b):
    """max |a - b| / max |b| (the JAX package's gate for float32 paths)."""
    a, b = to_np(a), to_np(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def gp_problem(C=8, T=12, t_max=2.5, seed=0, jitter=3e-3, M=6, N=5,
               ell=0.75):
    """The GP posterior problem in both packages, on an M x M inducing
    grid, N trajectories.  Returns a dict of numpy arrays (float32 solver
    inputs, float64 statics) and the two statics.  (A grid finer than 6 x 6
    needs a shorter ell: at 15 x 15 the kernel matrix of ell = 0.75 is not
    positive definite in float64, and its Cholesky factor NaN in JAX.)"""
    data = make_dataset(jax.random.PRNGKey(2), "vdp", N=N, T=T, t_max=t_max,
                        noise=0.05, x0_scale=1.5)
    Z = jkr.make_inducing_grid(data["Y"], M=M)
    static = jkr.make_static(Z, sf=1.0, ell=ell)
    p0 = jkr.init_params(data["Y"], data["t"], static, noise=0.05)
    rng = np.random.RandomState(seed)
    U = (np.asarray(p0["U"], np.float32)[None]
         + jitter * rng.randn(C, M * M, 2).astype(np.float32))
    KzzinvL32 = np.asarray(static.KzzinvL, np.float32)
    A = np.einsum("mk,ckd->cmd", KzzinvL32, U).astype(np.float32)
    logsn = (np.broadcast_to(np.asarray(p0["logsn"], np.float32), (C, 2))
             + 0.01 * rng.randn(C, 2).astype(np.float32))
    f32 = jnp.float32
    jstatic32 = static._replace(Z=static.Z.astype(f32),
                                KzzinvL=static.KzzinvL.astype(f32),
                                Kzzinv=static.Kzzinv.astype(f32))
    tstatic = tkr.static_from_numpy(static.Z, static.KzzinvL, static.Kzzinv,
                                    static.sf, static.ell)
    return {
        "x0": np.asarray(data["x0"], np.float32),
        "t": np.asarray(data["t"], np.float32),
        "Y": np.asarray(data["Y"], np.float32),
        "U": U, "A": A, "logsn": logsn.astype(np.float32),
        "jstatic64": static, "jstatic32": jstatic32, "tstatic": tstatic,
    }


# ---- the fused engine's other fields, at the port's small test shape:
# N=3 trajectory points, T=8 output times, C=128 chains (the JAX engine
# pads the chain axis to a 128-lane tile in any case), H=6 hidden units

FIELD_X0 = np.asarray([[2.0, 0.0], [1.0, 0.5], [-0.8, 0.9]], np.float32)
FIELD_T = np.linspace(0.0, 2.0, 8).astype(np.float32)


def mlp_params(C=128, H=6, seed=0, jitter=0.05):
    """A layer list [2, H, H, 2] of numpy arrays with a leading chain axis:
    the driver's start, uniform(-0.5, 0.5) weights and zero biases, with
    N(0, jitter^2) per chain (the JAX package's fused-MLP tests jitter
    by 0.05)."""
    rng = np.random.RandomState(seed)
    out = []
    for a, b in ((2, H), (H, H), (H, 2)):
        w = rng.rand(a, b) - 0.5
        out.append({"w": (w + jitter * rng.randn(C, a, b)).astype(np.float32),
                    "b": (jitter * rng.randn(C, b)).astype(np.float32)})
    return out


def spiral_params(C=128, H=6, seed=0, jitter=0.1):
    """The spiral dict with a leading chain axis: the driver's start,
    N(0, 0.1) weights and zero biases, with N(0, jitter^2) per chain (as
    the JAX package's spiral tests jitter)."""
    rng = np.random.RandomState(seed)
    shapes = {"w1": (2, H), "b1": (H,), "w2": (H, 2), "b2": (2,)}
    return {k: ((0.1 * rng.randn(*s) if k[0] == "w" else np.zeros(s))
                + jitter * rng.randn(C, *s)).astype(np.float32)
            for k, s in shapes.items()}


def fhn_theta(C=128, seed=0):
    """theta {'a', 'b', 'c'} (C,) around the classic truth (0.2, 0.2, 3)."""
    rng = np.random.RandomState(seed)
    return {k: (v + 0.1 * rng.randn(C)).astype(np.float32)
            for k, v in (("a", 0.2), ("b", 0.2), ("c", 3.0))}


def field_outputs(C=128, T=8, N=3, seed=5):
    """Trajectory cotangent weights W (T, C, N, 2) and observations
    Y (N, T, 2), float32."""
    rng = np.random.RandomState(seed)
    return (rng.randn(T, C, N, 2).astype(np.float32),
            rng.randn(N, T, 2).astype(np.float32))


def check_solve(ys_t, st_t, ys_j, st_j, traj_tol=1e-4):
    """A port solve against the JAX engine's on the same inputs.

    Trajectories within traj_tol * max|y|.  Step counts, per chain: two
    float32 solves take the same steps except where an error ratio lands
    within its rounding of 1.  These solves are short (4-30 attempts a
    chain), so such flips move the counts visibly: an ulp-level change of
    the port's own MLP field (its hidden product accumulated in float64)
    moved 20 of 128 chains by one step and the mean NFE from 25.906 to
    25.344, the JAX engine's mean to the digit; the GP field's rejections
    while its start step shrinks differ by one on about 40% of chains
    (mean 0.10 a chain).  So no chain's accepted or rejected count
    differs by more than 3, and their means by more than 0.25 a chain;
    nfe is 2 + 6 per attempted step."""
    ys_t, ys_j = to_np(ys_t), np.asarray(ys_j)
    assert ys_t.shape == ys_j.shape and ys_t.dtype == np.float32
    assert np.max(np.abs(ys_t - ys_j)) <= traj_tol * np.max(np.abs(ys_j))
    got = {k: to_np(st_t[k]).astype(np.int64)
           for k in ("nfe", "n_accepted", "n_rejected")}
    want = {k: np.asarray(st_j[k]).astype(np.int64) for k in got}
    for k in ("n_accepted", "n_rejected"):
        assert np.max(np.abs(got[k] - want[k])) <= 3, k
        assert abs(np.mean(got[k]) - np.mean(want[k])) <= 0.25, k
    np.testing.assert_array_equal(
        got["nfe"], 2 + 6 * (got["n_accepted"] + got["n_rejected"]))
    np.testing.assert_array_equal(
        want["nfe"], 2 + 6 * (want["n_accepted"] + want["n_rejected"]))


# ---- the generic engine's small problem: N=3 Van der Pol trajectories,
# T=8 output times to t=2, and a driver config at H=8 hidden units and a
# 4x4 inducing grid

GENERIC_CONFIG = {
    "method": "SGLD", "inf_type": "sampler", "id": 1, "M": 4, "sf": 1.0,
    "ell": 0.75, "noise": 0.05, "burn_in": 1, "num_samples": 2,
    "thinning": 1, "num_chains": 4, "lr0": 1e-5, "lr_gamma": 0.55,
    "lr_t0": 100, "lr_alpha": 1.0, "psgld_alpha": 0.99, "lambda_": 1e-8,
    "lr": 1e-6, "engine": "generic", "solver": "rk4", "model": "gp",
    "hidden": 8, "seed": 0, "jitter": 0.0,
}


def generic_data(seed=3, N=3, T=8, t_max=2.0, noise=0.05):
    """The dataset {x0, t, Y, noise} as numpy float64: x0 from a numpy
    seed, the Van der Pol trajectories by the port's dopri5 at
    rtol=1e-10, Y with numpy noise."""
    from bayesian_ode_tpu_torch.models.dynamics import DYNAMICS
    from bayesian_ode_tpu_torch.ode import odeint

    rng = np.random.RandomState(seed)
    x0 = 1.5 * rng.randn(N, 2)
    t = np.linspace(0.0, t_max, T)
    X = to_np(odeint(DYNAMICS["vdp"], torch.tensor(x0), torch.tensor(t),
                     rtol=1e-10, atol=1e-12)).transpose(1, 0, 2)
    return {"x0": x0, "t": t, "Y": X + noise * rng.randn(*X.shape),
            "noise": noise}


def check_solve64(ys_t, st_t, ys_j, st_j, traj_tol=1e-10):
    """A float64 port solve against the JAX solver's on the same inputs:
    the same steps on every system (nfe, accepted and rejected counts
    equal) and trajectories within traj_tol * max|y| (both take the same
    operations up to their order, so only rounding separates them)."""
    ys_t, ys_j = to_np(ys_t), np.asarray(ys_j)
    assert ys_t.shape == ys_j.shape and ys_t.dtype == np.float64
    assert np.max(np.abs(ys_t - ys_j)) <= traj_tol * np.max(np.abs(ys_j))
    for k in ("nfe", "n_accepted", "n_rejected"):
        np.testing.assert_array_equal(to_np(st_t[k]).astype(np.int64),
                                      np.asarray(st_j[k]).astype(np.int64),
                                      err_msg=k)
    np.testing.assert_array_equal(to_np(st_t["reached_final_time"]),
                                  np.asarray(st_j["reached_final_time"]))


def tree_max_rel(got, want):
    """max-rel of a parameter tree taken as one vector: the largest
    |got - want| over all leaves over the largest |want|, the
    normalisation of the JAX package's fused-field gradient tests
    (tests/test_fused_field.py, test_pallas_ops.py).  Leaves pair up in
    jax.tree.leaves order (sorted keys, lists in order)."""
    def leaves(t):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in leaves(t[k])]
        if isinstance(t, (list, tuple)):
            return [x for v in t for x in leaves(v)]
        return [to_np(t)]

    pairs = list(zip(leaves(got), leaves(want)))
    assert len(pairs) == len(leaves(want))
    return (max(float(np.max(np.abs(a - b))) for a, b in pairs)
            / max(float(np.max(np.abs(b))) for _, b in pairs))


def _tree_to_torch(tree):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to_torch(v) for v in tree)
    return torch.tensor(np.asarray(tree))


def check_generic_potential(data, model, solver, C=4):
    """The generic engine's batch potential (`make_generic_potential`, in
    float64) against the JAX driver's `vmap(value_and_grad(potential))`
    of `build_model`'s per-chain potential, on C chains: the JAX start
    point plus 0.02 N(0, 1) a chain from a numpy seed (the GP with the
    JAX package's kernel quantities: Kzz^-1 of the 4x4 grid amplifies the
    two packages' rounding of them).  Values to 1e-9 relative, each
    chain's gradient within 1e-6 max-rel (the adjoint gate)."""
    from bayesian_ode_tpu.experiments.vanderpol_gp import (
        build_model as jbuild,
    )
    from bayesian_ode_tpu_torch.experiments import vanderpol_gp as tv
    from bayesian_ode_tpu_torch.samplers import batch_value_and_grad

    cfg = dict(GENERIC_CONFIG, model=model, solver=solver)
    jstatic, params0, potential, _ = jbuild(cfg, data)
    rng = np.random.RandomState(11)
    P = jax.tree.map(
        lambda x: np.asarray(x)[None] + 0.02 * rng.randn(C, *np.shape(x)),
        params0)
    u_j, g_j = jax.jit(jax.vmap(jax.value_and_grad(potential)))(
        jax.tree.map(jnp.asarray, P))
    static = None if model != "gp" else tkr.static_from_numpy(
        jstatic.Z, jstatic.KzzinvL, jstatic.Kzzinv, jstatic.sf, jstatic.ell)
    pot = tv.make_generic_potential(cfg, data, static, "cpu", torch.float64)
    u, g = batch_value_and_grad(pot)(_tree_to_torch(P))
    assert u.shape == (C,) and u.dtype == torch.float64
    np.testing.assert_allclose(to_np(u), np.asarray(u_j), rtol=1e-9)
    for c in range(C):
        assert tree_max_rel(jax.tree.map(lambda x: x[c], g),
                            jax.tree.map(lambda x: x[c], g_j)) <= 1e-6


# ---- the solver battery's small problem: B=4 Van der Pol systems, one
# stiffness mu a system, from a numpy seed; both packages in float64

VDP_Y0 = 1.5 * np.random.RandomState(1).randn(4, 2)
VDP_MU = np.array([0.5, 1.0, 2.0, 3.0])
VDP_TS = np.linspace(0.0, 3.0, 9)


def jvdp(t, y, mu):
    return jnp.stack([y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]])


def tvdp(t, y, mu=VDP_MU):
    mu = torch.as_tensor(mu, dtype=y.dtype)
    return torch.stack([y[:, 1], mu * (1 - y[:, 0] ** 2) * y[:, 1]
                        - y[:, 0]], dim=1)


def vdp_both(method, options=None, ts=VDP_TS, rtol=1e-7, atol=1e-9,
             y0=VDP_Y0, mu=VDP_MU, dtype=np.float64):
    """(port ys (B, T, 2), port stats, JAX ys, JAX stats): the port's
    batched solve against the JAX solver vmapped over the systems."""
    from bayesian_ode_tpu.ode import odeint_with_stats as jstats
    from bayesian_ode_tpu_torch.ode import odeint_with_stats

    def one(y, m):
        return jstats(lambda t, yy: jvdp(t, yy, m), y, jnp.asarray(ts),
                      rtol=rtol, atol=atol, method=method, options=options)

    ys_j, st_j = jax.vmap(one)(jnp.asarray(y0.astype(dtype)),
                               jnp.asarray(mu.astype(dtype)))
    ys, st = odeint_with_stats(lambda t, y: tvdp(t, y, mu),
                               torch.tensor(y0.astype(dtype)),
                               torch.tensor(ts), rtol=rtol, atol=atol,
                               method=method, options=options, batched=True)
    return ys.transpose(0, 1), st, ys_j, st_j


def check_counts32(st_t, st_j, steps=3):
    """Two float32 solves' per-system counts: accepted and rejected within
    `steps` of each other on every system (error ratios that land within
    their rounding of 1 flip a step)."""
    for k in ("n_accepted", "n_rejected"):
        d = np.abs(to_np(st_t[k]).astype(np.int64)
                   - np.asarray(st_j[k]).astype(np.int64))
        assert d.max() <= steps, (k, d)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for the module: the solver loops run thousands of
    small operations, which eight intra-op threads a worker make several
    times slower under the suite's six workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
