"""The port's latent-ODE and latent-SDE models against the JAX package's,
in float64 on the CPU, with the JAX package's own parameters
(`init_params`, carried over by `params_from_numpy`) and data.

Gates.  The latent-ODE -ELBO on JAX's reparameterization noise (its
`jax.random.normal` of the key the JAX loss takes), through rk4 with
autograd through the loop and through dopri5 with the continuous
adjoint, and its gradient for every parameter: within 1e-10 relative of
the JAX loss's (`jax.value_and_grad`).  The latent-SDE -ELBO on JAX's
draws (z0's noise and the path's increments, split from the loss's key
as the JAX loss and its `sdeint` split it) and its gradient: within 1e-10
relative.  The encoders' outputs within 1e-12; `generate_spiral2d` equal
to the JAX package's bit for bit.  The generator-driven losses and the
samplers of the prior and the posterior run and stay finite, and every
parameter group gets a gradient, as in the JAX package's tests.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu import odeint as jodeint
from bayesian_ode_tpu import odeint_adjoint as jodeint_adjoint
from bayesian_ode_tpu.models import latent_ode as jlo
from bayesian_ode_tpu.models import latent_sde as jls
from bayesian_ode_tpu.sde.sdeint import _host_grid
from bayesian_ode_tpu_torch import odeint, odeint_adjoint
from bayesian_ode_tpu_torch.models import latent_ode as tlo
from bayesian_ode_tpu_torch.models import latent_sde as tls
from bayesian_ode_tpu_torch.utils.pytree import tree_leaves
from torch_parity import max_rel, one_torch_thread  # noqa: F401

F64 = torch.float64


def _grads_match(grads, jgrads, tol):
    for g, w in zip(grads, jax.tree.leaves(jgrads)):
        assert float(np.abs(g.numpy() - np.asarray(w)).max()) \
            <= tol * max(float(np.abs(np.asarray(w)).max()), 1e-300)


@pytest.fixture(scope="module")
def spirals():
    _, samp, _, samp_ts = jlo.generate_spiral2d(nspiral=4, ntotal=60,
                                                nsample=10, noise_std=0.3)
    params = jlo.init_params(jax.random.PRNGKey(0), latent_dim=4,
                             obs_dim=2, nhidden=8, rnn_nhidden=8)
    return samp, samp_ts, jax.tree.map(np.asarray, params)


def test_generate_spiral2d_is_the_jax_data():
    for kw in ({}, {"nspiral": 7, "ntotal": 80, "nsample": 12, "seed": 3,
                    "noise_std": 0.1}):
        for a, b in zip(tlo.generate_spiral2d(**kw),
                        jlo.generate_spiral2d(**kw)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("solver", ["rk4", "dopri5_adjoint"])
def test_latent_ode_loss_and_gradient_match_jax(spirals, solver):
    samp, samp_ts, params = spirals
    key = jax.random.PRNGKey(5)
    tp = tlo.params_from_numpy(params)
    leaves = [x.requires_grad_(True) for x in tree_leaves(tp)]
    if solver == "rk4":
        jo, to = (partial(jodeint, method="rk4"), partial(odeint,
                                                          method="rk4"))
    else:
        jo = partial(jodeint_adjoint, rtol=1e-7, atol=1e-9, method="dopri5")
        to = partial(odeint_adjoint, rtol=1e-7, atol=1e-9, method="dopri5",
                     adjoint_params=tree_leaves(tp["func"]))
    jloss = jlo.make_loss(jo, jnp.asarray(samp), jnp.asarray(samp_ts),
                          rnn_nhidden=8)
    want, gwant = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, params), key)
    eps = torch.tensor(np.asarray(jax.random.normal(key, (4, 4))))
    body = tlo._elbo(to, torch.tensor(samp), torch.tensor(samp_ts), 0.3, 8)
    got = body(tp, eps)
    grads = torch.autograd.grad(got, leaves)
    assert abs(float(got) - float(want)) <= 1e-10 * abs(float(want))
    _grads_match(grads, gwant, 1e-10)
    # the encoder on its own
    mu_j, lv_j = jlo.encode(jax.tree.map(jnp.asarray, params["rec"]),
                            jnp.asarray(samp), 8)
    mu, lv = tlo.encode(tp["rec"], torch.tensor(samp), 8)
    assert max_rel(mu, mu_j) <= 1e-12 and max_rel(lv, lv_j) <= 1e-12
    # the public loss draws eps from a generator
    loss = tlo.make_loss(to, torch.tensor(samp), torch.tensor(samp_ts),
                         rnn_nhidden=8)
    assert np.isfinite(float(loss(tp, torch.Generator().manual_seed(0))))


B, T, L = 5, 9, 3
SUBSTEPS = 2


@pytest.fixture(scope="module")
def latent_sde_problem():
    params = jls.init_params(jax.random.PRNGKey(21), latent_dim=L,
                             obs_dim=2, ctx_dim=4, nhidden=8, rnn_nhidden=8)
    ts = np.linspace(0.0, 1.0, T)
    xs = np.asarray(jax.random.normal(jax.random.PRNGKey(22), (B, T, 2)))
    return jax.tree.map(np.asarray, params), ts, xs


def _jax_draws(key, ts):
    """The noise the JAX loss draws from `key`: eps for z0, then the path's
    increments as its sdeint draws them (one key a step, split over the
    state's leaves in sorted order: "kl", "z")."""
    k_z0, k_path = jax.random.split(key)
    eps = jax.random.normal(k_z0, (B, L))
    grid, _ = _host_grid(ts, SUBSTEPS)
    dW = {"kl": [], "z": []}
    for k, dt in zip(jax.random.split(k_path, len(grid) - 1), np.diff(grid)):
        ks = jax.random.split(k, 2)
        dW["kl"].append(jax.random.normal(ks[0], (B,)) * jnp.sqrt(dt))
        dW["z"].append(jax.random.normal(ks[1], (B, L)) * jnp.sqrt(dt))
    return (torch.tensor(np.asarray(eps)),
            {k: torch.tensor(np.stack(v)) for k, v in dW.items()})


def test_latent_sde_loss_and_gradient_match_jax(latent_sde_problem):
    params, ts, xs = latent_sde_problem
    key = jax.random.PRNGKey(23)
    jloss = jls.make_loss(ts, xs, substeps=SUBSTEPS)
    want, gwant = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, params), key)
    tp = tls.params_from_numpy(params)
    leaves = [x.requires_grad_(True) for x in tree_leaves(tp)]
    eps, dW = _jax_draws(key, ts)
    got = tls._elbo(ts, torch.tensor(xs), 0.1, SUBSTEPS, 1.0)(tp, eps, dW)
    grads = torch.autograd.grad(got, leaves)
    assert abs(float(got) - float(want)) <= 1e-10 * abs(float(want))
    _grads_match(grads, gwant, 1e-10)
    # the encoder: context, q(z0)
    for a, b in zip(tls.encode(tp, torch.tensor(xs)),
                    jls.encode(jax.tree.map(jnp.asarray, params),
                               jnp.asarray(xs))):
        assert max_rel(a, b) <= 1e-12


def test_latent_sde_generator_paths(latent_sde_problem):
    params, ts, xs = latent_sde_problem
    tp = tls.params_from_numpy(params)
    leaves = [x.requires_grad_(True) for x in tree_leaves(tp)]
    loss = tls.make_loss(torch.tensor(ts), torch.tensor(xs),
                         substeps=SUBSTEPS)
    val = loss(tp, torch.Generator().manual_seed(1))
    assert float(val) == float(loss(tp, torch.Generator().manual_seed(1)))
    grads = dict(zip(map(id, leaves), torch.autograd.grad(val, leaves)))
    for name in tp:
        gs = [grads[id(x)] for x in tree_leaves(tp[name])]
        assert all(bool(torch.isfinite(g).all()) for g in gs), name
        assert any(float(g.abs().max()) > 0 for g in gs), name
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        prior = tls.sample_prior(tp, gen, ts, 6, substeps=SUBSTEPS)
        post = tls.sample_posterior(tp, gen, ts, torch.tensor(xs),
                                    substeps=SUBSTEPS)
    assert prior.shape == (6, T, 2) and post.shape == (B, T, 2)
    assert bool(torch.isfinite(prior).all() and torch.isfinite(post).all())
    # the port's own init has the JAX package's shapes
    mine = tls.init_params(torch.Generator().manual_seed(0), latent_dim=L,
                           obs_dim=2, ctx_dim=4, nhidden=8, rnn_nhidden=8,
                           dtype=F64)
    assert [tuple(x.shape) for x in tree_leaves(mine)] == \
        [tuple(np.shape(x)) for x in jax.tree.leaves(params)]
    mine = tlo.init_params(torch.Generator().manual_seed(0), nhidden=8,
                           rnn_nhidden=8)
    want = jlo.init_params(jax.random.PRNGKey(0), nhidden=8, rnn_nhidden=8)
    assert [tuple(x.shape) for x in tree_leaves(mine)] == \
        [tuple(x.shape) for x in jax.tree.leaves(want)]
