"""The port's continuous normalizing flow (`models.cnf`) against the JAX
package's, in float64 on the CPU, and against closed forms.

Gates.  `cnf_log_prob` with the exact trace and with the Hutchinson trace
on the same probes (both packages' `rademacher` patched to return them),
through fixed-grid rk4 (step 0.1 on the decreasing grid [1, 0]) with
autograd through the loop, and through dopri5 (rtol 1e-7) with the
continuous adjoint: the mean log-density and its gradient for every
parameter within 1e-10 relative of the JAX package's (measured about
1e-14).  The default dopri5 solve (rtol 1e-5), `augmented_field`,
`make_nll` and `make_potential`: within 1e-10 relative.  The identity
flow is the base density and a linear flow has its closed form, as in
the JAX package's tests; sampling inverts log_prob; a few Adam steps
lower the NLL.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu import odeint as jodeint
from bayesian_ode_tpu import odeint_adjoint as jodeint_adjoint
from bayesian_ode_tpu.models import cnf as jcnf
from bayesian_ode_tpu_torch import odeint, odeint_adjoint
from bayesian_ode_tpu_torch.models import cnf
from bayesian_ode_tpu_torch.utils.pytree import tree_leaves
from torch_parity import one_torch_thread, tree_max_rel  # noqa: F401

F64 = torch.float64
X = np.random.RandomState(0).randn(16, 2)
PROBES = np.sign(np.random.RandomState(1).randn(16, 2))


@pytest.fixture(scope="module")
def params():
    """The JAX package's init at hidden (8, 8), its zeroed last layer given
    weights so the flow is not the identity."""
    p = jcnf.init_cnf_mlp(jax.random.PRNGKey(7), dim=2, hidden=(8, 8))
    p[-1]["w"] = 0.3 * jax.random.normal(jax.random.PRNGKey(8),
                                         p[-1]["w"].shape)
    p[-1]["b"] = 0.1 * jax.random.normal(jax.random.PRNGKey(9),
                                         p[-1]["b"].shape)
    return jax.tree.map(np.asarray, p)


@pytest.fixture
def fixed_probes(monkeypatch):
    monkeypatch.setattr(jcnf, "rademacher",
                        lambda key, shape, dtype=None: jnp.asarray(PROBES))
    monkeypatch.setattr(cnf, "rademacher",
                        lambda gen, shape, dtype=None, device=None:
                        torch.tensor(PROBES))


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


@pytest.mark.parametrize("solver", ["rk4", "dopri5_adjoint"])
@pytest.mark.parametrize("trace", ["exact", "hutchinson"])
def test_log_prob_and_gradient_match_jax(params, fixed_probes, trace,
                                         solver):
    tp = cnf.params_from_numpy(params)
    leaves = [x.requires_grad_(True) for x in tree_leaves(tp)]
    if solver == "rk4":
        jo = partial(jodeint, method="rk4", options={"step_size": 0.1})
        to = partial(odeint, method="rk4", options={"step_size": 0.1})
    else:
        jo = partial(jodeint_adjoint, rtol=1e-7, atol=1e-9, method="dopri5")
        to = partial(odeint_adjoint, rtol=1e-7, atol=1e-9, method="dopri5",
                     adjoint_params=leaves)

    def jloss(p):
        return jnp.mean(jcnf.cnf_log_prob(
            lambda t, z: jcnf.cnf_field(p, t, z), jnp.asarray(X),
            odeint_fn=jo, trace=trace, key=jax.random.PRNGKey(0)))

    want, gwant = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray,
                                                         params))
    got = cnf.cnf_log_prob(lambda t, z: cnf.cnf_field(tp, t, z),
                           torch.tensor(X), odeint_fn=to, trace=trace,
                           generator=torch.Generator()).mean()
    grads = torch.autograd.grad(got, leaves)
    assert _rel(got, want) <= 1e-10
    for g, w in zip(grads, jax.tree.leaves(gwant)):
        assert float(np.abs(g.numpy() - np.asarray(w)).max()) \
            <= 1e-10 * float(np.abs(np.asarray(w)).max())


def test_default_solve_augmented_field_nll_and_potential(params,
                                                         fixed_probes):
    tp = cnf.params_from_numpy(params)
    jp = jax.tree.map(jnp.asarray, params)
    field_j = lambda t, z: jcnf.cnf_field(jp, t, z)  # noqa: E731
    field_t = lambda t, z: cnf.cnf_field(tp, t, z)  # noqa: E731
    # the default dopri5 at rtol=1e-5, with z(t0) returned
    want, z0_j = jcnf.cnf_log_prob(field_j, jnp.asarray(X), return_z0=True)
    got, z0 = cnf.cnf_log_prob(field_t, torch.tensor(X), return_z0=True)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) \
        <= 1e-10 * float(np.abs(np.asarray(want)).max())
    assert float(np.abs(z0.numpy() - np.asarray(z0_j)).max()) <= 1e-10
    # the augmented field at one state, both traces
    for trace, probes in (("exact", None), ("hutchinson", PROBES)):
        dz_j, tr_j = jcnf.augmented_field(
            field_j, trace, None if probes is None else jnp.asarray(probes))(
            0.3, (jnp.asarray(X), jnp.zeros(16)))
        dz, tr = cnf.augmented_field(
            field_t, trace, None if probes is None else torch.tensor(probes))(
            torch.tensor(0.3, dtype=F64),
            (torch.tensor(X), torch.zeros(16, dtype=F64)))
        np.testing.assert_allclose(dz.numpy(), np.asarray(dz_j), rtol=1e-12)
        np.testing.assert_allclose(tr.numpy(), np.asarray(tr_j), rtol=1e-12,
                                   atol=1e-14)
    # make_nll and make_potential (rk4, Hutchinson probes drawn once)
    jo = partial(jodeint, method="rk4", options={"step_size": 0.25})
    to = partial(odeint, method="rk4", options={"step_size": 0.25})
    for jmake, tmake in ((jcnf.make_nll, cnf.make_nll),
                         (jcnf.make_potential, cnf.make_potential)):
        want = jmake(jnp.asarray(X), odeint_fn=jo, trace="hutchinson",
                     key=jax.random.PRNGKey(1))(jp)
        fn = tmake(torch.tensor(X), odeint_fn=to, trace="hutchinson",
                   generator=torch.Generator().manual_seed(1))
        assert _rel(fn(tp), want) <= 1e-10
        assert float(fn(tp)) == float(fn(tp))


def test_identity_flow_is_base_and_linear_flow_closed_form():
    gen = torch.Generator().manual_seed(0)
    params = cnf.init_cnf_mlp(gen, dim=2, dtype=F64)
    assert all(float(v.abs().max()) == 0 for v in params[-1].values())
    x = 1.5 * torch.randn((16, 2), generator=gen, dtype=F64)
    logp = cnf.cnf_log_prob(lambda t, z: cnf.cnf_field(params, t, z), x)
    torch.testing.assert_close(logp, cnf.standard_normal_logpdf(x),
                               rtol=1e-6, atol=1e-7)
    # dz/dt = A z, diagonal A: log p1(x) = log N(e^{-A} x; 0, I) - tr(A)
    a = torch.tensor([0.3, -0.5], dtype=F64)
    x = 2.0 * torch.randn((32, 2), generator=gen, dtype=F64)
    logp = cnf.cnf_log_prob(lambda t, z: z * a, x,
                            odeint_fn=partial(odeint, rtol=1e-9, atol=1e-11))
    want = cnf.standard_normal_logpdf(x * torch.exp(-a)) - a.sum()
    torch.testing.assert_close(logp, want, rtol=1e-6, atol=1e-6)


def test_sample_logprob_roundtrip():
    gen = torch.Generator().manual_seed(7)
    params = cnf.init_cnf_mlp(gen, dim=2, hidden=(16, 16), dtype=F64)
    params[-1]["w"] = 0.2 * torch.randn(params[-1]["w"].shape,
                                        generator=gen, dtype=F64)
    field = lambda t, z: cnf.cnf_field(params, t, z)  # noqa: E731
    ofn = partial(odeint, rtol=1e-8, atol=1e-10)
    xs, logp_fwd = cnf.sample_cnf(field, gen, 64, 2, odeint_fn=ofn,
                                  trace="exact", dtype=F64)
    logp_bwd, z0 = cnf.cnf_log_prob(field, xs, odeint_fn=ofn,
                                    return_z0=True)
    torch.testing.assert_close(logp_bwd, logp_fwd, rtol=1e-5, atol=1e-5)
    assert float(z0.mean(0).abs().max()) < 0.4
    assert cnf.sample_cnf(field, gen, 8, 2, odeint_fn=ofn,
                          dtype=F64).shape == (8, 2)
    probes = cnf.rademacher(gen, (1000, 3), F64)
    assert set(probes.unique().tolist()) == {-1.0, 1.0}


def test_training_lowers_the_nll():
    # a shifted, correlated Gaussian, rk4 at step 0.25, Hutchinson trace:
    # a few Adam steps beat the identity flow's NLL
    gen = torch.Generator().manual_seed(12)
    chol = torch.tensor([[1.0, 0.0], [0.8, 0.6]], dtype=F64)
    x = torch.randn((128, 2), generator=gen, dtype=F64) @ chol.T \
        + torch.tensor([1.5, -1.0], dtype=F64)
    nll = cnf.make_nll(x, odeint_fn=partial(odeint, method="rk4",
                                            options={"step_size": 0.25}),
                       trace="hutchinson", generator=gen)
    params = cnf.init_cnf_mlp(gen, dim=2, hidden=(16,), dtype=F64)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    opt = torch.optim.Adam(leaves, lr=5e-2)
    losses = []
    for _ in range(25):
        opt.zero_grad()
        loss = nll(params)
        loss.backward()
        opt.step()
        losses.append(float(loss))
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])


def test_errors():
    field = lambda t, z: -z  # noqa: E731
    x = torch.zeros((4, 2), dtype=F64)
    with pytest.raises(ValueError, match="generator"):
        cnf.cnf_log_prob(field, x, trace="hutchinson")
    with pytest.raises(ValueError, match="unknown trace"):
        cnf.augmented_field(field, "not-a-trace")
    with pytest.raises(ValueError, match="fixed probes"):
        cnf.augmented_field(field, "hutchinson")
