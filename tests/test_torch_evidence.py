"""The evidence estimators of the port (power ladder, TI and stepping stone
with their jackknife errors, the Gaussian reference and generalized
stepping stone, the reliability flags) against the JAX package, in
float64 on the CPU.

Draws are fixed by shape in both packages (`fixed_draws.py`); the ladder's
per-rung steps are float32 in both, and the port's float32 exp of the log
steps goes through XLA's (not correctly rounded, see test_torch_hmc.py).
Gates: every estimate, standard error, rung mean, step size and retained
log-likelihood to 1e-9 relative, the per-rung acceptance (a float32 mean
of the same accept flags in two orders) to 1e-6; the floor of non-finite
draws (TI NaN, the count) and the reliability flags equal.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixed_draws
from torch_parity import one_torch_thread  # noqa: F401

jev = importlib.import_module("bayesian_ode_tpu.samplers.evidence")
tev = importlib.import_module("bayesian_ode_tpu_torch.samplers.evidence")

D = 3
Y_OBS = np.random.RandomState(7).randn(4, D) * 0.7 + 0.4


def xla_exp(x):
    return torch.tensor(np.asarray(jnp.exp(jnp.asarray(x.numpy()))))


@pytest.fixture
def fixed(monkeypatch):
    fixed_draws.patch_jax(monkeypatch)
    fixed_draws.patch_torch(monkeypatch)
    monkeypatch.setattr(tev, "_step_of", xla_exp)


def _parts(blowup=None):
    """A conjugate Gaussian (prior N(0, I_3), four observations at noise
    0.5) in both packages; with `blowup`, the log-likelihood is -inf
    (an exploded solve) wherever x[0] > blowup."""
    yt, yj = torch.tensor(Y_OBS), jnp.asarray(Y_OBS)

    def ll_t(p):
        v = -2.0 * ((yt[None] - p["x"][:, None, :]) ** 2).sum(dim=(1, 2))
        return v if blowup is None else torch.where(
            p["x"][:, 0] > blowup, torch.full_like(v, -np.inf), v)

    def lp_t(p):
        return -0.5 * (p["x"] ** 2).sum(-1) - 0.5 * D * np.log(2 * np.pi)

    def ll_j(p):
        v = -2.0 * jnp.sum((yj[None] - p["x"][:, None, :]) ** 2, axis=(1, 2))
        return v if blowup is None else jnp.where(p["x"][:, 0] > blowup,
                                                  -jnp.inf, v)

    def lp_j(p):
        return -0.5 * jnp.sum(p["x"] ** 2, -1) - 0.5 * D * np.log(2 * np.pi)

    return (ll_t, lp_t), (ll_j, lp_j)


def _x0(C=6, seed=1):
    x = np.random.RandomState(seed).randn(C, D)
    return {"x": torch.tensor(x)}, {"x": jnp.asarray(x)}


def _compare(got, want, rtol=1e-9):
    for name in ("log_z_ti", "log_z_ss", "mean_log_lik", "log_lik_draws",
                 "ti_se", "ss_se", "step_sizes", "betas"):
        np.testing.assert_allclose(np.asarray(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   rtol=rtol, err_msg=name)
    # float32 means of the same accept flags, summed in two orders
    np.testing.assert_allclose(got.accept_rate.numpy(),
                               np.asarray(want.accept_rate), rtol=1e-6)
    assert int(got.num_nonfinite) == int(want.num_nonfinite)


def test_power_ladder_matches_jax():
    for k in (2, 4, 16):
        np.testing.assert_array_equal(tev.power_ladder(k).numpy(),
                                      np.asarray(jev.power_ladder(k)))
    with pytest.raises(ValueError, match="2 rungs"):
        tev.power_ladder(1)


@pytest.mark.parametrize("adapt", [True, False])
def test_log_evidence_step_for_step(fixed, adapt):
    (ll_t, lp_t), (ll_j, lp_j) = _parts()
    xt, xj = _x0()
    kw = dict(num_rungs=4, step_size=0.05, num_warmup=8, num_samples=12,
              thin=2, adapt_step=adapt)
    want = jev.log_evidence(jax.random.PRNGKey(0), ll_j, lp_j, xj, **kw)
    got = tev.log_evidence(None, ll_t, lp_t, xt, **kw)
    _compare(got, want)
    acc = got.accept_rate.numpy()
    assert 0 < acc.min() and acc.max() <= 1
    # a (K,) step-size array and an explicit ladder
    betas = np.asarray([0.0, 0.1, 0.5, 1.0])
    steps = np.asarray([0.2, 0.1, 0.05, 0.02])
    want = jev.log_evidence(jax.random.PRNGKey(0), ll_j, lp_j, xj, betas,
                            **dict(kw, step_size=jnp.asarray(steps)))
    got = tev.log_evidence(None, ll_t, lp_t, xt, betas,
                           **dict(kw, step_size=steps))
    _compare(got, want)


def test_nonfinite_draws_are_floored_as_in_jax(fixed):
    for blowup in (0.3, -1e9):      # some draws; then every draw
        (ll_t, lp_t), (ll_j, lp_j) = _parts(blowup)
        xt, xj = _x0()
        kw = dict(num_rungs=3, step_size=0.05, num_warmup=4, num_samples=6,
                  adapt_step=True)
        want = jev.log_evidence(jax.random.PRNGKey(0), ll_j, lp_j, xj, **kw)
        got = tev.log_evidence(None, ll_t, lp_t, xt, **kw)
        assert int(got.num_nonfinite) == int(want.num_nonfinite) > 0
        assert np.isnan(float(got.log_z_ti)) and np.isnan(
            float(want.log_z_ti))
        assert np.isnan(float(got.log_z_ss)) == np.isnan(
            float(want.log_z_ss)) == (blowup < 0)
        for name in ("log_z_ss", "ss_se", "log_lik_draws", "mean_log_lik"):
            np.testing.assert_allclose(np.asarray(getattr(got, name)),
                                       np.asarray(getattr(want, name)),
                                       rtol=1e-9, err_msg=name)


def test_ladder_argument_checks():
    (ll_t, lp_t), _ = _parts()
    xt, _ = _x0()
    for betas, match in (([0.0], ">= 2"), ([0.1, 1.0], "beta_0 = 0"),
                         ([0.0, 0.5, 0.5, 1.0], "strictly increasing")):
        with pytest.raises(ValueError, match=match):
            tev.log_evidence(None, ll_t, lp_t, xt, betas)
    with pytest.raises(ValueError, match="shape"):
        tev.log_evidence(None, ll_t, lp_t, xt, num_rungs=3,
                         step_size=[0.1, 0.2])
    with pytest.raises(ValueError, match="multiple of thin"):
        tev.log_evidence(None, ll_t, lp_t, xt, num_samples=5, thin=2)


def test_gaussian_reference_and_gss_step_for_step(fixed):
    (ll_t, lp_t), (ll_j, lp_j) = _parts()
    draws = np.random.RandomState(2).randn(40, D) * 0.3 + 0.2
    ref_t, sample_t = tev.fit_gaussian_reference({"x": torch.tensor(draws)})
    ref_j, sample_j = jev.fit_gaussian_reference({"x": jnp.asarray(draws)})
    probe = np.random.RandomState(3).randn(7, D)
    np.testing.assert_allclose(ref_t({"x": torch.tensor(probe)}).numpy(),
                               np.asarray(ref_j({"x": jnp.asarray(probe)})),
                               rtol=1e-12)
    np.testing.assert_allclose(
        sample_t(None, 5)["x"].numpy(),
        np.asarray(sample_j(jax.random.PRNGKey(0), 5)["x"]), rtol=1e-12)
    kw = dict(num_chains=6, num_rungs=4, step_size=0.02, num_warmup=6,
              num_samples=8, adapt_step=True)
    want = jev.log_evidence_gss(jax.random.PRNGKey(0), ll_j, lp_j,
                                {"x": jnp.asarray(draws)}, **kw)
    got = tev.log_evidence_gss(None, ll_t, lp_t, {"x": torch.tensor(draws)},
                               **kw)
    _compare(got, want)


RELIABILITY_CASES = [
    dict(log_z_ti=-90.0, log_z_ss=-70.0, ss_se=1.0, log_z_gss=-68.2,
         gss_se=0.5, log_z_smc=-68.0, smc_se=0.6, log_z_laplace=-67.0,
         laplace_hessian_pd=True, waic_elpd=-48.0),
    dict(log_z_ti=float("nan"), log_z_ss=-68.5, ss_se=0.4, log_z_gss=-60.0,
         gss_se=0.1, log_z_smc=-68.0, smc_se=float("nan"),
         log_z_laplace=-40.0, laplace_hessian_pd=True, waic_elpd=-48.0,
         ladder_nonfinite=3),
    dict(log_z_ti=-90.0, log_z_ss=float("nan"), ss_se=0.4,
         log_z_gss=float("nan"), gss_se=0.1, log_z_smc=float("nan"),
         smc_se=0.2, log_z_laplace=-60.0, laplace_hessian_pd=False,
         waic_elpd=-48.0, gss_nonfinite=2),
    dict(log_z_ti=-90.0, log_z_ss=-68.1, ss_se=0.4, log_z_gss=-68.3,
         gss_se=0.1, log_z_smc=-68.0, smc_se=0.2, log_z_laplace=-60.0,
         laplace_hessian_pd=True, waic_elpd=float("nan"), gss_nonfinite=2),
]


@pytest.mark.parametrize("case", range(len(RELIABILITY_CASES)))
def test_evidence_reliability_matches_jax(case):
    kw = RELIABILITY_CASES[case]
    assert tev.evidence_reliability(**kw) == jev.evidence_reliability(**kw)
