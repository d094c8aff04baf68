"""Adaptive tempered SMC and the GP model's normalized log-density split of
the port against the JAX package, in float64 on the CPU.

Draws.  Both packages' draws are fixed by shape (`fixed_draws.py`).  The
JAX package keys each particle's move draws by its index; those become
the whole population's fixed draws (`patch_jax_smc_rows`), as the port
draws them (one particle's draw on every particle collapses the
population at its first resampling).

Gates.  The stage decisions (bisection on the conditional ESS) and
systematic resampling equal the JAX package's; `smc` step for step on a
conjugate Gaussian and on the GP posterior at rk4 (log Z, the ladder, ESS,
acceptance, steps, particles and their log-likelihoods) to 1e-9 relative;
the log-density split's values and gradients to 1e-10 (rk4) and 1e-9
(dopri5, the adjoint's backward solve at rtol 1e-7 takes the same steps);
with real draws, SMC's log Z on the conjugate Gaussian within 4 standard
errors (over 6 runs) plus 0.05 of the closed form.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixed_draws
from bayesian_ode_tpu.experiments import vanderpol_gp as jvg
from bayesian_ode_tpu.models import kernel_regression as jkr
from bayesian_ode_tpu_torch.experiments import vanderpol_gp as vg
from bayesian_ode_tpu_torch.samplers import batch_value_and_grad
from torch_parity import (  # noqa: F401
    GENERIC_CONFIG,
    generic_data,
    one_torch_thread,
)

jsmc = importlib.import_module("bayesian_ode_tpu.samplers.smc")
tsmc = importlib.import_module("bayesian_ode_tpu_torch.samplers.smc")
F64 = torch.float64


def _close(a, b, rtol=1e-9, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _fix(monkeypatch):
    fixed_draws.patch_jax(monkeypatch)
    fixed_draws.patch_torch(monkeypatch)
    fixed_draws.patch_jax_smc_rows(monkeypatch)


def test_resampling_and_stage_decisions_match_jax(monkeypatch):
    fixed_draws.patch_jax(monkeypatch)
    fixed_draws.patch_torch(monkeypatch)
    rng = np.random.RandomState(0)
    lw = 3.0 * rng.randn(50)
    want = jsmc._resample_indices(jax.random.PRNGKey(0), jnp.asarray(lw))
    got = tsmc._resample_indices(None, torch.tensor(lw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pos = {"a": rng.randn(50, 2), "b": rng.randn(50)}
    moved = tsmc.systematic_resample(None, torch.tensor(lw),
                                     {k: torch.tensor(v)
                                      for k, v in pos.items()})
    _close(moved["a"], pos["a"][np.asarray(want)], 0.0)
    _close(tsmc._pooled_variance({k: torch.tensor(v) for k, v in
                                  pos.items()}),
           jsmc._pooled_variance({k: jnp.asarray(v) for k, v in
                                  pos.items()}), 1e-14)
    # the next beta: a smooth population, and one whose weights
    # degenerate (an outlier 1e4 nats above the rest: the bisection floor)
    for ll in (-100.0 * rng.rand(64) - 5.0,
               np.concatenate([[1e4], -rng.rand(63)])):
        for beta in (0.0, 0.3):
            target = 0.5 * ll.shape[0]
            b_j = jsmc._next_beta(jnp.asarray(beta), jnp.asarray(ll),
                                  jnp.asarray(target))
            b_t = tsmc._next_beta(torch.tensor(beta, dtype=F64),
                                  torch.tensor(ll), torch.tensor(target,
                                                                 dtype=F64))
            _close(b_t, b_j, 1e-14)
            d = float(b_t) - beta
            _close(tsmc._conditional_ess(torch.tensor(d, dtype=F64),
                                         torch.tensor(ll)),
                   jsmc._conditional_ess(d, jnp.asarray(ll)), 1e-12)


# a conjugate Gaussian: prior N(0, I_3), M = 4 observations y_j ~ N(x, s^2 I)
D, M_OBS, S_OBS = 3, 4, 0.5
Y_OBS = np.random.RandomState(7).randn(M_OBS, D) * 0.7 + 0.4


def gauss_parts():
    yt = torch.tensor(Y_OBS)

    def ll_t(p):
        r = yt[None] - p["x"][:, None, :]
        return (-0.5 * (r ** 2).sum(dim=(1, 2)) / S_OBS ** 2
                - M_OBS * D * (np.log(S_OBS) + 0.5 * np.log(2 * np.pi)))

    def lp_t(p):
        return -0.5 * (p["x"] ** 2).sum(-1) - 0.5 * D * np.log(2 * np.pi)

    yj = jnp.asarray(Y_OBS)

    def ll_j(p):
        r = yj[None] - p["x"][:, None, :]
        return (-0.5 * jnp.sum(r ** 2, axis=(1, 2)) / S_OBS ** 2
                - M_OBS * D * (jnp.log(S_OBS) + 0.5 * np.log(2 * np.pi)))

    def lp_j(p):
        return -0.5 * jnp.sum(p["x"] ** 2, -1) - 0.5 * D * np.log(2 * np.pi)

    return (ll_t, lp_t), (ll_j, lp_j)


def exact_log_z():
    cov = S_OBS ** 2 * np.eye(M_OBS) + np.ones((M_OBS, M_OBS))
    _, logdet = np.linalg.slogdet(cov)
    quad = np.einsum("md,mn,nd->", Y_OBS, np.linalg.inv(cov), Y_OBS)
    return -0.5 * quad - 0.5 * D * logdet - 0.5 * D * M_OBS * np.log(2 * np.pi)


def _compare_runs(got, want, rtol=1e-9):
    assert got.num_stages == int(want.num_stages)
    _close(got.log_z, want.log_z, rtol)
    for name in ("betas", "ess", "accept_rate", "step_sizes"):
        _close(getattr(got, name), getattr(want, name), rtol)
    _close(got.log_lik, want.log_lik, rtol)
    for k in got.particles:
        _close(got.particles[k], want.particles[k], rtol, atol=1e-12)


def test_smc_conjugate_gaussian_step_for_step(monkeypatch):
    _fix(monkeypatch)
    (ll_t, lp_t), (ll_j, lp_j) = gauss_parts()
    x0 = np.random.RandomState(1).randn(64, D)
    want = jsmc.smc(jax.random.PRNGKey(0), ll_j, lp_j, {"x": jnp.asarray(x0)},
                    num_moves=3)
    got = tsmc.smc(None, ll_t, lp_t, {"x": torch.tensor(x0)}, num_moves=3)
    assert float(got.betas[got.num_stages - 1]) == 1.0
    assert got.num_stages >= 3
    _compare_runs(got, want)


def test_smc_conjugate_gaussian_log_z():
    (ll_t, lp_t), _ = gauss_parts()
    zs = []
    for seed in range(6):
        gen = torch.Generator().manual_seed(seed)
        x0 = {"x": torch.randn((512, D), generator=gen, dtype=F64)}
        res = tsmc.smc(gen, ll_t, lp_t, x0, num_moves=5)
        assert float(res.betas[res.num_stages - 1]) == 1.0
        zs.append(float(res.log_z))
    se = np.std(zs, ddof=1) / np.sqrt(len(zs))
    assert abs(np.mean(zs) - exact_log_z()) < 4 * se + 0.05, (zs,
                                                             exact_log_z())


@pytest.fixture(scope="module")
def gp():
    """The tiny GP posterior (3 trajectories, T = 8, a 3x3 grid) and its
    log-density split in both packages, at rk4 and dopri5."""
    data = generic_data()
    out = {"data": data}
    for solver in ("rk4", "dopri5"):
        cfg = dict(GENERIC_CONFIG, M=3, solver=solver)
        static, params0 = vg.build_model(cfg, data)
        t_parts = vg.make_gp_log_density_parts(cfg, data, static, "cpu", F64)
        jstatic = jkr.make_static(jkr.make_inducing_grid(data["Y"], M=3),
                                  sf=1.0, ell=0.75)
        j_parts = jkr.make_log_density_parts(
            jstatic, data["x0"], data["t"], data["Y"],
            jvg._make_solve(cfg)[0], precision=jax.lax.Precision.HIGHEST,
            noise=0.05)
        out[solver] = (t_parts, j_parts)
        out["params0"] = params0
    return out


def test_log_density_parts_match_jax(gp, monkeypatch):
    fixed_draws.patch_jax(monkeypatch)
    fixed_draws.patch_torch(monkeypatch)
    rng = np.random.RandomState(3)
    p0 = gp["params0"]
    P = {"U": p0["U"].numpy()[None] + 0.05 * rng.randn(3, 9, 2),
         "logsn": p0["logsn"].numpy()[None] + 0.1 * rng.randn(3, 2)}
    Pt = {k: torch.tensor(v) for k, v in P.items()}
    Pj = {k: jnp.asarray(v) for k, v in P.items()}
    for solver, rtol in (("rk4", 1e-10), ("dopri5", 1e-9)):
        t_parts, j_parts = gp[solver]
        for name in ("log_lik", "log_prior", "pointwise_log_lik",
                     "potential"):
            with torch.no_grad():
                got = getattr(t_parts, name)(Pt)
            _close(got, jax.vmap(getattr(j_parts, name))(Pj), rtol)
        u, g = batch_value_and_grad(t_parts.potential)(Pt)
        g_j = jax.vmap(jax.grad(j_parts.potential))(Pj)
        for k in g:
            _close(g[k], g_j[k], rtol * 10, atol=1e-9 * float(
                np.max(np.abs(np.asarray(g_j[k])))))
    t_parts, j_parts = gp["rk4"]
    drawn = t_parts.sample_prior(None, 5)
    want = j_parts.sample_prior(jax.random.PRNGKey(0), 5)
    for k in drawn:
        _close(drawn[k], want[k], 1e-12)


def test_smc_gp_rk4_step_for_step(gp, monkeypatch):
    _fix(monkeypatch)
    t_parts, j_parts = gp["rk4"]
    # a population near the gradient-matched start (prior draws collapse
    # onto one particle at the first resampling of this posterior, whose
    # log-likelihoods span thousands of nats)
    rng = np.random.RandomState(5)
    p0 = gp["params0"]
    x0 = {"U": p0["U"].numpy()[None] + 0.01 * rng.randn(16, 9, 2),
          "logsn": p0["logsn"].numpy()[None] + 0.05 * rng.randn(16, 2)}
    want = jsmc.smc(jax.random.PRNGKey(1), jax.vmap(j_parts.log_lik),
                    jax.vmap(j_parts.log_prior),
                    {k: jnp.asarray(v) for k, v in x0.items()}, num_moves=2,
                    max_stages=4)
    got = tsmc.smc(None, t_parts.log_lik, t_parts.log_prior,
                   {k: torch.tensor(v) for k, v in x0.items()},
                   num_moves=2, max_stages=4)
    assert got.num_stages == 4 and float(got.accept_rate[:4].max()) > 0
    assert 0 < float(got.accept_rate[3]) < 1        # accepts and rejects
    assert len(np.unique(got.log_lik.numpy())) > 8
    _compare_runs(got, want)
    with pytest.raises(ValueError, match="target_ess"):
        tsmc.smc(None, t_parts.log_lik, t_parts.log_prior,
                 {k: torch.tensor(np.asarray(v)) for k, v in x0.items()},
                 target_ess=1.0)
