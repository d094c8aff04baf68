"""The port's fixed-grid SDE solvers (`bayesian_ode_tpu_torch.sde.sdeint`)
against the JAX package's, in float64 on the CPU, and against analytic
truth.

Gates.  Every method at every noise type it takes, on the same
increments (`options={"dW": ...}`), substeps included: the path within
1e-12 of max|y| of the JAX path (both take the same operations; only
rounding separates them).  Gradients through the loop (and through its
checkpointed form) within 1e-10 of the JAX package's autodiff through
its scan, relative to the largest entry.  The generator path: the JAX
package draws from per-step key splits, so the streams differ; what is
held is that one generator seed gives one path, another seed another,
and the increments have variance dt with no correlation between steps.
A batch row's path is not independent of the batch's shape here (one
stream fills the whole batch); in the JAX package neither
(`test_key_reproducible_and_batch_consistent` checks the key only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu import sde as jsde
from bayesian_ode_tpu_torch import sde as tsde
from bayesian_ode_tpu_torch.sde.sdeint import _host_grid, _increments
from torch_parity import max_rel, one_torch_thread  # noqa: F401

B, D, M = 3, 2, 3
TS = np.linspace(0.0, 0.8, 9)
RNG = np.random.RandomState(0)
W = 0.4 * RNG.randn(D, D)
BIAS = np.array([0.1, -0.2])
G = 0.3 * RNG.randn(D, M)
Y0 = RNG.randn(B, D)
C = 0.25


def _fields(lib):
    """Drift tanh(W y) + b and a state-dependent diffusion, diagonal
    (c cos y) or general (G scaled by 1 + y^2 / 4), in numpy-backed lib."""
    if lib is jnp:
        Wl, bl, Gl = jnp.asarray(W), jnp.asarray(BIAS), jnp.asarray(G)
        tanh, cos = jnp.tanh, jnp.cos
    else:
        Wl, bl, Gl = (torch.tensor(W), torch.tensor(BIAS), torch.tensor(G))
        tanh, cos = torch.tanh, torch.cos

    def drift(t, y):
        return tanh(y @ Wl.T) + bl + 0.1 * t * y

    def diag(t, y):
        return C * cos(y)

    def general(t, y):
        return (1.0 + y[..., :, None] ** 2 / 4.0) * Gl

    return drift, diag, general


def _dW(n_steps, shape, seed=1, dt=0.1):
    return np.random.RandomState(seed).randn(n_steps, *shape) * np.sqrt(dt)


CASES = [(m, "diagonal") for m in tsde.SDE_METHODS] + [
    (m, "general") for m in ("euler_maruyama", "heun", "reversible_heun")]


@pytest.mark.parametrize("substeps", [1, 3])
@pytest.mark.parametrize("method,noise", CASES)
def test_sdeint_matches_jax_on_the_same_increments(method, noise, substeps):
    n_steps = (len(TS) - 1) * substeps
    dW = _dW(n_steps, (B, D) if noise == "diagonal" else (B, M),
             dt=0.1 / substeps)
    jd, jdiag, jgen = _fields(jnp)
    td, tdiag, tgen = _fields(torch)
    want = jsde.sdeint(jd, jdiag if noise == "diagonal" else jgen,
                       jnp.asarray(Y0), TS, None, method=method,
                       noise_type=noise,
                       options={"dW": jnp.asarray(dW), "substeps": substeps})
    got = tsde.sdeint(td, tdiag if noise == "diagonal" else tgen,
                      torch.tensor(Y0), TS, None, method=method,
                      noise_type=noise,
                      options={"dW": torch.tensor(dW), "substeps": substeps})
    assert got.shape == (len(TS), B, D) and got.dtype == torch.float64
    assert np.max(np.abs(got.numpy() - np.asarray(want))) \
        <= 1e-12 * np.max(np.abs(np.asarray(want)))


def test_tree_state_matches_jax():
    # a dict state, the latent SDE's {"z", "kl"} layout: leaves in sorted
    # key order in both packages
    n_steps = 16
    dW = {"kl": _dW(n_steps, (B,), seed=2, dt=0.05),
          "z": _dW(n_steps, (B, D), seed=3, dt=0.05)}
    ts = np.linspace(0.0, 0.8, 9)

    def make(lib):
        drift, diag, _ = _fields(lib)
        zeros = jnp.zeros_like if lib is jnp else torch.zeros_like

        def f(t, s):
            return {"z": drift(t, s["z"]), "kl": 0.5 * (s["z"] ** 2).sum(-1)}

        def g(t, s):
            return {"z": diag(t, s["z"]), "kl": zeros(s["kl"])}

        return f, g

    jf, jg = make(jnp)
    tf, tg = make(torch)
    want = jsde.sdeint(jf, jg, {"z": jnp.asarray(Y0), "kl": jnp.zeros(B)},
                       ts, None, options={"dW": jax.tree.map(jnp.asarray, dW),
                                          "substeps": 2})
    got = tsde.sdeint(tf, tg, {"z": torch.tensor(Y0),
                               "kl": torch.zeros(B, dtype=torch.float64)},
                      ts, None, options={"dW": {k: torch.tensor(v)
                                                for k, v in dW.items()},
                                         "substeps": 2})
    for k in ("z", "kl"):
        assert np.max(np.abs(got[k].numpy() - np.asarray(want[k]))) \
            <= 1e-12 * np.max(np.abs(np.asarray(want[k])))


@pytest.mark.parametrize("method", ["euler_maruyama", "milstein", "heun"])
def test_gradients_through_the_loop_match_jax(method):
    # d/d(y0, W, mu) of a weighted path sum on a fixed Brownian path;
    # options={"checkpoint": True} gives the same gradient as the loop
    n = 12
    dW = _dW(n, (B, D), seed=4, dt=0.8 / n)
    ts = np.linspace(0.0, 0.8, 7)
    wts = np.linspace(0.3, 1.7, len(ts))[:, None, None]

    def jloss(y0, Wm, mu):
        ys = jsde.sdeint(lambda t, y: jnp.tanh(y @ Wm.T) - mu * y,
                         lambda t, y: C * jnp.cos(y), y0, ts, None,
                         method=method, options={"dW": jnp.asarray(dW),
                                                 "substeps": 2})
        return jnp.sum(wts * ys ** 2)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(Y0), jnp.asarray(W),
                                              jnp.asarray(0.6))
    for ckpt in (False, True):
        y0, Wm, mu = (torch.tensor(x, dtype=torch.float64,
                                   requires_grad=True)
                      for x in (Y0, W, 0.6))
        ys = tsde.sdeint(lambda t, y: torch.tanh(y @ Wm.T) - mu * y,
                         lambda t, y: C * torch.cos(y), y0, ts, None,
                         method=method,
                         options={"dW": torch.tensor(dW), "substeps": 2,
                                  "checkpoint": ckpt})
        got = torch.autograd.grad((torch.tensor(wts) * ys ** 2).sum(),
                                  (y0, Wm, mu))
        for g, w in zip(got, want):
            assert max_rel(g, w) <= 1e-10, (ckpt, max_rel(g, w))


def test_zero_diffusion_is_euler_ode():
    # sigma=0 reduces EM to explicit Euler on dy/dt = -y
    ts = np.linspace(0.0, 1.0, 101)
    gen = torch.Generator().manual_seed(0)
    ys = tsde.sdeint(lambda t, y: -y, lambda t, y: torch.zeros_like(y),
                     torch.tensor(2.0, dtype=torch.float64), ts, gen)
    np.testing.assert_allclose(float(ys[-1]), 2.0 * (1.0 - 0.01) ** 100,
                               rtol=1e-12)
    assert ys.shape == (101,)


def test_em_ou_discretization_is_exact_ar1():
    # EM on dy = -theta y dt + sigma dW is the AR(1) recursion exactly: the
    # port's generator path has its mean and variance to MC error
    theta, sigma, dt, n, npaths = 1.3, 0.7, 0.05, 40, 200_000
    ts = np.arange(n + 1) * dt
    gen = torch.Generator().manual_seed(1)
    ys = tsde.sdeint(lambda t, y: -theta * y,
                     lambda t, y: torch.full_like(y, sigma),
                     torch.full((npaths,), 1.5, dtype=torch.float64), ts,
                     gen)
    a = 1.0 - theta * dt
    mean_true = 1.5 * a ** n
    var_true = sigma ** 2 * dt * (1 - a ** (2 * n)) / (1 - a ** 2)
    yT = ys[-1].numpy()
    assert abs(yT.mean() - mean_true) < 4 * np.sqrt(var_true / npaths)
    np.testing.assert_allclose(yT.var(), var_true, rtol=0.02)


def test_strong_order_em_and_milstein():
    # GBM strong error against the exact Ito solution on one refined
    # Brownian path: EM slope about 0.5, Milstein about 1.0
    mu, sigma, T, npaths = 0.7, 0.8, 1.0, 4096
    levels = [2 ** k for k in (4, 5, 6, 7, 8)]
    n_fine = levels[-1]
    dW_fine = torch.tensor(_dW(n_fine, (npaths,), seed=2, dt=T / n_fine))
    y_exact = torch.exp((mu - 0.5 * sigma ** 2) * T + sigma * dW_fine.sum(0))
    errs = {"euler_maruyama": [], "milstein": []}
    for n in levels:
        agg = dW_fine.reshape(n, n_fine // n, npaths).sum(1)
        for method in errs:
            ys = tsde.sdeint(lambda t, y: mu * y, lambda t, y: sigma * y,
                             torch.ones(npaths, dtype=torch.float64),
                             np.linspace(0.0, T, n + 1), None, method=method,
                             options={"dW": agg})
            errs[method].append(float((ys[-1] - y_exact).abs().mean()))

    def slope(es):
        return np.polyfit(-np.log2(levels), np.log2(es), 1)[0]

    assert 0.35 < slope(errs["euler_maruyama"]) < 0.7
    assert 0.85 < slope(errs["milstein"]) < 1.2
    assert all(m < e for m, e in zip(errs["milstein"],
                                     errs["euler_maruyama"]))


def test_heun_converges_to_stratonovich():
    mu, sigma, T, npaths, n = 0.4, 0.6, 1.0, 4096, 512
    dW = torch.tensor(_dW(n, (npaths,), seed=3, dt=T / n))
    WT = dW.sum(0)
    ys = tsde.sdeint(lambda t, y: mu * y, lambda t, y: sigma * y,
                     torch.ones(npaths, dtype=torch.float64),
                     np.linspace(0, T, n + 1), None, method="heun",
                     options={"dW": dW})
    err_strat = float((ys[-1] - torch.exp(mu * T + sigma * WT)).abs().mean())
    err_ito = float((ys[-1] - torch.exp((mu - 0.5 * sigma ** 2) * T
                                        + sigma * WT)).abs().mean())
    assert err_strat < 0.02 and err_strat < 0.2 * err_ito


def test_general_noise_single_step():
    G3 = torch.tensor(RNG.randn(4, D, M))
    y0 = torch.tensor(RNG.randn(4, D))
    dW = torch.tensor(RNG.randn(1, 4, M) * np.sqrt(0.1))
    ys = tsde.sdeint(lambda t, y: -y, lambda t, y: G3, y0,
                     np.asarray([0.0, 0.1]), None, noise_type="general",
                     options={"dW": dW})
    expected = y0 - 0.1 * y0 + torch.einsum("bdm,bm->bd", G3, dW[0])
    torch.testing.assert_close(ys[-1], expected, rtol=1e-12, atol=0)


def test_substeps_match_fine_grid():
    n, k, T = 10, 8, 1.0
    dW = torch.tensor(_dW(n * k, (16,), seed=7, dt=T / (n * k)))
    y0 = torch.ones(16, dtype=torch.float64)
    f, g = (lambda t, y: 0.5 * y), (lambda t, y: 0.3 * y)
    ys_sub = tsde.sdeint(f, g, y0, np.linspace(0, T, n + 1), None,
                         options={"substeps": k, "dW": dW})
    ys_fine = tsde.sdeint(f, g, y0, np.linspace(0, T, n * k + 1), None,
                          options={"dW": dW})
    torch.testing.assert_close(ys_sub, ys_fine[::k], rtol=1e-12, atol=0)
    assert ys_sub.shape == (n + 1, 16)


def test_generator_path_reproducible_with_variance_dt():
    f, g = (lambda t, y: 0.2 * y), (lambda t, y: 0.5 * y)
    ts = np.linspace(0, 1, 33)
    y0 = torch.ones(8, dtype=torch.float64)

    def run(seed):
        return tsde.sdeint(f, g, y0, ts, torch.Generator().manual_seed(seed))

    torch.testing.assert_close(run(9), run(9), rtol=0, atol=0)
    assert float((run(9) - run(10)).abs().max()) > 1e-3
    # the drawn increments: N(0, dt) on the substep grid, uncorrelated
    grid, _ = _host_grid(np.linspace(0.0, 2.0, 21), 5)
    meta = torch.empty((4000,), dtype=torch.float64, device="meta")
    w = _increments(meta, None, torch.Generator().manual_seed(3), grid,
                    "cpu", "test")
    assert w.shape == (100, 4000)
    var = w.var(dim=1).numpy() / np.diff(grid)
    # each step's sample variance over 4,000 draws: sd sqrt(2/3999) = 0.022
    assert np.all(np.abs(var - 1.0) < 0.11), var
    corr = np.corrcoef(w.numpy())[np.triu_indices(100, 1)]
    assert np.max(np.abs(corr)) < 0.1


def test_latent_sde_girsanov_kl_channel_analytic():
    # constant drift mismatch c and diffusion g: the KL channel integrates
    # to T |c/g|^2 / 2 exactly
    c, g, T = torch.tensor([0.6, -0.2], dtype=torch.float64), 0.5, 2.0
    u2 = float(((c / g) ** 2).sum())

    def drift(t, s):
        return {"z": torch.zeros_like(s["z"]),
                "kl": torch.full_like(s["kl"], 0.5 * u2)}

    def diffusion(t, s):
        return {"z": torch.full_like(s["z"], g),
                "kl": torch.zeros_like(s["kl"])}

    f64 = torch.float64
    path = tsde.sdeint(drift, diffusion,
                       {"z": torch.zeros((3, 2), dtype=f64),
                        "kl": torch.zeros(3, dtype=f64)},
                       np.linspace(0.0, T, 41),
                       torch.Generator().manual_seed(2))
    torch.testing.assert_close(path["kl"][-1],
                               torch.full((3,), T * u2 / 2, dtype=f64),
                               rtol=1e-12, atol=0)


def test_validation_errors_match_jax():
    f, g = (lambda t, y: 0.1 * y), (lambda t, y: 0.1 * y)
    y0 = torch.ones((), dtype=torch.float64)
    ts = np.asarray([0.0, 1.0])
    gen = torch.Generator().manual_seed(0)
    for kw, match in [({"method": "x"}, "unknown SDE method"),
                      ({"noise_type": "x"}, "unknown noise_type"),
                      ({"options": {"step_size": 0.1}},
                       "unknown sdeint options"),
                      ({"method": "milstein", "noise_type": "general"},
                       "diagonal")]:
        with pytest.raises(ValueError, match=match):
            tsde.sdeint(f, g, y0, ts, gen, **kw)
        with pytest.raises(ValueError, match=match):
            jsde.sdeint(f, g, jnp.ones(()), ts, jax.random.PRNGKey(0), **kw)
    with pytest.raises(ValueError, match="increasing"):
        tsde.sdeint(f, g, y0, np.asarray([1.0, 0.0]), gen)
    with pytest.raises(ValueError, match="needs `generator`"):
        tsde.sdeint(f, g, y0, ts, None)
    with pytest.raises(ValueError, match="concrete"):
        tsde.sdeint(f, g, y0, torch.tensor(ts, requires_grad=True), gen)
    with pytest.raises(ValueError, match="dW leaf shape"):
        tsde.sdeint(f, g, y0, ts, None,
                    options={"dW": torch.zeros(2, dtype=torch.float64)})
    with pytest.raises(ValueError, match=r"\(\.\.\., D, M\)"):
        tsde.sdeint(f, g, torch.ones(3, 2, dtype=torch.float64), ts, gen,
                    noise_type="general")
