"""The port's Goodman-Weare stretch move (`samplers/ensemble.py`) against
the JAX package's, on the CPU: steps with the partner picks, the stretch
factors and the Metropolis uniforms fixed in both packages
(`fixed_draws.py`), the validation errors, and the JAX package's moment
gates (tests/test_ensemble.py).

Gates.  Float64 walkers and potentials to 1e-9 relative step for step,
accept masks equal; the statistical gates are the JAX package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixed_draws
from bayesian_ode_tpu import samplers as jsamplers
from bayesian_ode_tpu_torch import samplers
from torch_parity import one_torch_thread  # noqa: F401

F64 = torch.float64


def _pot_t(p):
    v = torch.stack([p["a"], p["b"]], dim=-1)
    return 0.5 * (v ** 2).sum(-1) + 0.3 * p["a"] * p["b"] + (p["c"] ** 2
                                                              ).sum(-1)


def _pot_j(p):
    v = jnp.stack([p["a"], p["b"]], axis=-1)
    return 0.5 * (v ** 2).sum(-1) + 0.3 * p["a"] * p["b"] + (p["c"] ** 2
                                                              ).sum(-1)


@pytest.mark.parametrize("a", [2.0, 1.5])
def test_stretch_move_matches_jax(a, monkeypatch):
    fixed_draws.patch_jax(monkeypatch)
    fixed_draws.patch_torch(monkeypatch)
    rng = np.random.RandomState(3)
    pos = {"a": rng.randn(8), "b": rng.randn(8), "c": rng.randn(8, 2)}
    tk, jk = samplers.stretch_move(_pot_t, a=a), \
        jsamplers.stretch_move(_pot_j, a=a)
    ts = tk.init({k: torch.tensor(v) for k, v in pos.items()})
    js = jk.init({k: jnp.asarray(v) for k, v in pos.items()})
    jstep = jax.jit(jk.step)
    n_acc = 0
    for i in range(15):
        ts, ti = tk.step(None, ts)
        js, ji = jstep(jax.random.PRNGKey(i), js)
        for k in pos:
            np.testing.assert_allclose(ts.position[k].numpy(),
                                       np.asarray(js.position[k]),
                                       rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(ti["potential"].numpy(),
                                   np.asarray(ji["potential"]), rtol=1e-9)
        np.testing.assert_array_equal(ti["accepted"].numpy(),
                                      np.asarray(ji["accepted"]))
        n_acc += int(ti["accepted"].sum())
    assert 0 < n_acc < 15 * 8
    assert ts.step == 15


def test_validation():
    def pot(x):
        return 0.5 * (x ** 2).sum(-1)

    with pytest.raises(ValueError):
        samplers.stretch_move(pot, a=1.0)
    kern = samplers.stretch_move(pot)
    with pytest.raises(ValueError):
        kern.init(torch.zeros((5, 2), dtype=F64))          # odd
    with pytest.raises(ValueError):
        kern.init(torch.zeros((2, 2), dtype=F64))          # too few


def _run(pot, init, steps=3000, burn=1000, seed=0, a=2.0):
    kernel = samplers.stretch_move(pot, a=a)
    gen = torch.Generator().manual_seed(seed)
    _, positions, infos = samplers.sample_chain(
        kernel, kernel.init(init), gen, steps, burn_in=burn)
    return positions, infos


def test_isotropic_gaussian_moments():
    gen = torch.Generator().manual_seed(1)
    init = {"x": torch.randn((64, 3), generator=gen, dtype=F64)}
    positions, infos = _run(lambda p: 0.5 * (p["x"] ** 2).sum(-1), init)
    xs = positions["x"].reshape(-1, 3).numpy()
    assert np.allclose(xs.mean(0), 0.0, atol=0.08)
    assert np.allclose(xs.var(0), 1.0, atol=0.12)
    acc = float(infos["accepted"].double().mean())
    assert 0.15 < acc < 0.9
    assert infos["accepted"].shape[-1] == 64


def test_affine_invariance_on_ill_conditioned_gaussian():
    """diag(1, 1e-4) covariance, no tuning: the variances are recovered
    and the acceptance does not collapse."""
    s2 = torch.tensor([1.0, 1e-4], dtype=F64)
    gen = torch.Generator().manual_seed(2)
    init = 0.1 * torch.randn((128, 2), generator=gen, dtype=F64)
    positions, infos = _run(lambda x: 0.5 * (x ** 2 / s2).sum(-1), init,
                            steps=4000, burn=2000)
    xs = positions.reshape(-1, 2).numpy()
    assert np.allclose(xs.var(0), s2.numpy(), rtol=0.2)
    assert float(infos["accepted"].double().mean()) > 0.15


def test_correlated_gaussian_and_tree_positions():
    rho = 0.9
    prec = torch.as_tensor(np.linalg.inv([[1.0, rho], [rho, 1.0]]))

    def pot(p):
        v = torch.stack([p["a"], p["b"]], dim=-1)
        return 0.5 * torch.einsum("ni,ij,nj->n", v, prec, v)

    gen = torch.Generator().manual_seed(3)
    init = {"a": torch.randn(64, generator=gen, dtype=F64),
            "b": torch.randn(64, generator=gen, dtype=F64)}
    positions, _ = _run(pot, init, steps=4000, burn=2000)
    a, b = positions["a"].reshape(-1).numpy(), \
        positions["b"].reshape(-1).numpy()
    assert abs(np.corrcoef(a, b)[0, 1] - rho) < 0.05
    assert abs(a.var() - 1.0) < 0.15
