"""The port's reversible-Heun adjoint (`sde.sdeint_adjoint`) against the
JAX package's `sdeint_adjoint` and against autodiff through the JAX
package's stored-trajectory scan, in float64 on the CPU.

Gates.  Forward: bit-equal to the port's `sdeint(method=
"reversible_heun")` (the same step map), within 1e-12 of max|y| of the
JAX path.  Gradients for y0, the closed-over parameters of the drift and
the diffusion (given as `adjoint_params`) and the increments dW: within
1e-10 of the largest entry of JAX's `sdeint_adjoint` gradient and of
JAX's autodiff through `sdeint`, with the cotangent on every output
point (an interior one weighted apart, so the substep-aware injection of
the output cotangents is exercised), diagonal and general noise.  Float32:
the backward pass's closed-form inverse rebuilds the forward trajectory y
within 1e-6 of max|y| at every one of 200 steps (the JAX docstring's
"about 1e-6 relative over hundreds of steps"; the auxiliary yh drifts
several times more, in both packages).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu import sde as jsde
from bayesian_ode_tpu_torch import sde as tsde
from bayesian_ode_tpu_torch.sde import adjoint as tadj
from bayesian_ode_tpu_torch.sde.sdeint import _grid_tensors, _host_grid
from torch_parity import max_rel, one_torch_thread  # noqa: F401

F64 = torch.float64
RNG = np.random.RandomState(7)
W = 0.4 * RNG.randn(3, 3)
BIAS = np.array([0.1, -0.2, 0.3])
C = 0.25
G = 0.3 * RNG.randn(3, 2)
Y0 = np.array([[0.5, -0.3, 0.8], [-0.2, 0.4, 0.1]])
TS = np.linspace(0.0, 0.8, 9)


def _setup(substeps, noise):
    n_steps = (len(TS) - 1) * substeps
    shape = (2, 3) if noise == "diagonal" else (2, 2)
    dt = 0.1 / substeps
    return np.random.RandomState(8).randn(n_steps, *shape) * np.sqrt(dt)


def _jax_fields(Wm, b, c, noise):
    drift = lambda t, y: jnp.tanh(y @ Wm.T) + b  # noqa: E731
    if noise == "diagonal":
        return drift, lambda t, y: c * jnp.cos(y)
    return drift, lambda t, y: c * (1.0 + y[..., :, None] ** 2) * G


def _torch_fields(Wm, b, c, noise):
    drift = lambda t, y: torch.tanh(y @ Wm.T) + b  # noqa: E731
    if noise == "diagonal":
        return drift, lambda t, y: c * torch.cos(y)
    Gt = torch.tensor(G)
    return drift, lambda t, y: c * (1.0 + y[..., :, None] ** 2) * Gt


def _weighted(ys, lib):
    wts = (torch.linspace(0.3, 1.7, ys.shape[0], dtype=ys.dtype)
           if lib is torch else jnp.linspace(0.3, 1.7, ys.shape[0]))
    return ((wts[:, None, None] * ys ** 2).sum()
            + 3.0 * ys[ys.shape[0] // 2].sum())


@pytest.mark.parametrize("substeps", [1, 3])
def test_forward_equals_reversible_heun_and_jax(substeps):
    dW = _setup(substeps, "diagonal")
    opts = {"dW": torch.tensor(dW), "substeps": substeps}
    Wm, b = torch.tensor(W), torch.tensor(BIAS)
    drift, diff = _torch_fields(Wm, b, C, "diagonal")
    ys_adj = tsde.sdeint_adjoint(drift, diff, torch.tensor(Y0), TS, None,
                                 options=opts, adjoint_params=(Wm, b))
    ys_ref = tsde.sdeint(drift, diff, torch.tensor(Y0), TS, None,
                         method="reversible_heun", options=opts)
    torch.testing.assert_close(ys_adj, ys_ref, rtol=0, atol=0)
    jd, jg = _jax_fields(jnp.asarray(W), jnp.asarray(BIAS), C, "diagonal")
    want = np.asarray(jsde.sdeint_adjoint(
        jd, jg, jnp.asarray(Y0), TS, None,
        options={"dW": jnp.asarray(dW), "substeps": substeps}))
    assert np.max(np.abs(ys_adj.numpy() - want)) <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("noise", ["diagonal", "general"])
@pytest.mark.parametrize("substeps", [1, 2])
def test_gradients_match_jax_adjoint_and_scan_autodiff(substeps, noise):
    dW = _setup(substeps, noise)

    def jloss(adjoint, y0, Wm, b, c, dw):
        drift, diff = _jax_fields(Wm, b, c, noise)
        opts = {"dW": dw, "substeps": substeps}
        if adjoint:
            ys = jsde.sdeint_adjoint(drift, diff, y0, TS, None,
                                     noise_type=noise, options=opts)
        else:
            ys = jsde.sdeint(drift, diff, y0, TS, None,
                             method="reversible_heun", noise_type=noise,
                             options=opts)
        return _weighted(ys, jnp)

    args = (jnp.asarray(Y0), jnp.asarray(W), jnp.asarray(BIAS),
            jnp.asarray(C), jnp.asarray(dW))
    wants = [jax.jit(jax.grad(lambda *a: jloss(adj, *a),
                              argnums=(0, 1, 2, 3, 4)))(*args)
             for adj in (True, False)]

    y0, Wm, b, c, dw = (torch.tensor(np.asarray(x), dtype=F64,
                                     requires_grad=True)
                        for x in (Y0, W, BIAS, C, dW))
    drift, diff = _torch_fields(Wm, b, c, noise)
    ys = tsde.sdeint_adjoint(drift, diff, y0, TS, None, noise_type=noise,
                             options={"dW": dw, "substeps": substeps},
                             adjoint_params=(Wm, b, c))
    got = torch.autograd.grad(_weighted(ys, torch), (y0, Wm, b, c, dw))
    for want in wants:
        for g, w in zip(got, want):
            assert max_rel(g, w) <= 1e-10, max_rel(g, w)


def test_modules_give_their_parameters_and_no_dw_cotangent():
    # nn.Module fields need no adjoint_params; increments drawn from the
    # generator get no cotangent, and the gradients equal autograd
    # through `sdeint` on the same draws
    torch.manual_seed(0)
    drift = torch.nn.Sequential(torch.nn.Linear(3, 8), torch.nn.Tanh(),
                                torch.nn.Linear(8, 3)).double()

    class Diff(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.log_sd = torch.nn.Parameter(torch.full((3,), -1.0,
                                                        dtype=F64))

        def forward(self, t, y):
            return torch.exp(self.log_sd) * torch.cos(y)

    diff = Diff()
    f = lambda t, y: drift(y)  # noqa: E731
    y0 = torch.tensor(Y0, requires_grad=True)
    ts = np.linspace(0.0, 1.0, 6)
    params = list(drift.parameters()) + list(diff.parameters())
    ys = tsde.sdeint_adjoint(f, diff, y0, ts,
                             torch.Generator().manual_seed(3),
                             options={"substeps": 4},
                             adjoint_params=params)
    got = torch.autograd.grad(_weighted(ys, torch), [y0] + params)
    ys2 = tsde.sdeint(f, diff, y0, ts, torch.Generator().manual_seed(3),
                      method="reversible_heun", options={"substeps": 4})
    want = torch.autograd.grad(_weighted(ys2, torch), [y0] + params)
    for g, w in zip(got, want):
        assert max_rel(g, w) <= 1e-10
    # a Module diffusion's parameters are found without adjoint_params
    mod_only = tsde.sdeint_adjoint(lambda t, y: -y, diff, y0, ts,
                                   torch.Generator().manual_seed(3))
    g_sd, = torch.autograd.grad(mod_only.sum(), [diff.log_sd])
    assert bool(torch.isfinite(g_sd).all()) and float(g_sd.abs().max()) > 0


def test_float32_reconstruction_drift():
    f32 = torch.float32
    rng = np.random.RandomState(0)
    Wm = torch.tensor(0.4 * rng.randn(3, 3), dtype=f32)
    b = torch.tensor(BIAS, dtype=f32)
    drift = lambda t, y: torch.tanh(y @ Wm.T) + b  # noqa: E731
    diff = lambda t, y: C * torch.cos(y)  # noqa: E731
    n = 200
    grid, out_index = _host_grid(np.linspace(0.0, 2.0, n + 1), 1)
    times, dts = _grid_tensors(grid, "cpu")
    spec = tadj._Spec(drift, diff, "diagonal", None, None, times, dts,
                      list(out_index), 0)
    dW = torch.tensor(rng.randn(n, 16, 3) * np.sqrt(dts[0]), dtype=f32)
    y = yh = torch.tensor(rng.randn(16, 3), dtype=f32)
    forward = [y]
    for k in range(n):
        y, yh = tadj._step(spec, k, y, yh, dW[k])
        forward.append(y)
    scale = max(float(x.abs().max()) for x in forward)
    worst = 0.0
    for k in reversed(range(n)):
        y, yh = tadj._inverse(spec, k, y, yh, dW[k])
        worst = max(worst, float((y - forward[k]).abs().max()))
    assert worst <= 1e-6 * scale, worst / scale


def test_errors():
    f, g = (lambda t, y: -y), (lambda t, y: 0.3 * torch.ones_like(y))
    y0 = torch.ones(2, dtype=F64)
    ts = np.linspace(0.0, 0.5, 6)
    with pytest.raises(ValueError, match="unknown sdeint_adjoint options"):
        tsde.sdeint_adjoint(f, g, y0, ts, None, options={"method": "heun"})
    with pytest.raises(ValueError, match="unknown noise_type"):
        tsde.sdeint_adjoint(f, g, y0, ts, None, noise_type="x")
    with pytest.raises(ValueError, match="needs `generator`"):
        tsde.sdeint_adjoint(f, g, y0, ts, None)
    a = tsde.sdeint_adjoint(f, g, y0, ts, torch.Generator().manual_seed(3))
    b = tsde.sdeint_adjoint(f, g, y0, ts, torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert bool(torch.isfinite(a).all())
