"""Parity of the port's complex states (view-as-real at the solver
boundary, `odeint.complex_to_real`) with the JAX package's, in float64 on
the CPU: the rotation y' = i w y through every kind of solver against the
closed form and the JAX solve, the real view's layout, mixed trees,
gradients, batches, complex64, and the adjoint (which the port supports
and the JAX package rejects)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu.ode import odeint_with_stats as jstats
from bayesian_ode_tpu_torch import odeint, odeint_adjoint, odeint_with_stats
from bayesian_ode_tpu_torch.ode.odeint import complex_to_real
from torch_parity import one_torch_thread, to_np  # noqa: F401

W = 2.0
Z0 = np.array([1.0 + 0.5j])


def trot(t, y):
    return 1j * W * y


def exact(ts):
    return Z0[None] * np.exp(1j * W * ts)[:, None]


@pytest.mark.parametrize("method,tol,options", [
    ("dopri5", 1e-7, None), ("dopri8", 1e-7, None), ("tsit5", 1e-8, None),
    ("adams", 1e-4, None), ("fixed_adams", 1e-3, {"step_size": 0.02}),
    ("sdirk4", 1e-7, None)])
def test_complex_rotation_matches_jax(method, tol, options):
    ts = np.linspace(0.0, 3.0, 7)
    ys, st = odeint_with_stats(trot, torch.tensor(Z0), torch.tensor(ts),
                               rtol=1e-9, atol=1e-11, method=method,
                               options=options)
    assert ys.dtype == torch.complex128
    assert np.abs(to_np(ys) - exact(ts)).max() < tol
    ys_j, st_j = jstats(lambda t, y: 1j * W * y, jnp.asarray(Z0),
                        jnp.asarray(ts), rtol=1e-9, atol=1e-11,
                        method=method, options=options)
    # adams amplifies the fields' rounding (test_torch_vcabm.py)
    bar = 1e-7 if method == "adams" else 1e-12
    np.testing.assert_allclose(to_np(ys), np.asarray(ys_j), rtol=0,
                               atol=bar)
    for k in ("nfe", "n_accepted", "n_rejected"):
        assert int(st[k]) == int(st_j[k]), k


def test_real_view_layout_and_mixed_tree():
    """[Re, Im] on a new trailing axis, as the JAX package stacks them; a
    real leaf beside a complex one keeps its dtype."""
    _, y_real, unpack = complex_to_real(trot, {"z": torch.tensor(Z0),
                                               "x": torch.ones(2)})
    assert y_real["z"].shape == (1, 2) and y_real["x"].dtype == torch.float32
    np.testing.assert_array_equal(to_np(y_real["z"]),
                                  np.stack([Z0.real, Z0.imag], -1))
    assert torch.is_complex(unpack(y_real)["z"])

    def g(t, y):
        return {"z": 1j * y["z"], "x": -y["x"]}

    ys = odeint(g, {"z": torch.tensor(1.0 + 0j, dtype=torch.complex128),
                    "x": torch.tensor(1.0, dtype=torch.float64)},
                torch.linspace(0.0, 1.0, 3, dtype=torch.float64))
    assert torch.is_complex(ys["z"]) and not torch.is_complex(ys["x"])
    assert abs(complex(ys["z"][-1]) - np.exp(1j)) < 1e-7
    assert abs(float(ys["x"][-1]) - np.exp(-1.0)) < 1e-7
    y1 = odeint(trot, torch.tensor(Z0), torch.zeros(1, dtype=torch.float64))
    assert torch.is_complex(y1) and y1.shape == (1, 1)


def test_gradients_through_complex_solves():
    """Autograd through the bounded loop: d/da Re exp(i a) = -sin a; and
    the continuous adjoint of |z(t)|^2 on a damped rotation."""
    a = torch.tensor(2.0, dtype=torch.float64, requires_grad=True)
    yT = odeint(lambda t, y: 1j * a * y,
                torch.tensor(1.0 + 0j, dtype=torch.complex128),
                torch.linspace(0.0, 1.0, 2, dtype=torch.float64),
                rtol=1e-10, atol=1e-12, method="dopri5",
                options={"mode": "bounded"})
    yT[-1].real.backward()
    assert abs(float(a.grad) + np.sin(2.0)) < 1e-7
    z0 = torch.tensor(Z0, requires_grad=True)
    zs = odeint_adjoint(lambda t, y: (1j * W - 0.2) * y, z0,
                        torch.linspace(0.0, 1.0, 3, dtype=torch.float64),
                        rtol=1e-10, atol=1e-12)
    (zs[-1].abs() ** 2).sum().backward()
    want = 2 * Z0 * np.exp(-0.4)
    np.testing.assert_allclose(to_np(z0.grad), want, rtol=1e-7)


def test_batched_and_complex64():
    ts = torch.linspace(0.0, 1.0, 4, dtype=torch.float64)
    z0 = torch.tensor(np.stack([Z0, 2 * Z0, 3 * Z0]))
    ys = odeint(trot, z0, ts, rtol=1e-8, atol=1e-10, batched=True)
    one = odeint(trot, z0[1], ts, rtol=1e-8, atol=1e-10)
    torch.testing.assert_close(ys[:, 1], one, rtol=0, atol=1e-12)
    ys = odeint(trot, torch.tensor(Z0, dtype=torch.complex64),
                torch.linspace(0.0, 1.0, 3), rtol=1e-5, atol=1e-7)
    assert ys.dtype == torch.complex64
