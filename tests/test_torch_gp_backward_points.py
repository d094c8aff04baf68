"""The fact the GP field's backward kernels rest on (K3 GP and K5 run one
thread per trajectory point, csrc/gp_field.cuh: GPPoint): with the step
mesh frozen, the reverse sweep of a chain's N points is the sum of N
one-point sweeps.  The field at point n reads only x_n and the chain's A,
so the points' adjoints never mix; they share only A and the Abar they
add to.

Held on the plain versions.  In float64, Abar of the whole sweep against
the sum of the one-point sweeps' Abar, and each point's x0 cotangent
against its one-point sweep's, to 1e-12 max-rel: the same arithmetic, with
only the sum over points reassociated.  K5's one-point sweeps slice the
trajectory ys and its cotangent g; the replay's (K3) slice each record's
rows 2n and 2n + 1 and keep its t0 and dt.  In float32, the one-point
rk4 sweeps summed against the JAX package's K5 in interpret mode, at
test_torch_gp_rk4.py's gate (1e-5 max-rel).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu.ops.gp_rk4 import gp_rk4_trajectory as jtrajectory
from bayesian_ode_tpu_torch.ops import fused_adaptive as fa
from bayesian_ode_tpu_torch.ops import gp_rk4 as tg
from bayesian_ode_tpu_torch.ops.gp_dopri5 import _pack_initial
from bayesian_ode_tpu_torch.ops.gp_field import gp_field
from torch_parity import gp_problem, max_rel, one_torch_thread  # noqa: F401

f64 = torch.float64


@pytest.fixture(scope="module")
def problem():
    return gp_problem(C=128)


def _tensors(p, points, dtype):
    s = p["tstatic"]
    return (torch.tensor(p["A"], dtype=dtype), s.Z.to(dtype),
            torch.tensor(p["x0"][:points], dtype=dtype),
            torch.diff(torch.tensor(p["t"], dtype=torch.float32)).to(dtype),
            s.sf, s.ell)


def _rk4_point_sweeps(A, Z, ys, g, dts, sf, ell):
    """(the sum of the N one-point sweeps' Abar, their x0 cotangents
    stacked (C, N, 2))."""
    Abar, lbar = zip(*(tg.gp_rk4_bwd_plain(A, Z, ys[:, :, n:n + 1],
                                           g[:, :, n:n + 1], dts, sf, ell)
                       for n in range(ys.shape[2])))
    return sum(Abar[1:], Abar[0]), torch.cat(lbar, dim=1)


@pytest.mark.parametrize("points", [5, 3])
def test_rk4_sweep_is_the_sum_of_one_point_sweeps_f64(problem, points):
    A, Z, x0, dts, sf, ell = _tensors(problem, points, f64)
    ys = tg.gp_rk4_fwd_plain(A, Z, x0, dts, sf, ell)
    g = torch.tensor(np.random.RandomState(8).randn(*ys.shape))
    Abar, lbar = tg.gp_rk4_bwd_plain(A, Z, ys, g, dts, sf, ell)
    Abar_n, lbar_n = _rk4_point_sweeps(A, Z, ys, g, dts, sf, ell)
    assert lbar.shape == lbar_n.shape == (A.shape[0], points, 2)
    assert max_rel(Abar_n, Abar) <= 1e-12
    for n in range(points):
        assert max_rel(lbar_n[:, n], lbar[:, n]) <= 1e-12, n


@pytest.mark.parametrize("method", ["dopri5", "tsit5"])
def test_replay_sweep_is_the_sum_of_one_point_sweeps_f64(problem, method):
    """The records of the plain float32 forward (the mesh is frozen, so
    any records do), replayed in float64."""
    A, Z, x0, _, sf, ell = _tensors(problem, 5, torch.float32)
    ts = torch.tensor(problem["t"])
    field, w = gp_field(sf, ell), (A, Z)
    x0b, f0, dt0 = _pack_initial(A, x0, Z, sf, ell, 1e-7, 1e-9)
    tableau = fa.TABLEAUS[method]
    _, _, nacc, _, _, rec = fa.fwd_plain(
        field.make_rhs(w), x0b, f0, dt0, ts, 1e-7, 1e-9, 0.9, 10.0, 0.2,
        100_000, "i", store_steps=128, tableau=tableau)
    w64 = (A.to(f64), Z.to(f64))
    rhs, vjp = field.make_rhs(w64), field.make_rhs_vjp(w64)
    rec = rec.to(f64)
    g = torch.tensor(np.random.RandomState(9).randn(ts.shape[0], A.shape[0],
                                                    5, 2))
    (Abar,), lbar = fa.bwd_plain(rhs, vjp, w64[:1], ts, rec, nacc, g,
                                 tableau)
    NS = 10
    Abar_n = torch.zeros_like(Abar)
    for n in range(5):
        rows = rec[:, [2 * n, 2 * n + 1, NS, NS + 1], :]
        (Ab,), lb = fa.bwd_plain(rhs, vjp, w64[:1], ts, rows, nacc,
                                 g[:, :, n:n + 1], tableau)
        Abar_n = Abar_n + Ab
        assert lb.shape == (A.shape[0], 1, 2)
        assert max_rel(lb[:, 0], lbar[:, n]) <= 1e-12, n
    assert bool(Abar.any()) and max_rel(Abar_n, Abar) <= 1e-12


def test_one_point_rk4_sweeps_match_the_jax_kernel(problem):
    """The one-point sweeps, summed, against jax.vjp of the JAX package's
    K5 (interpret mode) on the whole trajectory."""
    p = problem
    A, Z, x0, dts, sf, ell = _tensors(p, 5, torch.float32)

    def traj(A_, x0_):
        return jtrajectory(A_, x0_, jnp.asarray(p["t"]), p["jstatic32"],
                           tile=128, interpret=True)

    ys_j, vjp = jax.vjp(traj, jnp.asarray(p["A"]), jnp.asarray(p["x0"]))
    g = np.random.RandomState(10).randn(*ys_j.shape).astype(np.float32)
    Abar_j, x0bar_j = vjp(jnp.asarray(g))
    ys = tg.gp_rk4_fwd_plain(A, Z, x0, dts, sf, ell)
    Abar_n, lbar_n = _rk4_point_sweeps(A, Z, ys, torch.tensor(g), dts, sf,
                                       ell)
    assert max_rel(Abar_n, np.asarray(Abar_j)) <= 1e-5
    assert max_rel(lbar_n.sum(dim=0), np.asarray(x0bar_j)) <= 1e-5
