"""Parity of the port's per-step GP dopri5 solver (`gp_dopri5_solve`, the
plain version of kernel K9 and its host loop) with the whole-solve plain
version and with the JAX package's Pallas per-step solver in interpret
mode.

Gates.  Against the whole-solve plain version: the same steps, so the
per-chain counters are equal and the trajectories agree to 5e-6 (the JAX
package's gate between its two kernels, tests/test_pallas_ops.py:88-122;
they differ only in where the quartic is evaluated).  Against the JAX
per-step solver: two float32 solves at rtol=1e-7, held as every adaptive
parity test of the port (`torch_parity.check_solve`: trajectories within
1e-4 max|y|, step counts per chain within 3 and in mean within 0.25).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu.ops.gp_dopri5 import gp_dopri5_solve as jsolve
from bayesian_ode_tpu_torch.ops import _build
from bayesian_ode_tpu_torch.ops import gp_dopri5 as tg
from torch_parity import check_solve, gp_problem, to_np


@pytest.fixture(scope="module")
def problem():
    return gp_problem(C=128)


def _args(p, C=128):
    return (torch.tensor(p["A"][:C]), torch.tensor(p["x0"]),
            torch.tensor(p["t"]), p["tstatic"])


def test_plain_per_step_solve_takes_the_whole_solves_steps(problem):
    args = _args(problem)
    before = dict(_build.launch_counts)
    ys, st = tg.gp_dopri5_solve(*args)
    assert _build.launch_counts == before          # CPU: the plain version
    ys_w, st_w = tg.gp_dopri5_solve_whole_plain(*args)
    assert ys.dtype == torch.float32 and ys.shape == (12, 128, 5, 2)
    assert st["reached_final_time"] and st_w["reached_final_time"]
    for k in ("nfe", "n_accepted", "n_rejected"):
        assert st[k].dtype == torch.int32
        torch.testing.assert_close(st[k], st_w[k], rtol=0, atol=0)
    assert float((ys - ys_w).abs().max()) <= 5e-6
    torch.testing.assert_close(ys[0], args[1].expand(128, 5, 2), rtol=0,
                               atol=0)


def test_steps_per_call_and_the_collective_budget(problem):
    args = _args(problem)
    ys, st = tg.gp_dopri5_solve_plain(*args)
    ys4, st4 = tg.gp_dopri5_solve_plain(*args, steps_per_call=4)
    torch.testing.assert_close(ys4, ys, rtol=0, atol=0)
    torch.testing.assert_close(st4["nfe"], st["nfe"], rtol=0, atol=0)
    # one runaway chain's budget halts the batch: the first chain to take
    # max_steps steps stops every chain at that interval
    _, st_b = tg.gp_dopri5_solve_plain(*args, max_steps=12)
    taken = st_b["n_accepted"] + st_b["n_rejected"]
    assert not st_b["reached_final_time"]
    assert int(taken.max()) == 12 and int(taken.min()) < 12
    with pytest.raises(ValueError, match="multiple of 128"):
        tg.gp_dopri5_solve(*_args(problem, C=100))


def test_interp_eval_of_a_step_of_zero_length():
    """Before any accepted step t1 == t0 and the quartic is its constant
    row e = x0: the dense output is x0 exactly."""
    y = torch.randn(128, 3, 2, generator=torch.Generator().manual_seed(0))
    coef = torch.randn((5,) + y.shape)
    coef[4] = y
    t = torch.zeros(128)
    state = tg.GPDopri5State(y, y, t, t.clone(), t + 0.1, coef,
                             *(torch.zeros(128, dtype=torch.int32),) * 3)
    torch.testing.assert_close(tg._interp_eval(state, torch.tensor(0.5)), y,
                               rtol=0, atol=0)


def test_per_step_solve_matches_the_jax_kernel(problem):
    """The JAX per-step solver in interpret mode on a short horizon (the
    first 6 output times)."""
    p = problem
    ts = p["t"][:6]
    ys_j, st_j = jsolve(jnp.asarray(p["A"]), jnp.asarray(p["x0"]),
                        jnp.asarray(ts), p["jstatic32"], interpret=True)
    ys, st = tg.gp_dopri5_solve(torch.tensor(p["A"]), torch.tensor(p["x0"]),
                                torch.tensor(ts), p["tstatic"])
    check_solve(ys, st, ys_j, st_j)
    assert st["reached_final_time"] == bool(st_j["reached_final_time"])
    np.testing.assert_array_equal(to_np(ys[0]), np.asarray(ys_j[0]))
