"""Parity of the port's per-step GP dopri5 solver (`gp_dopri5_solve`, the
plain version of kernel K9 and its host loop) with the whole-solve plain
version, with the lockstep loop of one masked step a call that the JAX
package runs (kept here as the reference) and with the JAX package's
Pallas per-step solver in interpret mode.

The port launches K9 once per output interval with a cap of iterations,
the step budget left rounded up to steps_per_call, and again where a
chain was left short with budget left; the reference checks the budget
before every call of steps_per_call masked steps.  The two stop at the
same iteration, so their trajectories and counters are equal bit for bit
at every budget, also where the budget binds mid-interval on a chain that
did not have the most steps before it.

Gates.  Against the whole-solve plain version: the same steps, so the
per-chain counters are equal and the trajectories agree to 5e-6 (the JAX
package's gate between its two kernels, tests/test_pallas_ops.py:88-122;
they differ only in where the quartic is evaluated).  Against the JAX
per-step solver: two float32 solves at rtol=1e-7, held as every adaptive
parity test of the port (`torch_parity.check_solve`: trajectories within
1e-4 max|y|, step counts per chain within 3 and in mean within 0.25).

The file runs torch on one intra-op thread (`one_thread`): its solves
are thousands of small tensor operations, each of which 8 threads only
slow down (17x under a loaded test run, where each worker process's
threads compete for the same cores), and both sides of every bit-equal
comparison then run under one setting.
"""
from bisect import bisect_right

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu.ops.gp_dopri5 import gp_dopri5_solve as jsolve
from bayesian_ode_tpu_torch.ops import _build
from bayesian_ode_tpu_torch.ops import gp_dopri5 as tg
from torch_parity import check_solve, gp_problem, to_np


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def problem():
    return gp_problem(C=128)


@pytest.fixture(scope="module")
def mixed():
    """The problem with each chain's A scaled by a factor from 0.5 to 3:
    chains of different speeds, which take 10 to 52 steps to t = 2.5, so
    that a collective budget binds on some chains while others have
    finished their interval."""
    p = dict(gp_problem(C=128))
    scale = np.linspace(0.5, 3.0, 128).astype(np.float32)
    scale = scale[np.random.RandomState(0).permutation(128)]
    p["A"] = (p["A"] * scale[:, None, None]).astype(np.float32)
    return p


def _args(p, C=128):
    return (torch.tensor(p["A"][:C]), torch.tensor(p["x0"]),
            torch.tensor(p["t"]), p["tstatic"])


def _lockstep_calls(state, ts, k, rhs, steps):
    """The reference's one call: `steps` masked steps of every chain with
    t1 < ts[k].  Returns (state, pending, taken): the least first output
    index m with ts[m] > t1 over the chains, and the most steps any chain
    has taken."""
    y, f, t0, t1, dt, coef, nfe, nacc, nrej = state
    next_t = ts[k]
    for _ in range(steps):
        active = t1 < next_t
        kk, y1 = tg._rk_stages(rhs, y, f, dt)
        accept, _, dt_next, _ = tg._step_decision(kk, y, y1, dt, 1e-7, 1e-9,
                                                  0.9, 10.0, 0.2)
        ym = tg._midpoint(y, kk, dt)
        cf = torch.stack(tg._quartic_coeffs(y, y1, ym, f, kk[6], tg._bc(dt)))
        take = active & accept
        sel = tg._bc(take)
        coef = torch.where(sel, cf, coef)
        y = torch.where(sel, y1, y)
        f = torch.where(sel, kk[6], f)
        t0 = torch.where(take, t1, t0)
        t1 = torch.where(take, t1 + dt, t1)
        dt = torch.where(active, dt_next, dt)
        nfe = nfe + 6 * active.int()
        nacc = nacc + take.int()
        nrej = nrej + (active & ~accept).int()
    pending = int(torch.searchsorted(ts, t1, right=True).min())
    state = tg.GPDopri5State(y, f, t0, t1, dt, coef, nfe, nacc, nrej)
    return state, pending, int((nacc + nrej).max())


def _lockstep_solve(p, max_steps, steps_per_call):
    """The JAX package's loop: per output interval, calls of
    steps_per_call masked steps while a chain is short of ts[k] and no
    chain has taken max_steps steps, then the dense output at ts[k].
    Returns (ys, stats, overtaken): overtaken says whether the budget
    bound on an interval where a chain that reached it had fewer steps at
    the interval's start than the most any chain had."""
    A, x0, ts, static = _args(p)
    w = (A, static.Z.to(torch.float32))
    rhs = tg._make_rhs(*w, float(static.sf), float(static.ell))
    state = tg._step_init(w, x0, ts, static, 1e-7, 1e-9)
    times = ts.tolist()
    pending = bisect_right(times, times[0])
    taken, overtaken = 0, False
    ys = [state.y.clone()]
    for k in range(1, len(times)):
        before = state.nacc + state.nrej
        while pending <= k and taken < max_steps:
            state, pending, taken = _lockstep_calls(state, ts, k, rhs,
                                                    steps_per_call)
        if pending <= k and taken >= max_steps:
            now = state.nacc + state.nrej
            overtaken |= bool((before[now >= max_steps]
                               < before.max()).any())
        ys.append(tg._interp_eval(state, ts[k]))
    stats = {"nfe": state.nfe, "n_accepted": state.nacc,
             "n_rejected": state.nrej}
    return torch.stack(ys), stats, overtaken


def _relaunched(p, max_steps, steps_per_call):
    """Whether the solve's first pass (every interval once, capped by the
    budget left) left a chain short of an output time with budget left,
    so that the solve ran again launch by launch."""
    A, x0, ts, static = _args(p)
    w = (A, static.Z.to(torch.float32))
    rhs = tg._make_rhs(*w, float(static.sf), float(static.ell))
    state, ys = tg._initial(w, x0, ts, static, 1e-7, 1e-9)()
    _, flags = tg._intervals_plain(state, ys, ts, max_steps, steps_per_call,
                                   rhs, 1e-7, 1e-9, 0.9, 10.0, 0.2)
    return any(short and taken < max_steps for short, taken in flags[1:])


_FACTS = {}


@pytest.mark.parametrize("steps_per_call", [1, 3])
@pytest.mark.parametrize("max_steps", range(1, 41))
def test_capped_intervals_equal_the_lockstep_loop(mixed, max_steps,
                                                  steps_per_call):
    """The port's solve (every interval once, each capped by the budget
    left after the one before, and again launch by launch where that left
    a chain short with budget left) against the reference's calls of
    steps_per_call masked steps, bit for bit."""
    ys_r, st_r, overtaken = _lockstep_solve(mixed, max_steps,
                                            steps_per_call)
    _FACTS[max_steps, steps_per_call] = (
        overtaken, _relaunched(mixed, max_steps, steps_per_call))
    ys, st = tg.gp_dopri5_solve_plain(*_args(mixed), max_steps=max_steps,
                                      steps_per_call=steps_per_call)
    assert torch.equal(ys, ys_r)
    for k in ("nfe", "n_accepted", "n_rejected"):
        assert torch.equal(st[k], st_r[k]), k
    taken = st["n_accepted"] + st["n_rejected"]
    assert int(taken.max()) < max_steps + steps_per_call


def test_the_sweep_binds_the_budget_on_an_overtaking_chain(mixed):
    """The sweep above covers a budget that binds mid-interval on a chain
    that did not have the most steps at the interval's start, and a first
    pass that left a chain short with budget left (the solve ran again
    launch by launch)."""
    for max_steps in range(1, 41):
        for spc in (1, 3):
            if (max_steps, spc) not in _FACTS:
                _FACTS[max_steps, spc] = (
                    _lockstep_solve(mixed, max_steps, spc)[2],
                    _relaunched(mixed, max_steps, spc))
    assert any(o for o, _ in _FACTS.values())
    assert any(r for _, r in _FACTS.values())


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
    first 6 output times), and on all 12 with a budget that binds
    (max_steps=12).  There the batch stops short, and the later output
    times extrapolate each chain's last step far past it: two float32
    solves a step apart on some chains then differ by the extrapolation.
    So both stop at the same output interval (the first that differs from
    the port's solve without a budget), and the trajectories before it and
    the step counts are held as check_solve holds them: the trajectories
    up to the interval where the budget bound (the first where the port's
    solve differs from its solve without a budget), which JAX reaches
    too."""
    p = problem
    A, x0 = torch.tensor(p["A"]), torch.tensor(p["x0"])
    for times, max_steps in ((6, 100_000), (12, 12)):
        ts = p["t"][:times]
        ys_j, st_j = jsolve(jnp.asarray(p["A"]), jnp.asarray(p["x0"]),
                            jnp.asarray(ts), p["jstatic32"],
                            max_steps=max_steps, interpret=True)
        ys, st = tg.gp_dopri5_solve(A, x0, torch.tensor(ts), p["tstatic"],
                                    max_steps=max_steps)
        ys_full, _ = tg.gp_dopri5_solve(A, x0, torch.tensor(ts),
                                        p["tstatic"])
        ys_j = np.asarray(ys_j)
        stop = [k for k in range(times) if not torch.equal(ys[k],
                                                           ys_full[k])]
        assert bool(stop) == (max_steps <= 12)
        kept = stop[0] if stop else times
        assert kept >= 4
        check_solve(ys[:kept], st, ys_j[:kept], st_j)
        assert st["reached_final_time"] == bool(st_j["reached_final_time"])
        assert st["reached_final_time"] == (max_steps > 12)
        np.testing.assert_array_equal(to_np(ys[0]), ys_j[0])
