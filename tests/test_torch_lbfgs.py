"""The port's L-BFGS (`bayesian_ode_tpu_torch.optim`) against the JAX
package's, in float64 on the CPU: the minFunc interpolation steps, the
two-loop recursion, curvature rejection and Powell damping, the line
searches' convergence, the inf cliff, and whole `lbfgs_minimize` value
traces.

Gates.  The interpolation steps and one two-loop product to 1e-12
relative: the same scalar formulas, separated only by rounding.  Value
traces to 1e-8 max-rel: the line searches branch on comparisons of
values, and on Rosenbrock the two packages' rounding (their dot
products sum in different orders) grows by about 10x every few
iterations, so the Rosenbrock traces are compared over the first 20
iterations (measured 5e-12 there) and run to convergence on their own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu import optim as joptim
from bayesian_ode_tpu_torch import optim as toptim
from torch_parity import one_torch_thread  # noqa: F401

F64 = torch.float64


def _t(*xs):
    return [torch.tensor(x, dtype=F64) for x in xs]


def _j(*xs):
    return [jnp.float64(x) for x in xs]


QUAD_CASES = [(0.0, 1.0, -2.0, 1.0, 0.8), (0.0, 5.0, -0.3, 2.0, 4.9),
              (0.2, 1.0, -2.0, 1.0, 0.8), (0.0, 1.0, -2.0, 0.5, 3.0),
              (1.0, 2.0, -1.0, 3.0, 2.5), (0.0, 1.0, -2.0, 1.0, 4.0),
              (0.5, 1.0, -2.0, 0.5, 0.8),        # dx = 0: bisection
              (0.0, 1.0, 2.0, 1.0, 1.0)]         # concave: clamped
CUBIC_CASES = [(0.0, 1.0, -2.0, 1.0, 0.8, 1.5),
               (0.0, 3.0, -1.0, 2.0, 2.0, 0.5),
               (0.5, 1.0, -0.7, 1.5, 0.9, 0.9),
               (0.0, 1.0, -2.0, 1.0, 1.5, 4.0),
               (0.0, 1.0, 1.0, 1.0, 5.0 / 3.0, 1.0),   # negative discriminant
               (1.0, 1.0, -1.0, 1.0, 1.0, 1.0)]        # dx = 0
CUBIC3_CASES = [(0.0, 1.0, -2.0, 1.0, 0.8, 2.0, 1.5),
                (0.0, 2.0, -0.5, 0.6, 1.9, 1.2, 2.4),
                (0.0, 1.0, -1.0, 0.3, 0.95, 0.9, 1.3),
                (0.0, 4.0, -3.0, 0.8, 3.1, 1.6, 5.0),
                (0.0, 1.0, -1.0, 0.5, 0.6, 0.5, 0.6),  # singular: bisection
                (0.0, 1.0, -1.0, 0.4, float("inf"), 0.8, 2.0)]


@pytest.mark.parametrize("case", QUAD_CASES)
def test_quad_min_matches_jax(case):
    lo, hi = min(case[0], case[3]), max(case[0], case[3]) + 0.5
    got = toptim.quad_min(*_t(*case, lo, hi))
    want = joptim.quad_min(*_j(*case, lo, hi))
    assert got.dtype == F64 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)


@pytest.mark.parametrize("case", CUBIC_CASES)
def test_cubic_min_matches_jax(case):
    lo, hi = min(case[0], case[3]), max(case[0], case[3]) + 0.25
    got = toptim.cubic_min(*_t(*case, lo, hi))
    want = joptim.cubic_min(*_j(*case, lo, hi))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)


@pytest.mark.parametrize("case", CUBIC3_CASES)
def test_cubic_min_3pt_matches_jax(case):
    lo, hi = 0.0, max(case[3], case[5])
    got = toptim.cubic_min_3pt(*_t(*case, lo, hi))
    want = joptim.cubic_min_3pt(*_j(*case, lo, hi))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)


def quadratic_problem(P=8, seed=0):
    rng = np.random.RandomState(seed)
    A = rng.randn(P, P)
    A = A @ A.T + P * np.eye(P)
    b = rng.randn(P)
    At, bt = torch.tensor(A), torch.tensor(b)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    return (lambda x: 0.5 * x @ At @ x - bt @ x,
            lambda x: 0.5 * x @ Aj @ x - bj @ x, A, b)


def rosen_t(x):
    return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def rosen_j(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def _vg(fn):
    def vg(v):
        with torch.enable_grad():
            v = v.detach().requires_grad_(True)
            F = fn(v)
            (g,) = torch.autograd.grad(F, v)
        return F.detach(), g
    return vg


def _filled_state(P=6, m=4, seed=0, valid=None):
    """A state whose history holds m exact-curvature pairs (y = A s)."""
    rng = np.random.RandomState(seed)
    fn, _, A, _ = quadratic_problem(P)
    state, _ = toptim.lbfgs_init(_vg(fn), torch.tensor(rng.randn(P)),
                                 history_size=m)
    s = rng.randn(m, P)
    y = s @ A.T
    valid = np.ones(m, bool) if valid is None else np.asarray(valid)
    h0 = (s[-1] @ y[-1]) / (y[-1] @ y[-1])
    state = state._replace(s_buf=torch.tensor(s), y_buf=torch.tensor(y),
                           valid=torch.tensor(valid),
                           h_diag=torch.tensor(h0))
    return state, s, y, valid, h0, rng.randn(P)


def test_two_loop_matches_dense_inverse_hessian():
    state, s, y, _, h0, v = _filled_state()
    Hv = toptim.two_loop_recursion(state, torch.tensor(v))
    Hd = h0 * np.eye(len(v))
    for si, yi in zip(s, y):
        rho = 1.0 / (si @ yi)
        E = np.eye(len(v)) - rho * np.outer(si, yi)
        Hd = E @ Hd @ E.T + rho * np.outer(si, si)
    np.testing.assert_allclose(Hv.numpy(), Hd @ v, rtol=1e-9)


@pytest.mark.parametrize("valid", [[True] * 4, [False, True, False, True],
                                   [False] * 4])
def test_two_loop_matches_jax(valid):
    state, s, y, valid, h0, v = _filled_state(valid=valid)
    jstate = joptim.LBFGSState(
        position=jnp.zeros(6), value=jnp.asarray(0.0), grad=jnp.zeros(6),
        s_buf=jnp.asarray(s), y_buf=jnp.asarray(y), valid=jnp.asarray(valid),
        h_diag=jnp.asarray(h0), prev_grad=jnp.zeros(6),
        t=jnp.asarray(1.0), d=jnp.zeros(6), fail=jnp.asarray(False),
        n_iter=jnp.asarray(0), curv_skips=jnp.asarray(0),
        fail_skips=jnp.asarray(0))
    want = np.asarray(joptim.two_loop_recursion(jstate, jnp.asarray(v)))
    got = toptim.two_loop_recursion(state, torch.tensor(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("damping", [False, True])
@pytest.mark.parametrize("shift", [-0.1, 0.5])
def test_curvature_rejection_and_damping_match_jax(damping, shift):
    """s = d t = ones, Bs = -t prev_grad = ones; y = grad - prev_grad =
    shift: -0.1 fails the curvature test (rejected, or damped to
    y's = eps s'Bs), 0.5 passes it."""
    fn_t, fn_j, _, _ = quadratic_problem()
    state, _ = toptim.lbfgs_init(_vg(fn_t), torch.zeros(8, dtype=F64),
                                 history_size=3)
    jstate, _ = joptim.lbfgs_init(jax.value_and_grad(fn_j), jnp.zeros(8),
                                  history_size=3)
    prev = -np.ones(8)
    state = state._replace(n_iter=1, d=torch.ones(8, dtype=F64),
                           t=torch.tensor(1.0, dtype=F64),
                           prev_grad=torch.tensor(prev))
    jstate = jstate._replace(n_iter=jnp.asarray(1, jnp.int32),
                             d=jnp.ones(8), t=jnp.asarray(1.0),
                             prev_grad=jnp.asarray(prev))
    got = toptim.curvature_update(state, torch.tensor(prev + shift),
                                  eps=1e-2, damping=damping)
    want = joptim.curvature_update(jstate, jnp.asarray(prev + shift),
                                   eps=1e-2, damping=damping)
    assert got.curv_skips == int(want.curv_skips)
    assert got.valid.tolist() == np.asarray(want.valid).tolist()
    for k in ("s_buf", "y_buf", "h_diag"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-12)
    rejected = shift < 0 and not damping
    assert got.curv_skips == int(rejected)
    assert bool(got.valid[-1]) == (not rejected)
    if damping and shift < 0:
        # the damped pair satisfies y's = eps s'Bs
        np.testing.assert_allclose(float(got.s_buf[-1] @ got.y_buf[-1]),
                                   1e-2 * 8.0, rtol=1e-9)
    # no update on the first iteration, nor after a failed search
    for skip in (state._replace(n_iter=0), state._replace(fail=True)):
        out = toptim.curvature_update(skip, torch.tensor(prev + shift))
        assert not bool(out.valid.any())
    assert toptim.curvature_update(state._replace(fail=True),
                                   torch.tensor(prev)).fail_skips == 1


@pytest.mark.parametrize("line_search", ["none", "armijo", "wolfe"])
def test_quadratic_convergence_and_trace_match_jax(line_search):
    fn_t, fn_j, A, b = quadratic_problem()
    lr = 0.1 if line_search == "none" else 1.0
    iters = 400 if line_search == "none" else 60
    x, value, trace, state = toptim.lbfgs_minimize(
        fn_t, torch.zeros(8, dtype=F64), max_iters=iters,
        line_search=line_search, lr=lr)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(A, b), atol=1e-4)
    assert trace.shape == (iters,) and state.n_iter == iters
    _, jvalue, jtrace, _ = joptim.lbfgs_minimize(
        fn_j, jnp.zeros(8), max_iters=iters, line_search=line_search, lr=lr)
    jtrace = np.asarray(jtrace)
    assert (np.max(np.abs(trace.numpy() - jtrace)) / np.max(np.abs(jtrace))
            <= 1e-8)


@pytest.mark.parametrize("line_search", ["armijo", "wolfe"])
def test_rosenbrock_convergence(line_search):
    x, value, trace, _ = toptim.lbfgs_minimize(
        rosen_t, torch.zeros(6, dtype=F64), max_iters=200,
        line_search=line_search, history_size=10)
    assert float(value) < 1e-8, float(value)
    np.testing.assert_allclose(x.numpy(), np.ones(6), atol=1e-3)


@pytest.mark.parametrize("kw", [
    dict(line_search="armijo"), dict(line_search="wolfe"),
    dict(line_search="armijo", interpolate=False),
    dict(line_search="wolfe", interpolate=False),
    dict(line_search="wolfe", damping=True, history_size=4)])
def test_rosenbrock_trace_matches_jax(kw):
    kw = dict(kw)
    n = 20
    _, _, trace, state = toptim.lbfgs_minimize(
        rosen_t, torch.zeros(6, dtype=F64), max_iters=n, **kw)
    _, _, jtrace, jstate = joptim.lbfgs_minimize(
        rosen_j, jnp.zeros(6), max_iters=n, **kw)
    jtrace = np.asarray(jtrace)
    assert np.max(np.abs(trace.numpy() - jtrace) / np.abs(jtrace)) <= 1e-8
    assert state.curv_skips == int(jstate.curv_skips)
    assert state.fail_skips == int(jstate.fail_skips)


def test_interpolation_reduces_rosenbrock_work():
    """The polyinterp line searches reach the optimum in fewer iterations
    than the pure eta-division / bisection searches (the JAX package's
    gate for its interpolation ladder)."""
    first = {}
    for interpolate in (False, True):
        _, _, trace, _ = toptim.lbfgs_minimize(
            rosen_t, torch.zeros(6, dtype=F64), max_iters=200,
            line_search="wolfe", history_size=10, interpolate=interpolate)
        below = trace.numpy() < 1e-8
        assert below.any()
        first[interpolate] = int(np.argmax(below))
    assert first[True] < first[False], first


def _cliff_t(p):
    x = p["x"]
    quad = torch.sum((x - 1.0) ** 2)
    return torch.where(x.abs().max() > 1.6, torch.inf, quad)


def _cliff_j(p):
    x = p["x"]
    quad = jnp.sum((x - 1.0) ** 2)
    return jnp.where(jnp.max(jnp.abs(x)) > 1.6, jnp.inf, quad)


def test_lbfgs_survives_inf_cliff():
    """A trial step into a non-finite region is rejected, not taken into
    the state: the values never rise (a rejected move holds the value),
    the optimum is reached, and the trace is JAX's."""
    pos, val, trace, state = toptim.lbfgs_minimize(
        _cliff_t, {"x": torch.tensor([-1.4, -1.5], dtype=F64)}, max_iters=60)
    trace = trace.numpy()
    assert np.isfinite(trace).all()
    assert np.all(np.diff(trace) <= 1e-12)
    assert float(val) < 1e-6
    np.testing.assert_allclose(pos["x"].numpy(), [1.0, 1.0], atol=1e-3)
    _, _, jtrace, _ = joptim.lbfgs_minimize(
        _cliff_j, {"x": jnp.asarray([-1.4, -1.5])}, max_iters=60)
    # both land on the minimum exactly (the quadratic interpolation of an
    # exact quadratic), so the traces are compared entry by entry
    np.testing.assert_allclose(trace, np.asarray(jtrace), rtol=1e-8, atol=0)


def test_unknown_line_search_raises():
    fn_t, _, _, _ = quadratic_problem()
    with pytest.raises(ValueError, match="line_search"):
        toptim.lbfgs_minimize(fn_t, torch.zeros(8, dtype=F64), max_iters=1,
                              line_search="strong")
