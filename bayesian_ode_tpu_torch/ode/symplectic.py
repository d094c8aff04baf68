"""Symplectic fixed-grid steppers for separable Hamiltonian systems.

Counterpart of `bayesian_ode_tpu/ode/symplectic.py`.  The state is a
2-tuple y = (q, p) (each component a tree) and func(t, (q, p)) ->
(dq/dt, dp/dt) must be separable: dq/dt a function of p only and dp/dt
of q only (H(q, p) = T(p) + V(q)).  The steppers evaluate the two
components at staggered points, which is consistent only under that
contract; a non-separable field degrades to first order.

- "symplectic_euler": semi-implicit Euler (kick, then drift), order 1.
- "leapfrog" / "verlet": velocity Verlet (kick-drift-kick), order 2,
  time-reversible.
- "yoshida4": Yoshida's 4th-order composition of three Verlet steps
  (Phys. Lett. A 150 (1990) 262: w1 = 1 / (2 - 2^(1/3)), w0 = 1 - 2 w1).

They keep a perturbed Hamiltonian exactly, so the energy error stays
bounded over long horizons.  Each step returns the state's increment,
so the fixed grid's Kahan-compensated carry (`compensated`) applies.
"""
from __future__ import annotations

from ..utils.pytree import tree_map
from .runge_kutta import _bcast


def _axpy(a, x, y):
    """y + a * x over matching trees, a a time-dtype scalar or (B,)."""
    return tree_map(lambda yl, xl: yl + _bcast(a, yl) * xl, y, x)


def _scale(a, x):
    return tree_map(lambda xl: _bcast(a, xl) * xl, x)


def _add(a, b):
    return tree_map(lambda x, y: x + y, a, b)


def _check_qp(y):
    if not (isinstance(y, tuple) and len(y) == 2):
        raise ValueError(
            "symplectic methods need the state to be a 2-tuple (q, p) "
            "with func(t, (q, p)) -> (dq/dt, dp/dt) separable; got state "
            f"type {type(y).__name__}")


def symplectic_euler_step(func, t, dt, y):
    """Kick p with g(q), then drift q with f(p1)."""
    _check_qp(y)
    q, p = y
    g0 = func(t, (q, p))[1]
    p1 = _axpy(dt, g0, p)
    f1 = func(t, (q, p1))[0]
    return (_scale(dt, f1), _scale(dt, g0)), 2


def verlet_step(func, t, dt, y):
    """Velocity Verlet (kick-drift-kick)."""
    _check_qp(y)
    q, p = y
    g0 = func(t, (q, p))[1]
    p_half = _axpy(dt / 2, g0, p)
    f_half = func(t + dt / 2, (q, p_half))[0]
    dq = _scale(dt, f_half)
    g1 = func(t + dt, (_add(q, dq), p_half))[1]
    return (dq, _scale(dt / 2, _add(g0, g1))), 3


_YOSHIDA_W1 = 1.0 / (2.0 - 2.0 ** (1.0 / 3.0))
_YOSHIDA_W0 = 1.0 - 2.0 * _YOSHIDA_W1


def yoshida4_step(func, t, dt, y):
    """Yoshida's symmetric composition of three Verlet steps."""
    _check_qp(y)
    q, p = y
    tt, nfe = t, 0
    dq_acc = dp_acc = None
    for w in (_YOSHIDA_W1, _YOSHIDA_W0, _YOSHIDA_W1):
        (dq, dp), n = verlet_step(func, tt, w * dt, (q, p))
        q, p = _add(q, dq), _add(p, dp)
        dq_acc = dq if dq_acc is None else _add(dq_acc, dq)
        dp_acc = dp if dp_acc is None else _add(dp_acc, dp)
        tt = tt + w * dt
        nfe += n
    return (dq_acc, dp_acc), nfe


SYMPLECTIC_STEP_FUNCS = {
    "symplectic_euler": symplectic_euler_step,
    "leapfrog": verlet_step,
    "verlet": verlet_step,
    "yoshida4": yoshida4_step,
}
