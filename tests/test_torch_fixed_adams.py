"""Parity of the port's fixed-grid Adams methods (explicit_adams,
fixed_adams) with the JAX package's `integrate_abm`, in float64 on the
CPU: a batch of Van der Pol systems (mu 0.2 to 1.5) in the port against
the JAX solve vmapped over them.  Each system keeps its own history and
order, and on the grid below the corrector fails to converge on the
stiffest system only: corrector_fails, nfe and the trajectories per
system (to 1e-10 max|y|).  The explicit method runs at orders up to 6:
Adams-Bashforth at order 12 diverges on these grids in both packages."""
import numpy as np
import pytest

from torch_parity import one_torch_thread, to_np, vdp_both  # noqa: F401


def _check(ys, st, ys_j, st_j):
    ys, ys_j = to_np(ys), np.asarray(ys_j)
    assert np.abs(ys - ys_j).max() <= 1e-10 * np.abs(ys_j).max()
    for k in ("nfe", "n_accepted", "n_rejected"):
        np.testing.assert_array_equal(to_np(st[k]), np.asarray(st_j[k]),
                                      err_msg=k)
    if "corrector_fails" in st_j:
        np.testing.assert_array_equal(to_np(st["corrector_fails"]),
                                      np.asarray(st_j["corrector_fails"]))


MU = np.array([0.2, 0.5, 1.0, 1.5])
TS = np.linspace(0.0, 2.0, 101)


@pytest.mark.parametrize("method,options", [
    ("explicit_adams", {"max_order": 4}),
    ("explicit_adams", {"max_order": 6, "step_size": 0.015}),
    ("fixed_adams", None),
    ("fixed_adams", {"max_order": 4}),
    ("fixed_adams", {"step_size": 0.015}),
    ("fixed_adams", {"max_iters": 2, "max_order": 6}),
])
def test_batched_grids_match_jax(method, options):
    ys, st, ys_j, st_j = vdp_both(method, options, ts=TS, mu=MU)
    _check(ys, st, ys_j, st_j)


def test_corrector_failures_differ_between_systems():
    """The stiffest system's corrector fails to converge in 4 iterations
    and its history drops its oldest entries; the others' do not."""
    ys, st, ys_j, st_j = vdp_both("fixed_adams", None, ts=TS, mu=MU)
    _check(ys, st, ys_j, st_j)
    fails = to_np(st["corrector_fails"])
    assert fails[0] == 0 and fails[-1] > 0
