"""Parity of the port's adaptive options with the JAX package's: the
Kahan-compensated carry (its 4-ulp floor), the bounded mode's
per-interval step cap, other dense outputs by `interp`, the pinned time
direction `reverse`, on a batch of 4 Van der Pol systems (one stiffness
a system) against the JAX solver vmapped over them."""
import importlib

import numpy as np
import pytest
import torch

from bayesian_ode_tpu_torch.ode import odeint, odeint_with_stats
from torch_parity import (VDP_TS, VDP_Y0, check_counts32,  # noqa: F401
                          check_solve64, one_torch_thread, to_np, vdp_both)


@pytest.mark.parametrize("method,options", [
    ("dopri5", {"compensated": True}),
    ("tsit5", {"compensated": True, "controller": "pi"}),
    ("dopri5", {"interp": "hermite"}),
    ("tsit5", {"interp": "quartic"}),
    ("bosh3", {"compensated": True, "ulp_floor": 8.0}),
])
def test_options_match_jax_f64(method, options):
    check_solve64(*vdp_both(method, options))


def test_compensated_float32_matches_jax():
    """float32 at rtol 1e-6: the compensated carry and its 4-ulp floor."""
    opts = {"compensated": True}
    ys, st, ys_j, st_j = vdp_both("dopri5", opts, rtol=1e-6, atol=1e-8,
                                  dtype=np.float32)
    assert ys.dtype == torch.float32
    assert (np.abs(to_np(ys) - np.asarray(ys_j)).max()
            <= 1e-4 * np.abs(np.asarray(ys_j)).max())
    check_counts32(st, st_j)


@pytest.mark.parametrize("cap", [3, 7])
def test_bounded_cap_stops_each_system_short(cap):
    """max_steps_per_interval: a system that hits the cap stops short of
    the output time, whose output is its last step's dense output there
    (an extrapolation), as in the JAX bounded scan; reached_final_time
    says which systems did.  The extrapolated quartic at theta >> 1
    scales its coefficients' rounding by about theta^4, so the outputs
    are held to 1e-8 max|y| (the same steps on every system still)."""
    opts = {"mode": "bounded", "max_steps_per_interval": cap}
    ys, st, ys_j, st_j = vdp_both("dopri5", opts)
    check_solve64(ys, st, ys_j, st_j, traj_tol=1e-8)
    reached = to_np(st["reached_final_time"])
    assert not reached.all()


def test_reverse_option_pins_the_direction():
    """Decreasing times on a damped rotation (Van der Pol backward in time
    leaves its limit cycle)."""
    def field(t, y):
        return torch.stack([-0.1 * y[:, 0] + y[:, 1],
                            -y[:, 0] - 0.1 * y[:, 1]], dim=1)

    ts = torch.tensor(VDP_TS[::-1].copy())
    y0 = torch.tensor(VDP_Y0)
    a = odeint(field, y0, ts, batched=True)
    b = odeint(field, y0, ts, batched=True, method="dopri5",
               options={"reverse": True})
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("method,options,replayed", [
    ("dopri5", None, False), ("dopri5", None, True),
    ("tsit5", {"compensated": True, "controller": "pi"}, True),
    ("bosh3", {"interp": "hermite"}, True), ("dopri8", None, False)])
def test_in_place_loop_equals_the_loop(monkeypatch, method, options,
                                       replayed):
    """The "while" loop committed in place takes the eager loop's steps
    and emits its outputs, bit for bit, on a two-leaf tree: in its eager
    steps, and (`replayed`) in the body the card captures as one CUDA
    graph, run here without the graph at every step."""
    ta = importlib.import_module("bayesian_ode_tpu_torch.ode.adaptive")
    if replayed:
        cg = importlib.import_module("bayesian_ode_tpu_torch.ode.cuda_graph")
        monkeypatch.setattr(cg.GraphedStep, "__call__",
                            lambda self: self.body(False))
    mu = torch.tensor([0.5, 1.0, 2.0, 3.0])[:, None]

    def field(t, y):
        p, v = y
        return v, mu * (1 - p ** 2) * v - p

    y0 = torch.tensor(VDP_Y0)
    y0 = (y0[:, :1], y0[:, 1:])
    ts = torch.tensor(VDP_TS[:5])
    ys, st = odeint_with_stats(field, y0, ts, method=method, options=options,
                               batched=True)
    monkeypatch.setattr(ta, "graphable", lambda device: True)
    with torch.no_grad():
        ys_i, st_i = odeint_with_stats(field, y0, ts, method=method,
                                       options=options, batched=True)
    for a, b in zip(ys, ys_i):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for k in ("nfe", "n_accepted", "n_rejected", "reached_final_time"):
        assert torch.equal(st[k], st_i[k]), k
