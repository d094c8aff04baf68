"""Bouncing ball through `odeint_event`: learn a coefficient of restitution.

A ball falls under gravity, `odeint_event` locates each ground contact,
and the velocity is reflected with a restitution coefficient e.  The
example then recovers e by gradient descent (Adam) on the observed apex
heights: the gradients flow through every event time by the implicit
function theorem (`ode/events.py`).  After upstream torchdiffeq's
bouncing-ball event demo.

  python -m bayesian_ode_tpu_torch.examples.bouncing_ball [--bounces 4] \
      [--iters 150] [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from .. import odeint_event
from . import add_device, device_arg

G = 9.8


def dyn(t, s):
    # s = [height, velocity]
    return torch.stack([s[1], torch.full_like(s[1], -G)])


def ground(t, s):
    return s[0]


def simulate(e, h0: float, n_bounces: int, device=None):
    """Drop from rest at h0; return (event_times, apex_heights) of the
    n_bounces flight arcs after each contact, differentiable in e."""
    e = torch.as_tensor(e, dtype=torch.float64, device=device)
    t0 = torch.zeros((), dtype=torch.float64, device=device)
    s0 = torch.tensor([h0, 0.0], dtype=torch.float64, device=device)
    ets, apexes = [], []
    for _ in range(n_bounces):
        # strictly above the ground until contact, so g turns + to -
        et, ys = odeint_event(
            dyn, s0, t0, event_fn=ground, rtol=1e-8, atol=1e-10,
            options={"mode": "bounded", "max_steps_per_interval": 64})
        v_impact = ys[-1, 1]
        s0 = torch.stack([torch.zeros_like(v_impact) + 1e-9,
                          -e * v_impact])
        t0 = et
        ets.append(et)
        apexes.append((e * v_impact) ** 2 / (2 * G))
    return torch.stack(ets), torch.stack(apexes)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--e-true", type=float, default=0.73)
    add_device(ap)
    args = ap.parse_args(argv)
    device = device_arg(ap, args)

    h0 = 10.0
    with torch.no_grad():
        ets_obs, apex_obs = simulate(args.e_true, h0, args.bounces, device)
    print("observed contact times:", [f"{t:.4f}" for t in ets_obs.tolist()])
    print("observed apex heights :", [f"{a:.4f}" for a in apex_obs.tolist()])

    log_e = torch.zeros((), dtype=torch.float64, device=device,
                        requires_grad=True)         # e0 = 0.5
    opt = torch.optim.Adam([log_e], lr=args.lr)
    losses = []
    for it in range(args.iters):
        opt.zero_grad()
        _, apex = simulate(torch.sigmoid(log_e), h0, args.bounces, device)
        loss = ((apex - apex_obs) ** 2).sum()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if it % 25 == 0 or it == args.iters - 1:
            print(f"iter {it:4d}  loss {losses[-1]:.3e}  "
                  f"e {float(torch.sigmoid(log_e.detach())):.5f}")

    e_hat = float(torch.sigmoid(log_e.detach()))
    print(f"recovered e = {e_hat:.5f} (true {args.e_true})")
    if not abs(e_hat - args.e_true) < 1e-3:
        raise RuntimeError(f"restitution not recovered: {e_hat:.5f} vs "
                           f"{args.e_true}")
    return {"losses": losses, "e": e_hat}


if __name__ == "__main__":
    main()
