"""Shared inputs for the parity tests of the PyTorch port against the JAX
package: the same numpy arrays go to both.

The GP-ODE problem is the JAX package's fused-kernel test problem
(tests/test_pallas_ops.py::_gp_grad_setup) at the port's small test shape:
5 trajectories, a 6x6 inducing grid, T=12 output times to t=2.5, C=8
chains jittered around the gradient-matched initialization.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bayesian_ode_tpu.models import kernel_regression as jkr
from bayesian_ode_tpu.models import make_dataset
from bayesian_ode_tpu_torch.models import kernel_regression as tkr


def to_np(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def max_rel(a, b):
    """max |a - b| / max |b| (the JAX package's gate for float32 paths)."""
    a, b = to_np(a), to_np(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def gp_problem(C=8, T=12, t_max=2.5, seed=0, jitter=3e-3):
    """The GP posterior problem in both packages.  Returns a dict of numpy
    arrays (float32 solver inputs, float64 statics) and the two statics."""
    data = make_dataset(jax.random.PRNGKey(2), "vdp", N=5, T=T, t_max=t_max,
                        noise=0.05, x0_scale=1.5)
    Z = jkr.make_inducing_grid(data["Y"], M=6)
    static = jkr.make_static(Z, sf=1.0, ell=0.75)
    p0 = jkr.init_params(data["Y"], data["t"], static, noise=0.05)
    rng = np.random.RandomState(seed)
    U = (np.asarray(p0["U"], np.float32)[None]
         + jitter * rng.randn(C, 36, 2).astype(np.float32))
    KzzinvL32 = np.asarray(static.KzzinvL, np.float32)
    A = np.einsum("mk,ckd->cmd", KzzinvL32, U).astype(np.float32)
    logsn = (np.broadcast_to(np.asarray(p0["logsn"], np.float32), (C, 2))
             + 0.01 * rng.randn(C, 2).astype(np.float32))
    f32 = jnp.float32
    jstatic32 = static._replace(Z=static.Z.astype(f32),
                                KzzinvL=static.KzzinvL.astype(f32),
                                Kzzinv=static.Kzzinv.astype(f32))
    tstatic = tkr.static_from_numpy(static.Z, static.KzzinvL, static.Kzzinv,
                                    static.sf, static.ell)
    return {
        "x0": np.asarray(data["x0"], np.float32),
        "t": np.asarray(data["t"], np.float32),
        "Y": np.asarray(data["Y"], np.float32),
        "U": U, "A": A, "logsn": logsn.astype(np.float32),
        "jstatic64": static, "jstatic32": jstatic32, "tstatic": tstatic,
    }
