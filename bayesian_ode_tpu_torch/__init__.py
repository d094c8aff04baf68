"""bayesian_ode_tpu_torch: the PyTorch/CUDA port of bayesian_ode_tpu.

The JAX package `bayesian_ode_tpu` stays the reference; this package
mirrors its module tree (`bayesian_ode_tpu/ops/gp_dopri5.py` has its
counterpart at `bayesian_ode_tpu_torch/ops/gp_dopri5.py`) and is held to
it by the `tests/test_torch_*.py` parity tests.  The TPU kernels become
CUDA C++ kernels for Hopper (`csrc/`), each beside a plain PyTorch version
that CPU tensors take.

Ported so far: the main-path slice, the Van der Pol GP-ODE posterior
sampled by SGLD/pSGLD with a whole adaptive dopri5 solve and its gradient
per step (`experiments.vanderpol_gp.run_sampler` with engine="fused",
solver="dopri5", model="gp").  ROADMAP.md lists what is still to port.
"""
from .ode import odeint, odeint_with_stats  # noqa: F401

__version__ = "0.1.0"
