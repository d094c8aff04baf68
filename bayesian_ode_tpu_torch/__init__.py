"""bayesian_ode_tpu_torch: the PyTorch/CUDA port of bayesian_ode_tpu.

The JAX package `bayesian_ode_tpu` stays the reference; this package
mirrors its module tree (`bayesian_ode_tpu/ops/gp_dopri5.py` has its
counterpart at `bayesian_ode_tpu_torch/ops/gp_dopri5.py`) and is held to
it by the `tests/test_torch_*.py` parity tests.  The TPU kernels become
CUDA C++ kernels for Hopper (`csrc/`), each beside a plain PyTorch version
that CPU tensors take.

Ported so far: the Van der Pol GP-ODE posterior sampled with a whole
adaptive dopri5 solve and its gradient per step (engine="fused",
solver="dopri5", model="gp"), the same posterior and the MLP field with a
fixed-grid rk4 solve and its gradient (solver="rk4", model="gp" or "nn"),
the MLP, spiral and FitzHugh-Nagumo fields at dopri5 on the fused engine,
and the generic engine (engine="generic": every model at any solver of
`SOLVERS` over the batched continuous adjoint `odeint_adjoint`), under
SGLD, pSGLD, aSGLD, cSGLD, MALA, AdamSGLD, the SG-HMC family (aSGHMC,
acSGHMC, SGRHMC, BAOAB), HAMCMC (generic engine), HMC, NUTS, PT,
Ensemble, SMC and SVGD, all through `experiments.vanderpol_gp.run_sampler`;
the MAP fit (`run_optim`), ADVI and Laplace (`run_vi`) and the evidence
estimators (`run_evidence`).  The ODE core has every solver of the JAX
package's registry (`SOLVERS`: the explicit pairs, the implicit sdirk4
and trbdf2, the variable-order adams, the fixed-grid, symplectic and
fixed Adams methods), complex states, the adaptive options, dense output
(`odeint_dense`) and events (`odeint_event`).  The SDE stack (`sde`:
`sdeint`, the reversible-Heun adjoint `sdeint_adjoint`, the
Euler-Maruyama and NPSDE potentials), the latent-ODE, latent-SDE and CNF
models, the toy densities and experiment (`experiments.toy`), and the
driver's plots and config helpers are ported too, and so are the conv
ODEnet (`models.odenet`), the examples (`examples`, each run with
`python -m`), the sharded paths and the fleet runtime (`parallel`) and
the CLI's `--id all` and `--data-pickle`.  ROADMAP.md lists what is still
to port.
"""
from . import sde  # noqa: F401
from .ode import (  # noqa: F401
    SOLVERS,
    DenseSolution,
    odeint,
    odeint_adjoint,
    odeint_dense,
    odeint_event,
    odeint_event_with_stats,
    odeint_forward_sensitivity,
    odeint_with_stats,
)
from .sde import sdeint, sdeint_adjoint  # noqa: F401

__version__ = "0.1.0"
