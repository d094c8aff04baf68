"""Shard parallelism of the port: chain-parallel sampling, the sharded GP
solve, multi-shard SVGD, SMC and replica exchange, and the fleet runtime
(counterpart of `bayesian_ode_tpu/parallel/`)."""
from .chains import (  # noqa: F401
    gp_dopri5_solve_sharded,
    run_svgd_sharded,
    sample_chain_sharded_batched,
    sample_chains_sharded,
    svgd_step_sharded,
)
from .mesh import (  # noqa: F401
    Mesh,
    Sharded,
    make_mesh,
    make_mesh_2d,
    replicated,
    shard_leading_axis,
)
from .runtime import (  # noqa: F401
    Runtime,
    coordinator_only,
    global_mesh,
    host_local_to_global,
    init_runtime,
    process_slice,
)
from .smc import smc_sharded  # noqa: F401
from .tempering import run_parallel_tempering_sharded  # noqa: F401

__all__ = [
    "Mesh",
    "Runtime",
    "Sharded",
    "coordinator_only",
    "global_mesh",
    "gp_dopri5_solve_sharded",
    "host_local_to_global",
    "init_runtime",
    "make_mesh",
    "make_mesh_2d",
    "process_slice",
    "replicated",
    "run_parallel_tempering_sharded",
    "run_svgd_sharded",
    "sample_chain_sharded_batched",
    "sample_chains_sharded",
    "shard_leading_axis",
    "smc_sharded",
    "svgd_step_sharded",
]
