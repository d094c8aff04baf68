"""Parity of the generic engine's batch potential with the JAX driver's
per-chain potential for the spiral y^3-net (H=8) and the FitzHugh-Nagumo
theta model, at dopri5, tsit5 and rk4 (the GP and MLP models are in
`test_torch_generic_potential.py`): `torch_parity.check_generic_potential`,
4 chains with different parameters, float64 on the CPU.
"""
import pytest

from torch_parity import (  # noqa: F401
    check_generic_potential,
    generic_data,
    one_torch_thread,
)


@pytest.fixture(scope="module")
def data():
    return generic_data()


@pytest.mark.parametrize("model,solver", [
    ("spiral", "dopri5"), ("spiral", "tsit5"), ("spiral", "rk4"),
    ("fhn", "dopri5"), ("fhn", "tsit5"),
])
def test_batch_potential_matches_jax_per_chain(data, model, solver):
    check_generic_potential(data, model, solver)
