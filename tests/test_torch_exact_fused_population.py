"""Ensemble (GP rk4: forward only, K4) through the port's driver on the
fused engine against the JAX driver's, in float32 on the CPU (see
`exact_fused.py` for the set-up and the gates)."""
import pytest

from exact_fused import check_fused_method
from torch_parity import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("method,solver", [("Ensemble", "rk4")])
def test_fused_driver_matches_the_jax_fused_driver(method, solver, tmp_path,
                                                   monkeypatch):
    check_fused_method(method, solver, tmp_path, monkeypatch)
