"""ODE vector fields and data of the PyTorch port."""
from . import kernel_regression  # noqa: F401
from .data import make_dataset  # noqa: F401
from .dynamics import DYNAMICS, fhn, lv, vdp  # noqa: F401

__all__ = ["DYNAMICS", "fhn", "kernel_regression", "lv", "make_dataset",
           "vdp"]
