"""Running-average meters (counterpart of
`bayesian_ode_tpu/utils/meters.py`: the reference's RunningAverageMeter,
neuralode_examples/ode_demo.py:131-147 / latent_ode.py:162-177)."""
from __future__ import annotations


class RunningAverageMeter:
    """Exponential moving average of a scalar stream."""

    def __init__(self, momentum: float = 0.99):
        self.momentum = momentum
        self.reset()

    def reset(self):
        self.val = None
        self.avg = 0.0

    def update(self, val: float):
        if self.val is None:
            self.avg = val
        else:
            self.avg = self.avg * self.momentum + val * (1 - self.momentum)
        self.val = val
