"""Config defaults and loading (counterpart of
`bayesian_ode_tpu/experiments/config.py`; grid generation is ROADMAP
queue 1 item 16).  A config file {"output": ..., "data": {...},
"configs": [{...}]} is selected by an integer id, {id}.json."""
from __future__ import annotations

import json
import os
from typing import Any, Dict

# the reference's gen_configs.py defaults (solver/model/sampler shapes)
DEFAULT_VALUES: Dict[str, Any] = {
    "M": 6,
    "sf": 1.0,
    "ell": 0.75,
    "burn_in": 3000,
    "num_samples": 5000,
    "thinning": 50,
    "chain_start": 0,
    "num_iters": 1000,
    "num_chains": 64,
    "lr": 1e-3,
    "lr_decay": 0.03,
    "mom": 0.98,
    "rmsprop_alpha": 0.99,
    "adadelta_rho": 0.9,
    "lr0": 5e-3,
    "lr_gamma": 0.51,
    "lr_t0": 100,
    "lr_alpha": 0.1,
    "psgld_alpha": 0.99,
    "lambda_": 1e-8,
    "noise": 0.1,
}


def load_config(json_dir: str, run_id: int) -> Dict:
    with open(os.path.join(json_dir, f"{run_id}.json")) as f:
        return json.load(f)
