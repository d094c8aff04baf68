"""Config schema and hyperparameter-grid generation (counterpart of
`bayesian_ode_tpu/experiments/config.py`).

JSON config files {"output": ..., "data": {...}, "configs": [{...}]} are
selected by an integer id (the reference's SLURM array id); `expand_grid`
expands a per-method hyperparameter product into one config per
combination and `write_configs` writes one file each
(scripts/vanderpol/gen_configs.py), with run-dir names encoding the
hyperparameters through short names (gen_configs.py:32-51).
"""
from __future__ import annotations

import itertools
import json
import os
from typing import Any, Dict, Iterable, List, Optional

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

# short names for run-dir encoding (gen_configs.py:32-51), with the
# engine and solver routing the drivers read
SENSIBLE_PARAMS: Dict[str, str] = {
    "M": "M",
    "ell": "ell",
    "num_iters": "nitr",
    "num_chains": "nch",
    "lr": "lr",
    "lr_decay": "lrdec",
    "mom": "mom",
    "rmsprop_alpha": "alpha",
    "adadelta_rho": "rho",
    "lr0": "lr0",
    "noise": "noise",
    "lr_alpha": "lr_alpha",
    "psgld_alpha": "alpha",
    "history_size": "hist",
    "line_search": "line",
    "clip": "clip",
    "engine": "eng",
    "solver": "sol",
    "rtol": "rtol",
}


def dir_name_for(config: Dict[str, Any]) -> str:
    return "".join(f"_{short}{config[key]}"
                   for key, short in SENSIBLE_PARAMS.items() if key in config)


def expand_grid(method: str, grid: Dict[str, Iterable],
                inf_type: str = "sampler",
                defaults: Optional[Dict[str, Any]] = None) -> List[Dict]:
    """All combinations of `grid` (keys in sorted order) merged over the
    defaults, one config each, with its dir_name."""
    defaults = {**DEFAULT_VALUES, **(defaults or {})}
    keys = sorted(grid)
    out = []
    for combo in itertools.product(*(list(grid[k]) for k in keys)):
        cfg = dict(defaults)
        cfg.update({"method": method, "inf_type": inf_type})
        cfg.update(dict(zip(keys, combo)))
        cfg["dir_name"] = dir_name_for(cfg)
        out.append(cfg)
    return out


def write_configs(configs: List[Dict], json_dir: str, output: str,
                  data: Optional[Dict] = None, start_id: int = 1) -> int:
    """One JSON file a config, {id}.json from start_id; returns the count."""
    os.makedirs(json_dir, exist_ok=True)
    for i, cfg in enumerate(configs, start=start_id):
        cfg = dict(cfg, id=i)
        with open(os.path.join(json_dir, f"{i}.json"), "w") as f:
            json.dump({"output": output, "data": data or {},
                       "configs": [cfg]}, f, indent=2)
    return len(configs)


def load_config(json_dir: str, run_id: int) -> Dict:
    with open(os.path.join(json_dir, f"{run_id}.json")) as f:
        return json.load(f)
