"""The port's experiment CLI (`experiments/run.py`): `--data-pickle` reads a
reference-format data pickle to the same arrays as the JAX package's CLI
(equal, dtype included), and a run on it completes; `--id all` in one
process runs every numeric config id of the directory, and only those
(the counterpart of tests/test_experiments.py's test_cli_id_all).
"""
import json
import pickle

import numpy as np
import pytest
import torch

from bayesian_ode_tpu.experiments import run as jrun
from bayesian_ode_tpu_torch.experiments import run as trun
from torch_parity import one_torch_thread  # noqa: F401

CONFIG = {
    "method": "SGLD", "inf_type": "sampler", "id": 1, "M": 4, "sf": 1.0,
    "ell": 0.75, "noise": 0.1, "burn_in": 1, "num_samples": 2,
    "thinning": 1, "num_chains": 4, "lr0": 1e-5, "lr_gamma": 0.55,
    "lr_t0": 100, "lr_alpha": 1.0, "psgld_alpha": 0.99, "lambda_": 1e-8,
    "engine": "fused", "solver": "rk4", "model": "gp", "seed": 0,
}
DATA = {"ode": "vdp", "N": 2, "T": 10, "t_max": 3.0, "noise": 0.1,
        "seed": 0}


def _write(tmp_path, rid, configs, data=DATA):
    blob = {"output": str(tmp_path / "out"), "data": data,
            "configs": configs}
    (tmp_path / "json").mkdir(exist_ok=True)
    (tmp_path / "json" / f"{rid}.json").write_text(json.dumps(blob))


@pytest.fixture
def data_pickle(tmp_path):
    rng = np.random.default_rng(3)
    t = np.linspace(0.0, 3.0, 10)
    X = np.cumsum(0.1 * rng.normal(size=(2, 10, 2)), axis=1) + 1.0
    raw = {"N": 2, "R": 1, "noise": 0.1, "x0": X[:, 0], "t": t, "X": X,
           "Y": X + 0.1 * rng.normal(size=X.shape), "ODE": "vdp"}
    path = tmp_path / "data.pkl"
    with open(path, "wb") as f:
        pickle.dump(raw, f)
    return path, raw


def test_data_pickle_loads_the_same_arrays_in_both_clis(
        tmp_path, data_pickle, monkeypatch):
    path, raw = data_pickle
    _write(tmp_path, 1, [CONFIG])
    seen = {}
    monkeypatch.setattr(jrun, "worker",
                        lambda cfg, data, out, **kw: seen.update(j=data))
    monkeypatch.setattr(trun, "worker",
                        lambda cfg, data, out, **kw: seen.update(t=data))
    argv = ["--json-dir", str(tmp_path / "json"), "--id", "1",
            "--no-plots", "--data-pickle", str(path)]
    jrun.main(argv)
    trun.main(argv + ["--device", "cpu"])
    j, t = seen["j"], seen["t"]
    assert set(j) == set(t) == set(raw)
    for k in ("x0", "t", "X", "Y"):
        assert torch.is_tensor(t[k]) and t[k].device.type == "cpu"
        assert t[k].numpy().dtype == np.asarray(j[k]).dtype == np.float64
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
    for k in ("N", "R", "noise", "ODE"):
        assert t[k] == j[k] == raw[k]


def test_data_pickle_runs_a_config(tmp_path, data_pickle, capsys):
    path, _ = data_pickle
    _write(tmp_path, 1, [CONFIG])
    trun.main(["--json-dir", str(tmp_path / "json"), "--id", "1",
               "--no-plots", "--device", "cpu", "--data-pickle", str(path)])
    assert "'event': 'summary'" in capsys.readouterr().out
    assert (tmp_path / "out" / "SGLD" / "1" / "chain.npz").exists()


def test_id_all_runs_every_config_of_the_grid(tmp_path, capsys):
    _write(tmp_path, 1, [dict(CONFIG, id=1)])
    _write(tmp_path, 2, [dict(CONFIG, id=2, method="pSGLD")])
    _write(tmp_path, "notes", [dict(CONFIG, id=3, method="MALA")])
    trun.main(["--json-dir", str(tmp_path / "json"), "--id", "all",
               "--no-plots", "--device", "cpu"])
    assert "[process 0/1] config ids [1, 2]" in capsys.readouterr().out
    for rid, method in ((1, "SGLD"), (2, "pSGLD")):
        assert (tmp_path / "out" / method / str(rid) / "chain.npz").exists()
    assert not (tmp_path / "out" / "MALA").exists()


def test_id_must_be_an_integer_or_all(tmp_path):
    with pytest.raises(SystemExit):
        trun.main(["--json-dir", str(tmp_path), "--id", "first",
                   "--device", "cpu"])
