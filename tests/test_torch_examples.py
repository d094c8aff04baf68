"""The port's examples (`bayesian_ode_tpu_torch/examples/`) through their
`main` on the CPU at 2-3 iterations and small sizes, in a temporary
directory: each runs to its end and returns finite losses; the latent
examples checkpoint and resume from their checkpoint; `odenet_mnist`
reads an MNIST-layout .npz written with numpy; and each example stops
with an error, on its own, when asked for a card that is not there.
"""
import math
import os

import numpy as np
import pytest
import torch

from bayesian_ode_tpu_torch.examples import (bouncing_ball,
                                             evidence_model_selection,
                                             latent_ode, latent_sde,
                                             ode_demo, odenet_mnist)
from torch_parity import one_torch_thread  # noqa: F401

CPU = ["--device", "cpu"]
ODENET = ["--niters", "2", "--batch-size", "8", "--dim", "8"]


@pytest.mark.parametrize("network,solver", [("odenet", "dopri5"),
                                            ("odenet", "rk4"),
                                            ("resnet", "rk4")])
def test_odenet_mnist_runs(network, solver):
    rec = odenet_mnist.main(ODENET + CPU + ["--network", network,
                                            "--solver", solver])
    assert rec["iter"] == 2 and math.isfinite(rec["loss"])
    assert 0.0 <= rec["test_acc"] <= 1.0
    assert rec["nfe_forward"] > 0


def test_odenet_mnist_reads_an_npz(tmp_path):
    rng = np.random.default_rng(0)
    path = tmp_path / "digits.npz"
    np.savez(path, x_train=rng.integers(0, 256, (40, 28, 28),
                                        dtype=np.uint8),
             y_train=rng.integers(0, 10, 40).astype(np.int64))
    x, y = odenet_mnist.load_npz(str(path), "cpu")
    assert x.shape == (40, 1, 28, 28) and x.dtype == torch.float32
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    assert y.dtype == torch.int64 and y.shape == (40,)
    rec = odenet_mnist.main(ODENET + CPU + ["--mnist-npz", str(path),
                                            "--solver", "rk4"])
    assert math.isfinite(rec["loss"])


def test_synthetic_digits_shape_and_classes():
    x, y = odenet_mnist.synthetic_digits(torch.Generator().manual_seed(0),
                                         200)
    assert x.shape == (200, 1, 28, 28) and y.shape == (200,)
    assert set(y.tolist()) == set(range(10))
    x2, y2 = odenet_mnist.synthetic_digits(
        torch.Generator().manual_seed(0), 200)
    assert torch.equal(x, x2) and torch.equal(y, y2)


@pytest.mark.parametrize("extra", [[], ["--adjoint"],
                                   ["--method", "rk4"]],
                         ids=["bounded", "adjoint", "rk4"])
def test_ode_demo_runs(extra, tmp_path):
    rec = ode_demo.main(CPU + ["--niters", "3", "--test-freq", "3",
                               "--data-size", "200",
                               "--log", str(tmp_path / "log.jsonl")]
                        + extra)
    assert rec["iter"] == 3 and math.isfinite(rec["total_loss"])
    assert (tmp_path / "log.jsonl").exists()


@pytest.mark.parametrize("example,args", [
    (latent_ode, ["--nspiral", "8"]),
    (latent_sde, ["--ntraj", "16", "--batch", "8"])],
    ids=["latent_ode", "latent_sde"])
def test_latent_example_checkpoints_and_resumes(example, args, tmp_path,
                                                capsys):
    run = CPU + args + ["--train-dir", str(tmp_path), "--ckpt-every", "1"]
    rec = example.main(run + ["--niters", "2"])
    assert rec["iter"] == 2 and math.isfinite(rec["loss"])
    assert os.path.exists(tmp_path / "ckpt.npz")
    rec = example.main(run + ["--niters", "3"])
    assert "resumed" in capsys.readouterr().out
    assert rec["iter"] == 3 and math.isfinite(rec["loss"])
    # each run logs its last iteration (and every 20th)
    assert len((tmp_path / "run.jsonl").read_text().splitlines()) == 2


def test_bouncing_ball_runs_and_learns():
    """100 Adam iterations recover e = 0.73 within the example's own
    1e-3 (from iteration 96 on it stays within 6e-4)."""
    out = bouncing_ball.main(CPU + ["--iters", "100"])
    assert all(map(math.isfinite, out["losses"]))
    assert out["losses"][-1] < 1e-3 * out["losses"][0]
    assert abs(out["e"] - 0.73) < 1e-3


def test_bouncing_ball_stops_when_e_is_not_recovered():
    with pytest.raises(RuntimeError, match="restitution not recovered"):
        bouncing_ball.main(CPU + ["--iters", "3"])


def test_bouncing_ball_contacts():
    """The first contact time from rest at h0 is sqrt(2 h0 / g), and each
    apex is e^2 times the last height."""
    ets, apex = bouncing_ball.simulate(0.73, 10.0, 3)
    assert abs(float(ets[0]) - math.sqrt(2 * 10.0 / bouncing_ball.G)) < 1e-8
    np.testing.assert_allclose(apex.numpy(),
                               10.0 * 0.73 ** (2 * np.arange(1, 4)),
                               rtol=1e-6)


def test_evidence_model_selection_runs(tmp_path, monkeypatch):
    """`main` through `worker` at a budget cut below the example's own
    --quick (the test sets the module's QUICK budget)."""
    monkeypatch.setattr(evidence_model_selection, "QUICK", dict(
        num_rungs=4, num_chains=4, burn_in=2, num_samples=3,
        smc_particles=32, smc_repeats=1, laplace_iters=3, smc_moves=1))
    out = evidence_model_selection.main(CPU + [
        "--out", str(tmp_path), "--grids", "3", "--quick"])
    assert out["selected_M"] == 3
    assert math.isfinite(out["rows"][0][1]["log_z_smc"])
    assert (tmp_path / "selection.json").exists()


@pytest.mark.parametrize("example", [odenet_mnist, ode_demo, latent_ode,
                                     latent_sde, bouncing_ball,
                                     evidence_model_selection])
def test_example_without_a_card_stops(example, monkeypatch, capsys,
                                      tmp_path):
    """--device cuda (the default) with no card is an error, not a
    silent run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--out", str(tmp_path)] \
        if example is evidence_model_selection else []
    with pytest.raises(SystemExit) as exc:
        example.main(argv + ["--device", "cuda"])
    assert exc.value.code != 0
    assert "--device cpu" in capsys.readouterr().err
