"""The port's MAP optimization (`run_optim`, inf_type="optim") against the
JAX driver's, in float64 on the CPU, on the generic GP potential at rk4
(the JAX driver's default solver): L-BFGS with the Armijo and Wolfe
searches, and Adam, SGD with and without momentum and with its
global-norm clip, nag, RMSprop and Adadelta, with and without the
lr/(1 + lr_decay step) schedule; the artifacts, `worker` and the CLI.

Gates.  Loss traces to 1e-9 relative (L-BFGS 1e-8): the same updates in
both packages up to rounding (measured about 1e-14; L-BFGS with the
Wolfe search 1e-11).  torch.optim computes optax's Adam, SGD and
Adadelta; optax's RMSprop (eps inside the square root) and its clip
(g / |g| * max_norm, unchanged below max_norm) are the port's own lines,
held here against optax directly too.  make_plots=True writes the JAX
driver's MAP plots, and the numbers they draw (`optim_plot_numbers`: the
fitted field on the 15 x 15 grid, the rk4 fit at the observation times)
are within 1e-10 of the same numbers from the JAX package's functions.
"""
import json

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bayesian_ode_tpu.experiments.vanderpol_gp import run_optim as jrun_optim
from bayesian_ode_tpu.experiments.vanderpol_gp import worker as jworker
from bayesian_ode_tpu_torch.experiments import vanderpol_gp as tv
from bayesian_ode_tpu_torch.experiments.run import main as cli_main
from torch_parity import (  # noqa: F401
    GENERIC_CONFIG,
    generic_data,
    one_torch_thread,
)

OPTIM_CONFIG = dict(GENERIC_CONFIG, inf_type="optim", num_iters=12)


@pytest.fixture(scope="module")
def data():
    return generic_data()


def _run_both(cfg, data, tmp_path):
    got = tv.run_optim(cfg, data, str(tmp_path / "port"), make_plots=False,
                       device="cpu", dtype=torch.float64)
    want = jrun_optim(cfg, data, str(tmp_path / "jax"), make_plots=False)
    out = lambda root: tmp_path / root / cfg["method"] / "1"  # noqa: E731
    return got, want, out("port"), out("jax")


@pytest.mark.parametrize("extra", [
    dict(method="LBFGS", lr=1.0),
    dict(method="LBFGS", lr=1.0, line_search="wolfe", history_size=4),
    dict(method="Adam", lr=1e-2),
    dict(method="Adam", lr=1e-2, lr_decay=0.1),
    dict(method="SGD", lr=1e-5, clip=10.0),
    dict(method="SGD", lr=1e-5, mom=0.9, clip=1e4, lr_decay=0.05),
    dict(method="nagSGD", lr=1e-5),
    dict(method="RMSprop", lr=1e-3),
    dict(method="RMSprop", lr=1e-3, rmsprop_alpha=0.9, lr_decay=0.2),
    dict(method="Adadelta", lr=1.0),
    dict(method="Adadelta", lr=1.0, adadelta_rho=0.5, lr_decay=0.1),
], ids=lambda e: "-".join(f"{k}={v}" for k, v in e.items()))
def test_run_optim_matches_the_jax_driver(extra, data, tmp_path):
    cfg = dict(OPTIM_CONFIG, **extra)
    got, want, port, jax_out = _run_both(cfg, data, tmp_path)
    rtol = 1e-8 if "LBFGS" in cfg["method"] else 1e-9
    assert set(got) == set(want) == {"final_loss", "best_loss"}
    for key in got:
        np.testing.assert_allclose(got[key], want[key], rtol=rtol)
    losses = np.load(port / "total_loss_arr.npy")
    assert losses.shape == (cfg["num_iters"],)
    np.testing.assert_allclose(losses, np.load(jax_out / "total_loss_arr.npy"),
                               rtol=rtol)
    assert losses.min() < losses[0]
    a = np.load(port / "map_params.npz")
    b = np.load(jax_out / "map_params.npz")
    assert str(a["__treedef__"]) == str(b["__treedef__"])
    for k in ("leaf_0", "leaf_1"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-7, atol=1e-10)
    logged = json.loads((port / "run.jsonl").read_text().splitlines()[-1])
    logged.pop("ts")
    assert logged == dict(event="summary", method=cfg["method"], **got)
    if "LBFGS" in cfg["method"]:
        # rejected moves hold the value: the trace never rises
        assert np.all(np.diff(losses) <= 0)


def test_clip_by_global_norm_is_optax():
    rng = np.random.RandomState(0)
    g = [rng.randn(4, 2), rng.randn(3)]
    for max_norm in (0.5, 100.0):          # clipped, and untouched
        want = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(x) for x in g], None)[0]
        got = tv._clip_by_global_norm([torch.tensor(x) for x in g],
                                      max_norm)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-15)
    # torch's own clip scales by max_norm / (|g| + 1e-6): not optax's
    leaves = [torch.tensor(x) for x in g]
    for x in leaves:
        x.grad = x.clone()
    torch.nn.utils.clip_grad_norm_(leaves, 0.5)
    assert not torch.equal(leaves[0].grad,
                           tv._clip_by_global_norm([torch.tensor(g[0]),
                                                    torch.tensor(g[1])],
                                                   0.5)[0])


def test_rmsprop_is_optax_not_torch():
    """`_first_order`'s RMSprop against optax.rmsprop on a potential of
    small gradients, where eps inside the square root matters: equal to
    optax's, and far from torch.optim.RMSprop's (eps outside)."""
    rng = np.random.RandomState(1)
    x0 = {"a": torch.tensor(rng.randn(3)), "b": torch.tensor(rng.randn(2))}

    def pot(p):
        return 1e-6 * ((p["a"] ** 2).sum() + (p["b"] ** 4).sum())

    cfg = {"method": "RMSprop", "lr": 1e-3, "lr_decay": 0.5}
    x, losses = tv._first_order(cfg, pot, x0, 5)
    tx = optax.rmsprop(lambda n: 1e-3 / (1 + 0.5 * n), decay=0.99)
    jx = {k: jnp.asarray(v.numpy()) for k, v in x0.items()}
    state = tx.init(jx)
    for _ in range(5):
        g = {"a": 2e-6 * jx["a"], "b": 4e-6 * jx["b"] ** 3}
        upd, state = tx.update(g, state, jx)
        jx = optax.apply_updates(jx, upd)
    for k in ("a", "b"):
        np.testing.assert_allclose(x[k].numpy(), np.asarray(jx[k]),
                                   rtol=1e-12)
    leaves = [v.clone() for v in tv.tree_leaves(x0)]
    opt = torch.optim.RMSprop(leaves, lr=1e-3, alpha=0.99, eps=1e-8)
    for step in range(5):
        leaves[0].grad = 2e-6 * leaves[0]
        leaves[1].grad = 4e-6 * leaves[1] ** 3
        opt.param_groups[0]["lr"] = 1e-3 / (1 + 0.5 * step)
        opt.step()
    assert (leaves[0] - x["a"]).abs().max() > 1e-3


def test_run_optim_options_and_errors(data, tmp_path):
    with pytest.raises(ValueError, match="unknown optimizer"):
        tv.run_optim(dict(OPTIM_CONFIG, method="Lion", lr=1e-3), data,
                     str(tmp_path), make_plots=False, device="cpu")
    with pytest.raises(ValueError, match="line_search"):
        tv.run_optim(dict(OPTIM_CONFIG, method="LBFGS", lr=1.0,
                          line_search="strong"), data, str(tmp_path),
                     make_plots=False, device="cpu")
    # make_plots=True (the default) writes the JAX driver's MAP plots
    tv.run_optim(dict(OPTIM_CONFIG, method="Adam", lr=1e-3, num_iters=3),
                 data, str(tmp_path / "plots"), device="cpu")
    for name in ("post", "post_log", "phase_map", "trajectories"):
        assert (tmp_path / "plots" / "Adam" / "1"
                / f"{name}.pdf").stat().st_size > 0
    out = tv.run_optim(dict(OPTIM_CONFIG, method="Adam", lr=1e-3,
                            solver="adams", num_iters=2, rtol=1e-5,
                            atol=1e-7), data,
                       str(tmp_path), make_plots=False, device="cpu")
    assert np.isfinite(out["final_loss"])
    # float32 by default; another model's potential
    out = tv.run_optim(dict(OPTIM_CONFIG, method="Adam", lr=1e-2,
                            model="spiral", num_iters=3), data,
                       str(tmp_path), make_plots=False, device="cpu")
    assert np.isfinite(out["final_loss"])


def test_worker_routes_optim_and_raises_for_vi(data, tmp_path):
    cfg = dict(OPTIM_CONFIG, method="Adam", lr=1e-2, num_iters=3)
    got = tv.worker(cfg, data, str(tmp_path / "port"), make_plots=False,
                    device="cpu")
    want = jworker(cfg, data, str(tmp_path / "jax"), make_plots=False)
    # the worker runs float32 (the driver's default dtype) against JAX's
    # float64: equal to float32 rounding
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=1e-5)
    # "vi" and "evidence" route to run_vi and run_evidence (their parity
    # with the JAX driver: test_torch_vi_driver.py,
    # test_torch_evidence_driver.py)
    vi = tv.worker(dict(cfg, inf_type="vi", method="ADVI", num_iters=2,
                        elbo_samples=2, num_samples=3), data,
                   str(tmp_path), make_plots=False, device="cpu")
    assert np.isfinite(vi["final_elbo"]) and vi["num_draws"] == 3
    ev = tv.worker(dict(cfg, inf_type="evidence", method="Evidence",
                        num_rungs=2, num_chains=2, burn_in=1, num_samples=2,
                        smc_particles=25, smc_repeats=1, smc_moves=1,
                        smc_max_stages=2, laplace_iters=1), data,
                   str(tmp_path), make_plots=False, device="cpu")
    assert ev["rank_by"] and np.isfinite(ev["log_z_smc"])


def test_cli_runs_optim_configs(tmp_path):
    blob = {"output": str(tmp_path / "out"),
            "data": {"ode": "vdp", "N": 3, "T": 6, "t_max": 1.5,
                     "noise": 0.05, "x0_scale": 1.5, "seed": 0},
            "configs": [dict(OPTIM_CONFIG, method="LBFGS", lr=1.0,
                             num_iters=3),
                        dict(OPTIM_CONFIG, method="RMSprop", lr=1e-3,
                             num_iters=3, id=2)]}
    (tmp_path / "3.json").write_text(json.dumps(blob))
    cli_main(["--json-dir", str(tmp_path), "--id", "3", "--no-plots",
              "--device", "cpu"])
    for method, i in (("LBFGS", 1), ("RMSprop", 2)):
        out = tmp_path / "out" / method / str(i)
        losses = np.load(out / "total_loss_arr.npy")
        assert losses.shape == (3,) and np.isfinite(losses).all()
        assert (out / "map_params.npz").exists()


def test_optim_plot_numbers_match_jax(data):
    import jax

    from bayesian_ode_tpu import odeint as jodeint
    from bayesian_ode_tpu.experiments.vanderpol_gp import build_model as jb
    from bayesian_ode_tpu.models import kernel_regression as jkr
    from bayesian_ode_tpu_torch.models import kernel_regression as tkr

    jstatic, params0 = jb(OPTIM_CONFIG, data)[:2]
    rng = np.random.RandomState(6)
    params = {k: np.asarray(v) + 0.01 * rng.randn(*np.shape(v))
              for k, v in params0.items()}
    static = tkr.static_from_numpy(jstatic.Z, jstatic.KzzinvL,
                                   jstatic.Kzzinv, jstatic.sf, jstatic.ell)
    got = tv.optim_plot_numbers(OPTIM_CONFIG, data, static,
                                {k: torch.tensor(v)
                                 for k, v in params.items()}, device="cpu")
    jp = jax.tree.map(jnp.asarray, params)
    lo = np.asarray(data["Y"]).reshape(-1, 2).min(0) - 0.5
    hi = np.asarray(data["Y"]).reshape(-1, 2).max(0) + 0.5
    gx, gy = np.meshgrid(np.linspace(lo[0], hi[0], 15),
                         np.linspace(lo[1], hi[1], 15))
    pts = jnp.asarray(np.stack([gx.ravel(), gy.ravel()], 1))
    A = jkr.precompute_weights(jp, jstatic)
    want = {"field": np.asarray(jkr.vector_field(jp, jstatic, 0.0, pts)),
            "fit": np.asarray(jodeint(
                lambda tt, X: jkr.vector_field_fast(A, jstatic, tt, X),
                jnp.asarray(data["x0"]), jnp.asarray(data["t"]),
                method="rk4")),
            "grid_x": gx, "grid_y": gy}
    assert set(got) == set(want)
    for k, w in want.items():
        assert np.max(np.abs(got[k] - w)) <= 1e-10 * np.max(np.abs(w)), k
