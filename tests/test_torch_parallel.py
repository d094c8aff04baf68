"""The port's `parallel/` package on 8 CPU shards (the counterpart of the
JAX suite's 8 virtual devices): tests/test_sharding.py, test_runtime.py
and the sharded cases of test_tempering.py.

Gates.  The mesh helpers lay trees out shard by shard and refuse an
indivisible leading axis; `process_slice` partitions exactly.  The
chain-parallel samplers (SGLD, pSGLD, MALA and aSGHMC batched, the NPSDE
potential, and single-chain MALA through `sample_chains_sharded`) equal,
bit for bit, an unsharded run of each shard's chains under the shard's
generator.  `smc_sharded` equals the unsharded `samplers.smc` bit for bit
(ladder, log Z, particles, log likelihoods, acceptance) for a
row-independent potential.  `gp_dopri5_solve_sharded` equals the
unsharded solve bit for bit and agrees with the JAX package's sharded
solve (interpret mode, 8 devices) at `torch_parity.check_solve`'s float32
gates.  `run_svgd_sharded` equals the port's unsharded SVGD bit for bit
and the JAX package's sharded SVGD within 1e-10 in float64.  Sharded
replica exchange recovers a correlated Gaussian's moments (means within
0.15, covariance within 0.2) as the JAX package's does on the same
problem, the two within 0.2 of each other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu import parallel as jpar
from bayesian_ode_tpu_torch import parallel as P
from bayesian_ode_tpu_torch import samplers, sde
from bayesian_ode_tpu_torch.models import kernel_regression as tkr
from bayesian_ode_tpu_torch.ops.gp_dopri5 import gp_dopri5_solve_whole
from bayesian_ode_tpu_torch.parallel import runtime as rt
from bayesian_ode_tpu_torch.parallel.chains import shard_generator
from bayesian_ode_tpu_torch.samplers.smc import smc
from torch_parity import check_solve, gp_problem, one_torch_thread  # noqa

F64 = torch.float64
COV = np.asarray([[1.0, 0.6], [0.6, 0.8]])


def _mesh(axis="chain"):
    return P.make_mesh(8, axis=axis, devices=["cpu"])


def _gauss_pot():
    prec = torch.linalg.inv(torch.as_tensor(COV))
    return lambda x: 0.5 * x @ prec @ x


# ---- meshes and layouts ----

def test_mesh_helpers_lay_out_shards():
    mesh = _mesh()
    assert mesh.shape == {"chain": 8} and mesh.size == 8
    with pytest.raises(ValueError, match="divisible"):
        P.shard_leading_axis({"a": torch.ones(12, 2)}, mesh)
    with pytest.raises(ValueError, match="leading axis"):
        P.shard_leading_axis({"a": torch.ones(16), "b": torch.ones(8)}, mesh)
    tree = {"a": torch.arange(16.0).reshape(16, 1), "b": torch.ones(16, 3)}
    sh = P.shard_leading_axis(tree, mesh)
    assert len(sh.shards) == 8
    assert all(s["a"].shape == (2, 1) for s in sh.shards)
    assert torch.equal(sh.shards[3]["a"], tree["a"][6:8])
    assert torch.equal(sh.local()["a"], tree["a"])
    rep = P.replicated({"c": torch.ones(4)}, mesh)
    assert len(rep.shards) == 8 and torch.equal(rep.local()["c"],
                                                torch.ones(4))
    assert P.shard_leading_axis(sh, mesh) is sh


def test_mesh_2d_replicates_over_the_other_axis():
    mesh = P.make_mesh_2d(2, 4, devices=["cpu"])
    assert mesh.shape == {"chain": 2, "particle": 4}
    x = torch.arange(8.0)
    sh = P.shard_leading_axis(x, mesh, "chain")
    # shards (c, p): the 'chain' block c whatever p
    assert [s.tolist() for s in sh.shards[:4]] == [[0, 1, 2, 3]] * 4
    assert [s.tolist() for s in sh.shards[4:]] == [[4, 5, 6, 7]] * 4
    assert torch.equal(sh.local(), x)
    out = P.run_svgd_sharded(_gauss_pot(), torch.randn(
        8, 2, dtype=F64, generator=torch.Generator().manual_seed(0)),
        0.1, 2, mesh, axis="particle")
    assert out.shape == (8, 2)


def test_mesh_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices"):
        P.make_mesh()
    with pytest.raises(RuntimeError, match="devices"):
        P.global_mesh()


@pytest.mark.parametrize("n_total,P_", [(81, 4), (8, 8), (7, 3), (5, 8)])
def test_process_slice_partitions_exactly(n_total, P_):
    covered, sizes = [], []
    for p in range(P_):
        s = P.process_slice(n_total, P.Runtime(p, P_, 1, P_))
        covered.extend(range(n_total)[s])
        sizes.append(len(range(n_total)[s]))
    assert covered == list(range(n_total))
    assert max(sizes) - min(sizes) <= 1


# ---- the runtime in one process ----

def test_init_runtime_single_process_noop():
    r = P.init_runtime(device="cpu")
    assert r.process_index == 0 and r.process_count == 1
    assert r.is_coordinator
    assert P.init_runtime(device="cpu") == r
    assert P.process_slice(10) == slice(0, 10)
    hits = []
    assert P.coordinator_only(lambda: hits.append(1) or "done") == "done"
    assert hits == [1]


def test_global_mesh_and_host_local_to_global_single_process():
    mesh = P.global_mesh("chain", devices=["cpu"] * 8)
    assert mesh.size == 8 and not mesh.spans_processes
    tree = {"U": torch.arange(48.0).reshape(24, 2),
            "logsn": torch.arange(24.0)}
    a = P.host_local_to_global(tree, mesh, "chain")
    b = P.shard_leading_axis(tree, mesh, "chain")
    for x, y in zip(a.shards, b.shards):
        assert torch.equal(x["U"], y["U"])
        assert torch.equal(x["logsn"], y["logsn"])


def test_cluster_env_detection(monkeypatch):
    for var in ("WORLD_SIZE", "SLURM_NTASKS"):
        monkeypatch.delenv(var, raising=False)
    assert not rt._cluster_env_present()
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert not rt._cluster_env_present()
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert rt._cluster_env_present()
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setenv("SLURM_NTASKS", "1")
    assert not rt._cluster_env_present()
    monkeypatch.setenv("SLURM_NTASKS", "16")
    assert rt._cluster_env_present()


# ---- collective-free chains ----

def _npsde_problem():
    rng = np.random.default_rng(40)
    ts = torch.linspace(0.0, 2.0, 21, dtype=F64)
    Y = torch.as_tensor(np.cumsum(0.1 * rng.normal(size=(4, 21, 2)), 1))
    static = tkr.make_static(tkr.make_inducing_grid(Y, M=3), sf=1.0,
                             ell=1.0)
    pot = sde.make_gp_sde_potential_batched(static, ts, Y)
    pos0 = {"U": torch.as_tensor(0.1 * rng.normal(size=(32, 9, 2))),
            "logsd": torch.full((32, 2), float(np.log(0.2)), dtype=F64)}
    return pot, pos0, 1e-4


def _quadratic_problem():
    rng = np.random.default_rng(4)
    pot = lambda p: 0.5 * (p ** 2).sum(-1)  # noqa: E731
    return pot, torch.as_tensor(rng.normal(size=(32, 3)) + 2.0), None


KERNELS = {
    "sgld": lambda pot, lr: samplers.sgld_batched(pot, lr or 0.02),
    "psgld": lambda pot, lr: samplers.psgld_batched(pot, lr or 0.02),
    "mala": lambda pot, lr: samplers.mala_batched(pot, lr or 0.1),
    "asghmc": lambda pot, lr: samplers.asghmc_batched(pot, lr or 0.1,
                                                      burn_in_steps=3),
}


@pytest.mark.parametrize("name,problem", [
    ("sgld", _quadratic_problem), ("psgld", _quadratic_problem),
    ("mala", _quadratic_problem), ("asghmc", _quadratic_problem),
    ("sgld", _npsde_problem)],
    ids=["sgld", "psgld", "mala", "asghmc", "npsde-sgld"])
def test_sample_chain_sharded_batched_equals_unsharded(name, problem):
    pot, pos0, lr = problem()
    kernel = KERNELS[name](pot, lr)
    mesh = _mesh()
    positions, pots = P.sample_chain_sharded_batched(
        kernel, pos0, 7, num_samples=5, mesh=mesh, burn_in=2)
    C = pots.shape[1]
    assert pots.shape == (5, C) and bool(torch.isfinite(pots).all())
    rows = C // 8
    for k in range(8):
        sl = slice(k * rows, (k + 1) * rows)
        mine = {n: v[sl] for n, v in pos0.items()} \
            if isinstance(pos0, dict) else pos0[sl]
        _, ref_pos, ref_info = samplers.sample_chain(
            kernel, kernel.init(mine), shard_generator(7, k, "cpu"), 5, 2)
        assert torch.equal(ref_info["potential"], pots[:, sl])
        got = {n: v[:, sl] for n, v in positions.items()} \
            if isinstance(positions, dict) else positions[:, sl]
        if isinstance(got, dict):
            assert all(torch.equal(got[n], ref_pos[n]) for n in got)
        else:
            assert torch.equal(got, ref_pos)
    # the shards draw from distinct generators
    first, second = pots[:, :rows], pots[:, rows:2 * rows]
    assert not torch.equal(first, second)


def test_sample_chains_sharded_equals_unsharded():
    pot = _gauss_pot()
    kernel = samplers.mala(pot, step_size=0.25)
    states = samplers.init_chains(kernel, torch.Generator().manual_seed(0),
                                  torch.zeros(2, dtype=F64), 16, jitter=1.0)
    mesh = _mesh()
    finals, pos, infos = P.sample_chains_sharded(kernel, states, 3, 10, mesh,
                                                 burn_in=5)
    assert pos.shape == (16, 10, 2) and len(finals) == 16
    for k in range(8):
        _, ref, _ = samplers.sample_chains(
            kernel, states[2 * k:2 * k + 2], shard_generator(3, k, "cpu"),
            10, 5)
        assert torch.equal(pos[2 * k:2 * k + 2], ref)
    with pytest.raises(ValueError, match="divisible"):
        P.sample_chains_sharded(kernel, states[:12], 3, 1, mesh)


# ---- the sharded GP solve ----

@pytest.fixture(scope="module")
def gp():
    p = gp_problem(C=16)
    s = p["tstatic"]
    s32 = type(s)(*[v.to(torch.float32) if torch.is_tensor(v) else v
                    for v in s])
    return p, s32


def test_gp_dopri5_solve_sharded_equals_unsharded_and_jax(gp):
    p, s32 = gp
    A, x0, ts = (torch.as_tensor(p[k]) for k in ("A", "x0", "t"))
    tol = dict(rtol=1e-5, atol=1e-7)
    ys, st = P.gp_dopri5_solve_sharded(A, x0, ts, s32, _mesh(), **tol)
    ys1, st1 = gp_dopri5_solve_whole(A, x0, ts, s32, **tol)
    assert torch.equal(ys, ys1)
    for k in ("nfe", "n_accepted", "n_rejected", "n_iterations"):
        assert torch.equal(st[k], st1[k]), k
    assert st["reached_final_time"] is True
    ys_j, st_j = jpar.gp_dopri5_solve_sharded(
        jnp.asarray(p["A"]), jnp.asarray(p["x0"]), jnp.asarray(p["t"]),
        p["jstatic32"], jpar.make_mesh(8, axis="chain"), tile=8,
        interpret=True, **tol)
    check_solve(ys, st, ys_j, st_j)
    assert bool(st_j["reached_final_time"])


def test_the_start_of_a_chain_does_not_depend_on_its_batch(gp):
    """The fused engine's Hairer start in blocks of a fixed size (the
    card's way, `ops.fused_field._start`): a chain's start slope and step
    are the same bit for bit whatever rows are solved with it, the last
    block padded; a block as large as the batch is the CPU's own start."""
    from bayesian_ode_tpu_torch.ops.fused_field import _start
    from bayesian_ode_tpu_torch.ops.gp_field import gp_field

    p, s32 = gp
    A, x0 = torch.as_tensor(p["A"]), torch.as_tensor(p["x0"])
    field, w = gp_field(s32.sf, s32.ell), (A, s32.Z)
    _, f0, dt0 = _start(field, w, x0, 1e-5, 1e-7, block=6)
    assert f0.shape == (16,) + x0.shape and dt0.shape == (16,)
    for lo, hi in ((0, 16), (3, 16), (5, 11), (13, 14)):
        _, f0k, dt0k = _start(field, (A[lo:hi], s32.Z), x0, 1e-5, 1e-7,
                              block=6)
        assert torch.equal(f0k, f0[lo:hi]) and torch.equal(dt0k, dt0[lo:hi])
    _, f0c, dt0c = _start(field, w, x0, 1e-5, 1e-7)
    _, f0w, dt0w = _start(field, w, x0, 1e-5, 1e-7, block=16)
    assert torch.equal(f0c, f0w) and torch.equal(dt0c, dt0w)


# ---- SMC ----

def _smc_problem():
    rng = np.random.default_rng(7)
    y = torch.as_tensor(rng.normal(0.0, 0.5, (8, 3)))

    def log_lik(p):
        r = y[None] - p["x"][:, None]
        return -0.5 * (r * r).sum((1, 2)) / 0.25 \
            - 0.5 * 24 * np.log(2 * np.pi * 0.25)

    def log_prior(p):
        return -0.5 * (p["x"] ** 2).sum(-1) - 1.5 * np.log(2 * np.pi)

    prior = {"x": torch.as_tensor(rng.normal(size=(64, 3)))}
    return log_lik, log_prior, prior


def test_smc_sharded_equals_unsharded():
    log_lik, log_prior, prior = _smc_problem()
    ref = smc(torch.Generator().manual_seed(11), log_lik, log_prior, prior,
              num_moves=3, max_stages=50)
    got = P.smc_sharded(11, log_lik, log_prior, prior,
                        _mesh("particle"), num_moves=3, max_stages=50)
    assert got.num_stages == ref.num_stages > 1
    ns = ref.num_stages
    for field in ("betas", "ess", "accept_rate", "step_sizes"):
        assert torch.equal(getattr(got, field)[:ns],
                           getattr(ref, field)[:ns]), field
    assert torch.equal(got.log_z, ref.log_z)
    assert torch.equal(got.particles["x"], ref.particles["x"])
    assert torch.equal(got.log_lik, ref.log_lik)


def test_smc_sharded_validates_particle_count():
    prior = {"x": torch.zeros(12, 2, dtype=F64)}     # 12 % 8 != 0
    zero = lambda p: torch.zeros(p["x"].shape[0], dtype=F64)  # noqa: E731
    with pytest.raises(ValueError, match="divisible"):
        P.smc_sharded(0, zero, zero, prior, _mesh("particle"))


def test_a_failing_shard_raises_in_the_caller():
    """An exception in one block's potential (the block of shard 5 of 8)
    is raised to the caller, by the chain paths and by SMC."""
    def log_lik(p):
        x = p["x"] if isinstance(p, dict) else p
        if bool((x[:, 0] > 100.0).any()):
            raise ArithmeticError("shard 5")
        return -(x ** 2).sum(-1)

    prior = {"x": torch.zeros(16, 2, dtype=F64)}
    prior["x"][10, 0] = 1000.0
    with pytest.raises(ArithmeticError, match="shard 5"):
        P.smc_sharded(0, log_lik, log_lik, prior, _mesh("particle"))
    kernel = samplers.sgld_batched(lambda x: -log_lik(x), 0.01)
    with pytest.raises(ArithmeticError, match="shard 5"):
        P.sample_chain_sharded_batched(kernel, prior["x"], 0, 2, _mesh())


# ---- SVGD ----

def test_run_svgd_sharded_equals_unsharded_and_jax():
    rng = np.random.default_rng(2)
    parts = rng.normal(size=(64, 2)) * 2.0
    pot = _gauss_pot()
    got = P.run_svgd_sharded(pot, torch.as_tensor(parts), 0.3, 20,
                             _mesh("particle"))
    kernel = samplers.svgd(pot, step_size=0.3)
    state = kernel.init(torch.as_tensor(parts))
    for _ in range(20):
        state, _ = kernel.step(None, state)
    assert torch.equal(got, state.particles)
    jprec = jnp.asarray(np.linalg.inv(COV))
    want = jpar.run_svgd_sharded(lambda x: 0.5 * x @ jprec @ x,
                                 jnp.asarray(parts), 0.3, 20,
                                 jpar.make_mesh(8, axis="particle"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(want)).max())
    one = P.svgd_step_sharded(pot, torch.as_tensor(parts), 0.3,
                              _mesh("particle"))
    assert one.shape == (64, 2)


# ---- replica exchange ----

def test_pt_sharded_moments_against_jax():
    C, burn, kept = 32, 100, 300
    betas = np.geomspace(1.0, 0.1, 8)
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(C, 2))
    cold, info = P.run_parallel_tempering_sharded(
        _gauss_pot(), betas, 0.25, torch.as_tensor(x0), 2, kept,
        burn_in=burn, mesh=_mesh("replica"))
    assert cold.shape == (kept, C, 2)
    assert info["potential"].shape == (kept, C)
    flat = cold.reshape(-1, 2).numpy()
    jprec = jnp.asarray(np.linalg.inv(COV))
    jcold, jinfo = jpar.run_parallel_tempering_sharded(
        lambda x: 0.5 * x @ jprec @ x, betas, 0.25, jnp.asarray(x0),
        jax.random.PRNGKey(2), kept, burn_in=burn,
        mesh=jpar.make_mesh(8, axis="replica"))
    jflat = np.asarray(jcold).reshape(-1, 2)
    for f in (flat, jflat):
        assert np.abs(f.mean(0)).max() < 0.15
        assert np.abs(np.cov(f.T) - COV).max() < 0.2
    assert np.abs(flat.mean(0) - jflat.mean(0)).max() < 0.2
    assert np.abs(np.cov(flat.T) - np.cov(jflat.T)).max() < 0.2
    for s in (float(info["swap_accepted"].mean()),
              float(np.asarray(jinfo["swap_accepted"]).mean())):
        assert 0.2 < s < 0.99
    assert float(info["accepted"].float().mean()) > 0.5


def test_pt_sharded_ladder_must_match_mesh():
    with pytest.raises(ValueError, match="mesh axis size"):
        P.run_parallel_tempering_sharded(
            _gauss_pot(), np.geomspace(1.0, 0.1, 4), 0.1,
            torch.zeros(4, 2, dtype=F64), 0, 10, mesh=_mesh("replica"))
