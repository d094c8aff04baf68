"""Parity of the port's SVGD (samplers/stein.py, the KSD, ravel_pytree and
the plain version of kernel K8) with the JAX package.

Gates.  K8's plain version against the JAX Pallas kernel in interpret mode
and against the JAX reference at the JAX test's rtol 2e-5 (atol 2e-6, and
2e-3 for the scores scaled by 1e3), in float32.  The bandwidth, the KSD and
the SVGD flows on a float64 Gaussian to 1e-12 relative: the same
arithmetic in float64.  The flow over the fused GP rk4 potential in
float32, without AdaGrad, over 3 steps: the two packages' float32 scores
agree to 4e-6 max-rel, but their float32 phi of the clustered ensemble
does not (see the test), so each phi is held against float64 within 2x
the JAX package's own error.  With AdaGrad the first step is nearly
lr * sign(phi), which flips with the noise of a near-zero coordinate, so
there only phi and the seeded history hist = phi^2 of step 0 are compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree as jravel

from bayesian_ode_tpu import samplers as jsamplers
from bayesian_ode_tpu.ops.gp_rk4 import (
    make_fused_gp_potential as jmake_potential,
)
from bayesian_ode_tpu.ops.pallas_rbf import (
    svgd_phi_pallas,
)
from bayesian_ode_tpu.ops.pallas_rbf import (
    svgd_phi_reference as jphi_reference,
)
from bayesian_ode_tpu.samplers import stein as jstein
from bayesian_ode_tpu_torch import samplers as tsamplers
from bayesian_ode_tpu_torch.ops import _build
from bayesian_ode_tpu_torch.ops import svgd_phi as svgd_phi_module
from bayesian_ode_tpu_torch.ops.gp_rk4 import make_fused_gp_potential
from bayesian_ode_tpu_torch.ops.svgd_phi import svgd_phi, svgd_phi_reference
from bayesian_ode_tpu_torch.samplers import stein as tstein
from bayesian_ode_tpu_torch.utils.pytree import ravel_pytree
from torch_parity import (  # noqa: F401
    gp_problem,
    max_rel,
    one_torch_thread,
    to_np,
)


def _phi_inputs(n, d, seed, score_scale=1.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d).astype(np.float32),
            (score_scale * rng.randn(n, d)).astype(np.float32))


@pytest.mark.parametrize("n,d,scale,atol", [
    (256, 2, 1.0, 2e-6), (300, 2, 1.0, 2e-6), (256, 5, 1.0, 2e-6),
    (130, 3, 1.0, 2e-6), (100, 2, 1e3, 2e-3)])
def test_plain_phi_matches_the_jax_kernel_and_reference(n, d, scale, atol,
                                                        monkeypatch):
    """The JAX test's shapes, and its padding case (scores x 1e3, where
    the TPU kernel's far-away padded rows must not leak).

    On CPU tensors `svgd_phi` is its plain version.  That is checked by
    identity (it returns the plain version's own result, from one call,
    and launches nothing), not by comparing two evaluations bit for bit:
    two evaluations of the CPU matrix products on the same inputs in one
    loaded test process have differed in one 64-row block of the 256 rows
    (64 of 512 elements, up to 7.3e-6 at |phi| 0.14, 50x this product's
    float32 error to float64)."""
    X, S = _phi_inputs(n, d, seed=n + d, score_scale=scale)
    gamma = 0.7 if scale == 1.0 else 1.3
    tile = 128 if scale == 1.0 else 64
    calls = []

    def plain(*args):
        calls.append(svgd_phi_reference(*args))
        return calls[-1]

    monkeypatch.setattr(svgd_phi_module, "svgd_phi_reference", plain)
    before = dict(_build.launch_counts)
    got = svgd_phi(torch.tensor(X), torch.tensor(S), gamma)
    assert len(calls) == 1 and got is calls[0]
    assert _build.launch_counts == before
    assert got.dtype == torch.float32 and got.shape == (n, d)
    pallas = svgd_phi_pallas(jnp.asarray(X), jnp.asarray(S), gamma,
                             tile_rows=tile, interpret=True)
    ref = jphi_reference(jnp.asarray(X), jnp.asarray(S), gamma)
    for want in (pallas, ref):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=2e-5,
                                   atol=atol)


def test_ravel_pytree_matches_jax():
    rng = np.random.RandomState(0)
    tree = {"logsn": rng.randn(2), "U": rng.randn(36, 2),
            "layers": [{"w": rng.randn(3, 4), "b": rng.randn(4)}]}
    jflat, _ = jravel(jax.tree.map(jnp.asarray, tree))
    flat, unravel = ravel_pytree({k: (torch.tensor(v) if k != "layers" else
                                      [{kk: torch.tensor(vv) for kk, vv in
                                        v[0].items()}])
                                  for k, v in tree.items()})
    np.testing.assert_array_equal(to_np(flat), np.asarray(jflat))
    back = unravel(flat)
    np.testing.assert_array_equal(to_np(back["U"]), tree["U"])
    np.testing.assert_array_equal(to_np(back["layers"][0]["w"]),
                                  tree["layers"][0]["w"])
    # a batch (..., P) unravels leaf by leaf with the leading axes kept
    batch = unravel(torch.stack([flat, 2 * flat]))
    assert batch["U"].shape == (2, 36, 2)
    np.testing.assert_array_equal(to_np(batch["logsn"][1]),
                                  2 * tree["logsn"])


@pytest.mark.parametrize("n,k", [(64, None), (63, None), (1000, 256)])
def test_rbf_bandwidth_matches_jax(n, k):
    """Exact at an even and an odd count of pairs (jnp.median averages the
    two middle values of an even count, torch.median would take the lower
    one), and on the strided subsample of 1,000 particles."""
    X = np.random.RandomState(n).randn(n, 3) * np.array([1.0, 2.0, 0.5])
    got = float(tstein.rbf_bandwidth(torch.tensor(X), median_subsample=k))
    want = float(jstein.rbf_bandwidth(jnp.asarray(X), median_subsample=k))
    assert got == pytest.approx(want, rel=1e-12, abs=0)
    lower = torch.tensor(X)
    d2 = tstein.pairwise_sq_dists(lower, lower)
    if d2.numel() % 2 == 0:                   # the trap is real here
        assert float(torch.median(d2)) != float(tstein._median(d2))
    assert float(tstein.rbf_bandwidth(torch.tensor(X), sigma=1.3)) == \
        pytest.approx(1.0 / (1e-8 + 2 * 1.3 ** 2), rel=1e-15)


def test_rbf_kernel_matches_jax():
    rng = np.random.RandomState(11)
    X, Y = rng.randn(64, 3), rng.randn(96, 3) + 10.0
    K, gamma = tstein.rbf_kernel(torch.tensor(X), torch.tensor(Y))
    Kj, gj = jstein.rbf_kernel(jnp.asarray(X), jnp.asarray(Y))
    assert float(gamma) == pytest.approx(float(gj), rel=1e-12)
    np.testing.assert_allclose(to_np(K), np.asarray(Kj), rtol=1e-10, atol=0)


@pytest.mark.parametrize("u_statistic", [False, True])
def test_kernel_stein_discrepancy_matches_jax(u_statistic):
    rng = np.random.RandomState(3)
    x = rng.randn(200, 2) * np.array([1.0, 1.5]) + 0.3
    got = tsamplers.kernel_stein_discrepancy(torch.tensor(x), lambda v: -v,
                                             u_statistic=u_statistic)
    want = jsamplers.kernel_stein_discrepancy(jnp.asarray(x), lambda v: -v,
                                              u_statistic=u_statistic)
    assert float(got) == pytest.approx(float(want), rel=1e-12)
    with pytest.raises(ValueError):
        tsamplers.kernel_stein_discrepancy(torch.tensor(x), lambda v: -v,
                                           beta=0.5)
    with pytest.raises(ValueError):
        tsamplers.kernel_stein_discrepancy(torch.tensor(x),
                                           lambda v: v[:, :1])


# a correlated float64 Gaussian: U(x) = x' P x / 2
_P = np.array([[2.0, 0.6], [0.6, 0.5]])


def _gauss_torch(v):
    return 0.5 * v @ torch.tensor(_P) @ v


def _gauss_jax(v):
    return 0.5 * v @ jnp.asarray(_P) @ v


@pytest.mark.parametrize("adagrad", [False, True])
def test_svgd_flows_match_jax_step_for_step(adagrad):
    """svgd (per-particle scores) and svgd_batched (one batched pass) over
    20 deterministic steps, against the JAX kernels, in float64."""
    x0 = np.random.RandomState(42).randn(64, 2) * 2.0 + 1.0
    lr = 0.05 if adagrad else 0.3
    tk = [tsamplers.svgd(_gauss_torch, lr, adagrad=adagrad),
          tsamplers.svgd_batched(torch.func.vmap(_gauss_torch), lr,
                                 adagrad=adagrad)]
    jk = [jsamplers.svgd(_gauss_jax, lr, adagrad=adagrad),
          jsamplers.svgd_batched(jax.vmap(_gauss_jax), lr, adagrad=adagrad)]
    for t_kern, j_kern in zip(tk, jk):
        ts, js = t_kern.init(torch.tensor(x0)), j_kern.init(jnp.asarray(x0))
        for i in range(20):
            ts, ti = t_kern.step(None, ts)
            js, ji = j_kern.step(jax.random.PRNGKey(i), js)
            assert float(ti["potential"]) == pytest.approx(
                float(ji["potential"]), rel=1e-12)
        assert ts.step == 20
        assert max_rel(ts.particles, js.particles) <= 1e-12
        if adagrad:
            assert max_rel(ts.accum, js.accum) <= 1e-12


def test_svgd_batched_on_a_tree_and_the_dispatch():
    """Tree positions are flattened in JAX's leaf order; "always" takes
    K8's plain version on CPU tensors, the same numbers as the matmul form,
    and launches nothing; a bad use_kernel raises."""
    rng = np.random.RandomState(5)
    pos = {"U": rng.randn(32, 3, 2), "logsn": rng.randn(32, 2)}

    def tpot(p):
        return 0.5 * ((p["U"] ** 2).sum(dim=(-2, -1))
                      + 3.0 * (p["logsn"] ** 2).sum(dim=-1))

    def jpot(p):
        return 0.5 * (jnp.sum(p["U"] ** 2, (-2, -1))
                      + 3.0 * jnp.sum(p["logsn"] ** 2, -1))

    tpos = {k: torch.tensor(v) for k, v in pos.items()}
    jk = jsamplers.svgd_batched(jpot, 0.1)
    js, _ = jk.step(None, jk.init({k: jnp.asarray(v) for k, v in
                                   pos.items()}))
    before = dict(_build.launch_counts)
    outs = []
    for use in ("auto", "never", "always"):
        k = tsamplers.svgd_batched(tpot, 0.1, use_kernel=use)
        s, _ = k.step(None, k.init(tpos))
        outs.append(s.particles)
    assert _build.launch_counts == before
    assert outs[0].shape == (32, 8)
    assert max_rel(outs[0], js.particles) <= 1e-12
    assert max_rel(outs[2], outs[1]) <= 1e-12
    with pytest.raises(ValueError, match="use_kernel"):
        k = tsamplers.svgd_batched(tpot, 0.1, use_kernel="pallas")
        k.step(None, k.init(tpos))


@pytest.fixture(scope="module")
def gp_svgd():
    """128 particles on the GP posterior (the JAX bench's SVGD set-up at a
    small shape) and both packages' fused rk4 potentials."""
    p = gp_problem(C=128)
    jpot = jmake_potential(p["jstatic32"], jnp.asarray(p["x0"]),
                           jnp.asarray(p["t"]), jnp.asarray(p["Y"]),
                           tile=128, interpret=True)
    tpot = make_fused_gp_potential(p["tstatic"], torch.tensor(p["x0"]),
                                   torch.tensor(p["t"]), torch.tensor(p["Y"]))
    pos = {"U": p["U"], "logsn": p["logsn"]}
    return pos, jpot, tpot


def _phi_err(phi, particles, scores):
    """max-rel of a float32 phi against the float64 matmul form on the same
    particles and scores."""
    f64 = torch.float64
    truth = tstein.svgd_direction(torch.tensor(to_np(particles), dtype=f64),
                                  torch.tensor(to_np(scores), dtype=f64),
                                  median_subsample=256)
    return max_rel(to_np(phi).astype(np.float64), truth)


def _jax_scores(jpot, particles, unravel):
    return -jax.grad(lambda f: jnp.sum(jpot(jax.vmap(unravel)(f))))(
        particles)


def _torch_scores(tpot, particles, unravel):
    x = particles.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(tpot(unravel(x)).sum(), [x])
    return -g


def test_svgd_batched_over_the_fused_gp_potential(gp_svgd):
    """Three steps without AdaGrad.  The particles are jittered by 3e-3
    around one point, so |x_i|^2 + |x_j|^2 - 2 x_i . x_j cancels: float32
    phi is about 5e-2 from float64 in both packages (measured 5.5e-2 here,
    6.5e-2 in JAX), and their flows part at that level.  So each step's
    phi (the step's displacement over lr) is held against float64 on the
    package's own state, within 2x the JAX package's error (floor 1e-5),
    the JAX gate for float32 paths; the potentials within 1e-2."""
    pos, jpot, tpot = gp_svgd
    lr = 1e-2
    jk = jsamplers.svgd_batched(jpot, lr)
    tk = tsamplers.svgd_batched(tpot, lr)
    js = jk.init({k: jnp.asarray(v) for k, v in pos.items()})
    ts = tk.init({k: torch.tensor(v) for k, v in pos.items()})
    np.testing.assert_array_equal(to_np(ts.particles),
                                  np.asarray(js.particles))
    _, junravel = jravel({k: jnp.asarray(v[0]) for k, v in pos.items()})
    _, tunravel = ravel_pytree({k: torch.tensor(v[0]) for k, v in
                                pos.items()})
    for i in range(3):
        jscore = _jax_scores(jpot, js.particles, junravel)
        tscore = _torch_scores(tpot, ts.particles, tunravel)
        js1, ji = jk.step(jax.random.PRNGKey(i), js)
        ts1, ti = tk.step(None, ts)
        assert float(ti["potential"]) == pytest.approx(
            float(ji["potential"]), rel=1e-2)
        err_j = _phi_err((np.asarray(js1.particles) - np.asarray(
            js.particles)) / lr, js.particles, jscore)
        err_t = _phi_err((ts1.particles - ts.particles) / lr, ts.particles,
                         tscore)
        assert err_t <= 2.0 * max(err_j, 1e-5), (i, err_t, err_j)
        js, ts = js1, ts1
    assert ts.particles.dtype == torch.float32 and ts.step == 3
    assert bool(torch.isfinite(ts.particles).all())


def test_svgd_adagrad_first_step_over_the_fused_gp_potential(gp_svgd):
    """With AdaGrad the first step seeds hist = phi^2: phi (its root, up to
    sign) against float64 as above, and the two packages' hist within the
    same noise."""
    pos, jpot, tpot = gp_svgd
    jk = jsamplers.svgd_batched(jpot, 1e-2, adagrad=True)
    tk = tsamplers.svgd_batched(tpot, 1e-2, adagrad=True)
    js0 = jk.init({k: jnp.asarray(v) for k, v in pos.items()})
    ts0 = tk.init({k: torch.tensor(v) for k, v in pos.items()})
    js, _ = jk.step(None, js0)
    ts, _ = tk.step(None, ts0)
    _, junravel = jravel({k: jnp.asarray(v[0]) for k, v in pos.items()})
    _, tunravel = ravel_pytree({k: torch.tensor(v[0]) for k, v in
                                pos.items()})
    jscore = _jax_scores(jpot, js0.particles, junravel)
    tscore = _torch_scores(tpot, ts0.particles, tunravel)
    truth_sign = torch.sign(tstein.svgd_direction(
        ts0.particles.double(), tscore.double(), median_subsample=256))
    err_j = _phi_err(np.sqrt(np.asarray(js.accum)) * to_np(truth_sign),
                     js0.particles, jscore)
    err_t = _phi_err(torch.sqrt(ts.accum) * truth_sign, ts0.particles,
                     tscore)
    assert err_t <= 2.0 * max(err_j, 1e-5), (err_t, err_j)
    assert max_rel(ts.accum, js.accum) <= 4.0 * max(err_j, 1e-5)
