"""The port's ODEnet (`models/odenet.py`) against the JAX package's, on the
CPU at dim 32 with four 28x28 images, on the JAX package's own parameters
(`init_params`, carried across by `params_from_numpy`: HWIO to OIHW, NHWC
images to NCHW).

Gates.  `downsample`, `ode_field`, `forward`, the loss and `accuracy`
of both networks ("odenet" with the ODE block through rk4 and through
dopri5 in bounded mode at tol 1e-3, "resnet"), in float64 and float32.
Float64: outputs within 1e-12 relative of JAX's, the loss within 1e-12,
the gradient within 1e-12 of JAX's largest gradient entry (a relative
gate per leaf means nothing where a leaf's true gradient is zero: the
conv biases before a one-channel-a-group GroupNorm get rounding noise in
both packages).  Float32 (JAX with x64 off, as the TPU runs it): outputs
and the loss within 1e-5 relative, the gradient within 1e-4 of the
largest entry; accuracy equal.  The SAME-padding helper agrees with
XLA's "SAME" convolution at odd sizes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_ode_tpu import odeint as jodeint
from bayesian_ode_tpu.models import odenet as jon
from bayesian_ode_tpu_torch import odeint
from bayesian_ode_tpu_torch.models import odenet as ton
from bayesian_ode_tpu_torch.utils.pytree import tree_leaves, tree_map
from torch_parity import max_rel, one_torch_thread  # noqa: F401

DIM = 32
BOUNDED = {"mode": "bounded", "max_steps_per_interval": 32}
TOL = {np.float64: dict(out=1e-12, grad=1e-12),
       np.float32: dict(out=1e-5, grad=1e-4)}
CASES = [("odenet", "rk4"), ("odenet", "dopri5"), ("resnet", None)]


def _solvers(method):
    if method is None:
        return None, None
    opts = BOUNDED if method == "dopri5" else None
    kw = dict(rtol=1e-3, atol=1e-3, method=method, options=opts)
    return (lambda f, h, t: jodeint(f, h, t, **kw),
            lambda f, h, t: odeint(f, h, t, **kw))


def _images(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 28, 28, 1)).astype(dtype)
    return x, np.array([0, 3, 7, 9])


@pytest.fixture(scope="module", params=[np.float64, np.float32],
                ids=["f64", "f32"])
def jax_results(request):
    """Every JAX number the tests compare, for one dtype (x64 off for
    float32): one jit of value-and-grad a case."""
    dt = request.param
    x, y = _images(dt)
    out = {}
    with jax.enable_x64(dt == np.float64):
        for network, method in CASES:
            p = jax.tree.map(lambda a: jnp.asarray(a, dt), jon.init_params(
                jax.random.PRNGKey(0), dim=DIM, network=network))
            jsolve, _ = _solvers(method)
            loss = jon.make_loss(jsolve, jnp.asarray(x), jnp.asarray(y))

            def loss_and_logits(q):
                # jon.make_loss's loss, with the forward's logits beside
                return loss(q), jon.forward(q, jnp.asarray(x), jsolve)

            # one compile a case: the forward under value_and_grad is the
            # same solve (JAX's accuracy is the argmax of these logits)
            (val, logits), grad = jax.jit(jax.value_and_grad(
                loss_and_logits, has_aux=True))(p)
            acc = np.mean(np.argmax(np.asarray(logits), -1) == y)
            h = jon.downsample(p["down"], jnp.asarray(x))
            f = jon.ode_field(p["odefunc"], jnp.asarray(0.3, dt), h)
            out[network, method] = dict(
                params=jax.tree.map(np.asarray, p), loss=float(val),
                grad=jax.tree.map(np.asarray, grad),
                logits=np.asarray(logits), acc=float(acc),
                h=np.asarray(h), f=np.asarray(f))
    return dt, x, y, out


@pytest.mark.parametrize("network,method", CASES,
                         ids=["odenet-rk4", "odenet-dopri5", "resnet"])
def test_odenet_matches_jax(jax_results, network, method):
    dt, x, y, out = jax_results
    ref = out[network, method]
    tdt = torch.float64 if dt == np.float64 else torch.float32
    tol = TOL[dt]
    params = ton.params_from_numpy(ref["params"], dtype=tdt)
    images = torch.as_tensor(x.transpose(0, 3, 1, 2))
    labels = torch.as_tensor(y)
    _, tsolve = _solvers(method)

    h = ton.downsample(params["down"], images)
    assert max_rel(h, ref["h"].transpose(0, 3, 1, 2)) <= tol["out"]
    f = ton.ode_field(params["odefunc"], torch.tensor(0.3, dtype=tdt), h)
    assert max_rel(f, ref["f"].transpose(0, 3, 1, 2)) <= tol["out"]
    with torch.no_grad():
        logits = ton.forward(params, images, tsolve)
    assert max_rel(logits, ref["logits"]) <= tol["out"]
    assert float(ton.accuracy(params, images, labels, tsolve)) == ref["acc"]

    leaves = tree_map(lambda a: a.clone().requires_grad_(True), params)
    val = ton.make_loss(tsolve, images, labels)(leaves)
    assert abs(float(val) - ref["loss"]) <= tol["out"] * abs(ref["loss"])
    # the resnet leaves the ODE block's parameters unused: JAX's zeros
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(
        torch.autograd.grad(val, tree_leaves(leaves), allow_unused=True),
        tree_leaves(leaves))]
    want = tree_leaves(ton.params_from_numpy(ref["grad"],
                                             dtype=torch.float64))
    scale = max(float(w.abs().max()) for w in want)
    err = max(float((g.double() - w).abs().max())
              for g, w in zip(grads, want))
    assert err <= tol["grad"] * scale, err


@pytest.mark.parametrize("size,k,stride", [(28, 3, 1), (28, 4, 2),
                                           (14, 4, 2), (13, 4, 2),
                                           (9, 3, 2), (7, 4, 1)])
def test_same_padding_matches_xla(size, k, stride):
    """The explicit padding equals XLA's "SAME" at even and odd sizes
    (odd kernels pad evenly; an even kernel's odd pixel goes high)."""
    lo, hi = ton.same_padding(size, k, stride)
    assert lo + hi == max((-(-size // stride) - 1) * stride + k - size, 0)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, size, size + 2, 3))
    w = rng.normal(size=(k, k, 3, 5))
    b = rng.normal(size=(5,))
    ref = jon._conv({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                    jnp.asarray(x), stride=stride)
    p = ton.params_from_numpy({"w": w, "b": b}, dtype=torch.float64)
    got = ton._conv(p, torch.as_tensor(x.transpose(0, 3, 1, 2)), stride)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref), rtol=1e-12, atol=1e-12)


def test_group_norm_matches_jax():
    """GroupNorm over min(32, C) groups, biased variance, eps 1e-5."""
    rng = np.random.default_rng(2)
    for c in (8, 64):
        x = rng.normal(size=(3, 5, 5, c)) * 3.0 + 1.0
        p = {"scale": rng.normal(size=(c,)), "bias": rng.normal(size=(c,))}
        ref = jon._group_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
        got = ton._group_norm({k: torch.as_tensor(v) for k, v in p.items()},
                              torch.as_tensor(x.transpose(0, 3, 1, 2)))
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                                   np.asarray(ref), rtol=1e-12,
                                   atol=1e-12)


def test_init_params_shapes_and_networks():
    """The port's own initialisation: JAX's tree in OIHW, 6 residual
    blocks for "resnet", a clear error for an unknown network."""
    gen = torch.Generator().manual_seed(0)
    p = ton.init_params(gen, dim=16, network="resnet")
    j = jon.init_params(jax.random.PRNGKey(0), dim=16, network="resnet")
    assert len(p["resblocks"]) == 6
    for a, b in zip(tree_leaves(p), jax.tree.leaves(j)):
        bshape = b.shape if b.ndim != 4 else (b.shape[3], b.shape[2],
                                              b.shape[0], b.shape[1])
        assert tuple(a.shape) == tuple(bshape)
    x = torch.randn(2, 1, 28, 28, generator=gen)
    assert ton.forward(p, x).shape == (2, 10)
    with pytest.raises(ValueError, match="network"):
        ton.init_params(gen, network="vgg")
