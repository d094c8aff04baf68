"""Fixed random draws for step-for-step tests of the port's exact
samplers against the JAX package's.

The two packages draw from different generators, so the tests replace
both packages' draws by the same fixed, non-trivial values: each draw is a
function of its shape alone (a numpy stream seeded by the shape).  JAX's
`normal`, `uniform`, `bernoulli` and `randint` and torch's `randn`,
`rand` and `randint` are patched; a JAX bernoulli(p) is `uniform < p`, as
the port draws it.  With `chain_constant`, torch's draws with a leading
chain axis repeat one chain's draw on every chain: the port's batched
kernels then draw what the JAX package's per-chain kernels draw under
vmap (a draw that ignores its key is the same on every chain).
The JAX package's SMC keys each particle's move draws by its index;
`patch_jax_smc_rows` makes them the whole population's fixed draws, as
the port draws them.
"""
from __future__ import annotations

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import torch


def _shape(shape) -> tuple:
    if shape is None:
        return ()
    if isinstance(shape, (tuple, list, torch.Size)):
        return tuple(int(s) for s in shape)
    return (int(shape),)


def _stream(kind: str, shape: tuple) -> np.random.RandomState:
    return np.random.RandomState(zlib.crc32(f"{kind}{shape}".encode()))


def fixed_normal(shape) -> np.ndarray:
    shape = _shape(shape)
    return _stream("normal", shape).randn(*shape)


def fixed_uniform(shape) -> np.ndarray:
    """Uniforms in [0.02, 0.98]: both tails of a Metropolis test occur."""
    shape = _shape(shape)
    return _stream("uniform", shape).uniform(0.02, 0.98, size=shape)


def patch_jax(monkeypatch) -> None:
    def normal(key, shape=(), dtype=float, *a, **k):
        return jnp.asarray(fixed_normal(shape), dtype)

    def uniform(key, shape=(), dtype=float, minval=0.0, maxval=1.0):
        return jnp.asarray(minval + (maxval - minval) * fixed_uniform(shape),
                           dtype)

    def bernoulli(key, p=0.5, shape=None):
        return jnp.asarray(fixed_uniform(shape) < p)

    def randint(key, shape, minval, maxval, dtype=int):
        return jnp.asarray(np.floor(minval + (maxval - minval)
                                    * fixed_uniform(shape)).astype(np.int32))

    monkeypatch.setattr(jax.random, "normal", normal)
    monkeypatch.setattr(jax.random, "uniform", uniform)
    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    monkeypatch.setattr(jax.random, "randint", randint)


def patch_torch(monkeypatch, chain_constant: bool = False) -> None:
    def draw(fn, size, dtype, device):
        shape = _shape(size[0] if len(size) == 1 and not isinstance(
            size[0], int) else size)
        if chain_constant and shape:
            x = np.broadcast_to(fn(shape[1:]), shape)
        else:
            x = fn(shape)
        return torch.tensor(np.array(x), dtype=dtype or torch.float32,
                            device=device)

    def randn(*size, generator=None, dtype=None, device=None, **k):
        return draw(fixed_normal, size, dtype, device)

    def rand(*size, generator=None, dtype=None, device=None, **k):
        return draw(fixed_uniform, size, dtype, device)

    def randint(low, high, size, generator=None, device=None, **k):
        u = draw(fixed_uniform, (size,), torch.float64, device)
        return torch.floor(low + (high - low) * u).to(torch.int64)

    monkeypatch.setattr(torch, "randn", randn)
    monkeypatch.setattr(torch, "rand", rand)
    monkeypatch.setattr(torch, "randint", randint)



def patch_jax_smc_rows(monkeypatch) -> None:
    """The JAX package's SMC move draws, keyed per particle by its index
    (`_rowwise_normal`, `_rowwise_uniform`), as fixed draws of the whole
    population's shape: what the port's batch-shaped draws give."""
    import importlib

    jsmc = importlib.import_module("bayesian_ode_tpu.samplers.smc")

    def rowwise_normal(key, position, gidx):
        return jax.tree.map(
            lambda x: jnp.asarray(fixed_normal(x.shape), x.dtype), position)

    def rowwise_uniform(key, gidx, dtype):
        return jnp.asarray(fixed_uniform(gidx.shape), dtype)

    monkeypatch.setattr(jsmc, "_rowwise_normal", rowwise_normal)
    monkeypatch.setattr(jsmc, "_rowwise_uniform", rowwise_uniform)
