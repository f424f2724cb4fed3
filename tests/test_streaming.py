"""Streaming blockwise objective vs the dense path: value + grad equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scfgp.models.params import init_params
from scfgp.models.objective import loss_fn
from scfgp.ops.streaming import loss_fn_streaming

D, S, M = 4, 3, 6


def _problem(n, seed=0):
    rng = np.random.RandomState(seed)
    X = jnp.asarray(rng.randn(n, D))
    y = jnp.asarray(rng.randn(n))
    p = init_params(jax.random.PRNGKey(seed), D, S, M, jnp.float64)
    return X, y, p


@pytest.mark.parametrize("n,block", [(100, 32), (256, 64), (50, 128),
                                     (97, 32), (130, 64), (255, 16)])
def test_streaming_value_matches_dense(n, block):
    X, y, p = _problem(n)
    c_ref, aux_ref = loss_fn(p, X, y)
    c_str, aux_str = loss_fn_streaming(p, X, y, block_size=block)
    np.testing.assert_allclose(float(c_str), float(c_ref), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(aux_str.post.alpha),
                               np.asarray(aux_ref.post.alpha), rtol=1e-9)


def test_streaming_grad_matches_dense():
    X, y, p = _problem(200, seed=1)
    g_ref = jax.grad(lambda q: loss_fn(q, X, y)[0])(p)
    g_str = jax.jit(jax.grad(
        lambda q: loss_fn_streaming(q, X, y, block_size=64)[0]))(p)
    for name, a, b in zip(g_ref._fields, jax.tree.leaves(g_ref),
                          jax.tree.leaves(g_str)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-8, atol=1e-12, err_msg=name)


def test_streaming_with_weights():
    X, y, p = _problem(90, seed=2)
    w = jnp.asarray((np.arange(90) % 3 != 0).astype(np.float64))
    c_ref, _ = loss_fn(p, X, y, w=w)
    c_str, _ = loss_fn_streaming(p, X, y, w=w, block_size=32)
    np.testing.assert_allclose(float(c_str), float(c_ref), rtol=1e-12)


def test_streaming_sharded_matches_dense():
    """Streaming + DP composition on the 8-device mesh."""
    from jax.sharding import PartitionSpec as P
    from scfgp.parallel.mesh import make_mesh, shard_rows

    X, y, p = _problem(160, seed=3)
    c_ref, _ = loss_fn(p, X, y)
    mesh = make_mesh()
    Xs, ys, ws = shard_rows(mesh, np.asarray(X), np.asarray(y))
    f = jax.jit(jax.shard_map(
        lambda q, Xi, yi, wi: loss_fn_streaming(
            q, Xi, yi, w=wi, block_size=8, axis_name="data")[0],
        mesh=mesh,
        in_specs=(P(), P("data", None), P("data"), P("data")),
        out_specs=P()))
    np.testing.assert_allclose(float(f(p, Xs, ys, ws)), float(c_ref),
                               rtol=1e-12)
