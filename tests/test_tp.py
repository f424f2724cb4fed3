"""Feature-axis tensor parallelism: 2-D (data, feature) mesh exactness.

The TP objective (``parallel/tp.py``) must reproduce the single-device loss,
gradient, and training trajectory to float round-off — same bar as the DP
tests (SURVEY.md §4 item 4), now with the feature axis sharded too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scfgp.models.objective import loss_fn
from scfgp.models.params import init_params
from scfgp.opt.optimizers import make_optimizer, tree_add
from scfgp.parallel.mesh import make_mesh2d
from scfgp.parallel.tp import tp_loss, make_tp_train_step, shard_rows_2d

N, D, S, M = 97, 5, 4, 12  # S+M = 16: divisible by feature-axis sizes 2 and 4


def _problem(seed=0, dtype=jnp.float64):
    rng = np.random.RandomState(seed)
    X = jnp.asarray(rng.randn(N, D), dtype)
    y = jnp.asarray(rng.randn(N), dtype)
    params = init_params(jax.random.PRNGKey(seed), D, S, M, dtype)
    return X, y, params


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_tp_loss_equals_single_device(shape):
    mesh = make_mesh2d(*shape)
    X, y, params = _problem()
    cost_ref, aux_ref = loss_fn(params, X, y)
    Xs, ys, ws = shard_rows_2d(mesh, np.asarray(X), np.asarray(y))
    cost_tp, aux_tp = jax.jit(tp_loss(mesh))(params, Xs, ys, ws)
    np.testing.assert_allclose(float(cost_tp), float(cost_ref), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(aux_tp.post.alpha),
                               np.asarray(aux_ref.post.alpha), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(aux_tp.post.L),
                               np.asarray(aux_ref.post.L),
                               rtol=1e-8, atol=1e-10)


def test_tp_gradient_equals_single_device():
    mesh = make_mesh2d(4, 2)
    X, y, params = _problem(1)
    g_ref = jax.grad(lambda p: loss_fn(p, X, y)[0])(params)
    Xs, ys, ws = shard_rows_2d(mesh, np.asarray(X), np.asarray(y))
    f = tp_loss(mesh)
    g_tp = jax.jit(jax.grad(lambda p: f(p, Xs, ys, ws)[0]))(params)
    for a, b in zip(jax.tree.leaves(g_ref), jax.tree.leaves(g_tp)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-7, atol=1e-11)


def test_tp_training_trajectory_matches_single_device():
    X, y, params = _problem(2)
    tx = make_optimizer("adam", {"learning_rate": 0.01})

    p_ref, st = params, tx.init(params)
    step_ref = jax.jit(lambda p, s: _one_step(tx, p, s, X, y))
    for _ in range(15):
        p_ref, st = step_ref(p_ref, st)

    mesh = make_mesh2d(2, 4)
    Xs, ys, ws = shard_rows_2d(mesh, np.asarray(X), np.asarray(y))
    tp_step = make_tp_train_step(tx, mesh)
    p_tp, st_tp = params, tx.init(params)
    for _ in range(15):
        p_tp, st_tp, cost = tp_step(p_tp, st_tp, Xs, ys, ws)

    for a, b in zip(jax.tree.leaves(p_ref), jax.tree.leaves(p_tp)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-6, atol=1e-9)


def test_tp_requires_divisible_features():
    mesh = make_mesh2d(2, 4)
    X, y, _ = _problem()
    params = init_params(jax.random.PRNGKey(0), D, 3, 10, jnp.float64)  # 13
    Xs, ys, ws = shard_rows_2d(mesh, np.asarray(X), np.asarray(y))
    with pytest.raises(AssertionError, match="divisible"):
        jax.jit(tp_loss(mesh))(params, Xs, ys, ws)


def _one_step(tx, p, s, X, y):
    g = jax.grad(lambda q: loss_fn(q, X, y)[0])(p)
    delta, s = tx.update(g, s, p)
    return tree_add(p, delta), s
