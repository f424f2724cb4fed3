"""Distributed-exactness tests on the virtual 8-device CPU mesh.

SURVEY.md §4 item 4: sharded sufficient-statistic training must match
single-device full batch (loss, gradient, and full training trajectories),
for both the GSPMD and the explicit shard_map path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scfgp.models.params import init_params
from scfgp.models.objective import loss_fn
from scfgp.opt.optimizers import make_optimizer, tree_add
from scfgp.parallel.mesh import make_mesh, shard_rows
from scfgp.parallel.dp import (make_dp_train_step, make_dp_eval,
                               shardmap_loss)

N, D, S, M = 103, 6, 4, 9  # N deliberately not divisible by 8 (pad path)


def _problem(seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, D)
    y = rng.randn(N)
    params = init_params(jax.random.PRNGKey(seed), D, S, M, jnp.float64)
    return jnp.asarray(X), jnp.asarray(y), params


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    return make_mesh()


@pytest.mark.parametrize("mode", ["gspmd", "shard_map"])
def test_sharded_loss_equals_single_device(mesh, mode):
    X, y, params = _problem()
    cost_ref, _ = loss_fn(params, X, y)
    Xs, ys, ws = shard_rows(mesh, np.asarray(X), np.asarray(y))
    cost_dp, post = make_dp_eval(mesh, mode)(params, Xs, ys, ws)
    np.testing.assert_allclose(float(cost_dp), float(cost_ref), rtol=1e-12)
    # Posterior matches too
    _, aux = loss_fn(params, X, y)
    np.testing.assert_allclose(np.asarray(post.alpha),
                               np.asarray(aux.post.alpha), rtol=1e-9)


@pytest.mark.parametrize("mode", ["gspmd", "shard_map"])
def test_sharded_gradient_equals_single_device(mesh, mode):
    X, y, params = _problem(1)
    g_ref = jax.grad(lambda p: loss_fn(p, X, y)[0])(params)
    Xs, ys, ws = shard_rows(mesh, np.asarray(X), np.asarray(y))
    if mode == "shard_map":
        f = shardmap_loss(mesh)
    else:
        f = lambda p, Xs, ys, ws: loss_fn(p, Xs, ys, w=ws)[0:2]
    g_dp = jax.jit(jax.grad(lambda p: f(p, Xs, ys, ws)[0]))(params)
    for a, b in zip(jax.tree.leaves(g_ref), jax.tree.leaves(g_dp)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("mode", ["gspmd", "shard_map"])
def test_training_trajectory_matches_single_device(mesh, mode):
    """20 adam+nesterov steps sharded vs single-device: params must agree."""
    X, y, params = _problem(2)
    tx = make_optimizer("adam", {"learning_rate": 0.01})

    # single-device reference trajectory
    p_ref, st = params, tx.init(params)
    step_ref = jax.jit(lambda p, s: _one_step(tx, p, s, X, y))
    for _ in range(20):
        p_ref, st = step_ref(p_ref, st)

    # sharded trajectory
    Xs, ys, ws = shard_rows(mesh, np.asarray(X), np.asarray(y))
    dp_step = make_dp_train_step(tx, mesh, mode)
    p_dp, st_dp = params, tx.init(params)
    for _ in range(20):
        p_dp, st_dp, cost, post = dp_step(p_dp, st_dp, Xs, ys, ws)

    for a, b in zip(jax.tree.leaves(p_ref), jax.tree.leaves(p_dp)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-6, atol=1e-9)


def _one_step(tx, p, s, X, y):
    g = jax.grad(lambda q: loss_fn(q, X, y)[0])(p)
    delta, s = tx.update(g, s, p)
    return tree_add(p, delta), s


def test_mesh_shapes(mesh):
    assert mesh.shape == {"data": 8}


def test_model_level_mesh_training_matches_single_device():
    """fit_fast(mesh=...) — model-level multi-chip DP — must reproduce the
    single-device fused fit: same compiled program, rows sharded over the
    8-device mesh with zero-weight padding, GSPMD-inserted psums."""
    import numpy as np
    from scfgp import SCFGP
    from scfgp.data.datasets import synthetic_gp_rff
    from scfgp.parallel.mesh import make_mesh

    X, y = synthetic_gp_rff(n=220, d=3, s=3, m=8, noise_std=0.1, seed=0)
    Xt, yt, Xv, yv = X[:180], y[:180], X[180:], y[180:]

    a = SCFGP(sparsity=3, nfeats=8, seed=5)
    a.fit_fast(Xt, yt, Xv, yv, max_iter=40)
    b = SCFGP(sparsity=3, nfeats=8, seed=5)
    b.fit_fast(Xt, yt, Xv, yv, max_iter=40, mesh=make_mesh())

    # Same math; the psum reduction order differs from the single-device
    # row sum, and 40 adam steps amplify the f64 rounding delta — tolerance
    # covers order-of-summation noise, not model drift.
    for pa, pb in zip(a.params, b.params):
        np.testing.assert_allclose(np.asarray(pa), np.asarray(pb),
                                   rtol=2e-5, atol=1e-7)
    assert np.allclose(a.evals["NMSE"][1][-1], b.evals["NMSE"][1][-1],
                       rtol=1e-4)
