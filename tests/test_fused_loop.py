"""Fused device-side training loop vs the host-loop reference semantics."""

import jax
import jax.numpy as jnp
import numpy as np

from scfgp import SCFGP
from scfgp.data.datasets import synthetic_gp_rff
from scfgp.models.objective import loss_fn
from scfgp.opt.optimizers import make_optimizer
from scfgp.opt.fused_loop import fused_optimize


def test_fused_matches_host_loop_without_annealing():
    """With annealing disabled by a huge max_cvrg, fused and host loops run
    the same sequence of adam+nesterov steps."""
    X, y = synthetic_gp_rff(n=150, d=3, s=3, m=6, seed=0, dtype=np.float32)
    X, y = jnp.asarray(X), jnp.asarray(y)
    from scfgp.models.params import init_params
    params = init_params(jax.random.PRNGKey(0), 3, 3, 6, jnp.float32)
    tx = make_optimizer("adam", {"learning_rate": 0.01})

    vg = jax.value_and_grad(
        lambda p: (lambda c, a: (c, a.post))(*loss_fn(p, X, y)), has_aux=True)
    res = jax.jit(lambda p, k: fused_optimize(
        vg, tx, p, k, max_iter=25, cvrg_tol=1e-9, max_cvrg=10**6))(
        params, jax.random.PRNGKey(1))

    # host reference
    from scfgp.opt.optimizers import tree_add
    p_ref, st = params, tx.init(params)
    costs = []
    for _ in range(25):
        (cost, post), g = vg(p_ref)
        delta, st = tx.update(g, st, p_ref)
        p_ref = tree_add(p_ref, delta)
        costs.append(float(cost))
    np.testing.assert_allclose(np.asarray(res.cost_history)[:25], costs,
                               rtol=2e-5)
    assert int(res.num_iters) == 25


def test_fit_fast_end_to_end():
    X, y = synthetic_gp_rff(n=400, d=4, s=5, m=15, noise_std=0.1, seed=1)
    m = SCFGP(sparsity=8, nfeats=20, seed=0)
    m.fit_fast(X[:320], y[:320], X[320:], y[320:], max_iter=200,
               cvrg_tol=1e-5)
    nmse = m.evals["NMSE"][1][m.min_obj_ind]
    assert nmse < 0.15, nmse
    mu, std = m.predict(X[320:])
    assert mu.shape[0] == 80


def test_fit_fast_with_validation_objective():
    X, y = synthetic_gp_rff(n=300, d=3, s=4, m=10, noise_std=0.1, seed=2)
    m = SCFGP(sparsity=6, nfeats=12, seed=0)
    m.fit_fast(X[:240], y[:240], X[240:], y[240:], max_iter=120,
               obj="NMSE")
    assert np.isfinite(m.evals["NMSE"][1][m.min_obj_ind])


def test_fused_early_stopping_triggers():
    X, y = synthetic_gp_rff(n=120, d=2, s=2, m=4, seed=3, dtype=np.float32)
    X, y = jnp.asarray(X), jnp.asarray(y)
    from scfgp.models.params import init_params
    params = init_params(jax.random.PRNGKey(2), 2, 2, 4, jnp.float32)
    tx = make_optimizer("adam", {"learning_rate": 0.01})
    vg = jax.value_and_grad(
        lambda p: (lambda c, a: (c, a.post))(*loss_fn(p, X, y)), has_aux=True)
    res = jax.jit(lambda p, k: fused_optimize(
        vg, tx, p, k, max_iter=500, cvrg_tol=10.0, max_cvrg=3))(
        params, jax.random.PRNGKey(3))
    # cvrg_tol=10 counts every improvement as negligible -> stop right after
    # the iter>30 gate opens.
    assert int(res.num_iters) < 40


def test_fused_runner_cached_across_models():
    """Two models with the same config/shapes must share ONE jitted runner
    with ONE trace (the reference's compiled-function-reuse across model
    instances, SCFGP.py:150-151; a fresh jit per fit would retrace)."""
    from scfgp.models.model import _FUSED_RUNNERS
    from scfgp import SCFGP

    _FUSED_RUNNERS.clear()
    X, y = synthetic_gp_rff(n=200, d=3, s=3, m=8, seed=5)
    runners = set()
    for seed in (0, 1):
        m = SCFGP(sparsity=4, nfeats=8, seed=seed)
        m.fit_fast(X[:160], y[:160], max_iter=40)
        assert len(_FUSED_RUNNERS) == 1
        runners.add(id(next(iter(_FUSED_RUNNERS.values()))))
    assert len(runners) == 1
    run = next(iter(_FUSED_RUNNERS.values()))
    if hasattr(run, "_cache_size"):
        assert run._cache_size() == 1  # one trace, two fits


def test_validated_fused_runner_reused_across_models():
    """Round-1 weakness: obj='SCORE' fused fits re-jitted per model because
    scaler constants were baked in.  Now the runner is cached by static
    config with data + scaler state traced, so a second same-shape model
    (fresh split, fresh scalers) must hit the same compiled program."""
    import numpy as np
    from scfgp import SCFGP
    from scfgp.models import model as model_mod
    from scfgp.data.datasets import load_boston

    model_mod._FUSED_RUNNERS.clear()
    for seed in (0, 1):
        Xt, yt, Xv, yv, _ = load_boston(seed=seed)
        m = SCFGP(sparsity=4, nfeats=6, seed=seed)
        m.fit_fast(Xt, yt, Xv, yv, obj="SCORE", max_iter=25)
    vals = [v for k, v in model_mod._FUSED_RUNNERS.items() if k[0] == "val"]
    assert len(vals) == 1
    # one traced/compiled specialization total, shared by both models
    assert vals[0]._cache_size() == 1
