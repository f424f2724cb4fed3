"""Online conditioning via additive sufficient statistics (update_data).

The same row-sum invariant that makes DP exact makes online updates exact:
folding new rows into (ΦᵀΦ, Φᵀy, yᵀy, N) and re-solving the 2K×2K system
must equal computing the posterior on the concatenated data from scratch at
the SAME hyperparameters and scalers.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from scfgp import SCFGP
from scfgp.data.datasets import synthetic_gp_rff
from scfgp.models.objective import loss_fn


def _data():
    X, y = synthetic_gp_rff(n=400, d=3, s=4, m=10, noise_std=0.1, seed=0)
    return X, y


def test_update_data_equals_batch_posterior():
    X, y = _data()
    X1, y1, X2, y2 = X[:250], y[:250], X[250:330], y[250:330]

    m = SCFGP(sparsity=4, nfeats=10, seed=0)
    m.fit(X1, y1, max_iter=40)
    m.update_data(X2, y2)

    # From-scratch posterior on the concatenation, same params + scalers.
    Xall = jnp.concatenate([
        jnp.asarray(m.X_scaler.forward_transform(X1), m.dtype),
        jnp.asarray(m.X_scaler.forward_transform(X2), m.dtype)])
    yall = jnp.concatenate([
        jnp.asarray(m.y_scaler.forward_transform(
            y1.reshape(-1, 1)), m.dtype).reshape(-1),
        jnp.asarray(m.y_scaler.forward_transform(
            y2.reshape(-1, 1)), m.dtype).reshape(-1)])
    _, aux = loss_fn(m.params, Xall, yall)
    for a, b in zip(m.post, aux.post):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-8, atol=1e-10)
    assert m.N == 330


def test_update_data_improves_prediction():
    """More observations at fixed hyperparameters must not hurt held-out
    quality on in-family data (weight-space posterior contraction)."""
    X, y = _data()
    Xt, yt = X[:150], y[:150]
    Xn, yn = X[150:330], y[150:330]
    Xv, yv = X[330:], y[330:]

    m = SCFGP(sparsity=4, nfeats=10, seed=0)
    m.fit(Xt, yt, max_iter=60)
    mu0, _ = m.predict(Xv)
    nmse0 = float(np.mean((mu0.ravel() - yv) ** 2) / np.var(yv))
    m.update_data(Xn, yn)
    mu1, _ = m.predict(Xv)
    nmse1 = float(np.mean((mu1.ravel() - yv) ** 2) / np.var(yv))
    assert nmse1 < nmse0 * 1.05, (nmse0, nmse1)


def test_update_data_before_fit_raises():
    m = SCFGP(sparsity=4, nfeats=10, seed=0)
    X, y = _data()
    with pytest.raises(RuntimeError, match="update_data"):
        m.update_data(X[:10], y[:10])


def test_update_data_stale_after_retrain():
    """A later optimize() retrains params; a subsequent update must rebuild
    the stats at the NEW params, not reuse the stale cache."""
    X, y = _data()
    m = SCFGP(sparsity=4, nfeats=10, seed=0)
    m.fit(X[:200], y[:200], max_iter=20)
    m.update_data(X[200:260], y[200:260])
    m.optimize(max_iter=40, resume=True)      # params move
    m.update_data(X[260:300], y[260:300])     # must recompute base stats

    Xall_t = m.X  # model holds all scaled rows
    _, aux = loss_fn(m.params, Xall_t, m.y)
    for a, b in zip(m.post, aux.post):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-8, atol=1e-10)
