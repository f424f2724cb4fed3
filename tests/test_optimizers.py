"""Optimizer update rules vs closed-form single/double steps.

SURVEY.md §4 item 1: each algorithm checked against hand-computed updates with
the reference's exact formulas (``reference: SCFGP/Optimizer.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from scfgp.opt import optimizers as O


def _step(tx, params, grads, n=1):
    state = tx.init(params)
    for _ in range(n):
        delta, state = tx.update(grads, state, params)
        params = O.tree_add(params, delta)
    return np.asarray(params)


P0 = jnp.asarray([1.0, -2.0, 0.5])
G = jnp.asarray([0.1, -0.3, 0.02])


def test_sgd():
    got = _step(O.sgd(learning_rate=0.1), P0, G)
    np.testing.assert_allclose(got, np.asarray(P0) - 0.1 * np.asarray(G))


def test_adagrad():
    lr, eps = 0.05, 1e-6
    g = np.asarray(G)
    accu = g**2
    want = np.asarray(P0) - lr * g / np.sqrt(accu + eps)
    got = _step(O.adagrad(learning_rate=lr, epsilon=eps), P0, G)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_rmsprop_two_steps():
    lr, rho, eps = 0.05, 0.9, 1e-6
    g = np.asarray(G)
    p = np.asarray(P0)
    accu = np.zeros(3)
    for _ in range(2):
        accu = rho * accu + (1 - rho) * g**2
        p = p - lr * g / np.sqrt(accu + eps)
    got = _step(O.rmsprop(learning_rate=lr, rho=rho, epsilon=eps), P0, G, n=2)
    np.testing.assert_allclose(got, p, rtol=1e-6)


def test_adadelta():
    lr, rho, eps = 1.0, 0.95, 1e-6
    g = np.asarray(G)
    accu = (1 - rho) * g**2
    upd = g * np.sqrt(0 + eps) / np.sqrt(accu + eps)
    want = np.asarray(P0) - lr * upd
    got = _step(O.adadelta(learning_rate=lr, rho=rho, epsilon=eps), P0, G)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_adam_reference_epsilon_placement():
    """delta = -lr*sqrt(1-b2^t)/(1-b1^t) * m/(sqrt(v)+eps), Optimizer.py:318-326."""
    lr, b1, b2, eps = 0.01, 0.9, 0.99, 1e-8
    g = np.asarray(G)
    m = (1 - b1) * g
    v = (1 - b2) * g**2
    a_t = lr * np.sqrt(1 - b2) / (1 - b1)
    want = np.asarray(P0) - a_t * m / (np.sqrt(v) + eps)
    got = _step(O.adam(learning_rate=lr, beta1=b1, beta2=b2, epsilon=eps),
                P0, G)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_adamax():
    lr, b1, b2, eps = 0.01, 0.9, 0.999, 1e-8
    g = np.asarray(G)
    m = (1 - b1) * g
    u = np.maximum(0.0, np.abs(g))
    a_t = lr / (1 - b1)
    want = np.asarray(P0) - a_t * m / (u + eps)
    got = _step(O.adamax(learning_rate=lr, beta1=b1, beta2=b2, epsilon=eps),
                P0, G)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_nesterov_momentum_composition():
    """Two steps of sgd+nesterov vs hand-derivation of Optimizer.py:62-97."""
    lr, mom = 0.1, 0.9
    g = np.asarray(G)
    p = np.asarray(P0)
    v = np.zeros(3)
    for _ in range(2):
        delta = -lr * g
        v = mom * v + delta
        p = p + mom * v + delta
    tx = O.apply_nesterov_momentum(O.sgd(learning_rate=lr), momentum=mom)
    got = _step(tx, P0, G, n=2)
    np.testing.assert_allclose(got, p, rtol=1e-6)


def test_momentum_composition():
    lr, mom = 0.1, 0.9
    g = np.asarray(G)
    p = np.asarray(P0)
    v = np.zeros(3)
    for _ in range(3):
        v = mom * v - lr * g
        p = p + v
    tx = O.apply_momentum(O.sgd(learning_rate=lr), momentum=mom)
    got = _step(tx, P0, G, n=3)
    np.testing.assert_allclose(got, p, rtol=1e-6)


def test_make_optimizer_rejects_unknown():
    with pytest.raises(ValueError):
        O.make_optimizer("norm_constraint")


def test_works_on_pytrees():
    params = {"w": jnp.ones((2, 2)), "b": jnp.zeros(2)}
    grads = {"w": jnp.full((2, 2), 0.5), "b": jnp.ones(2)}
    tx = O.make_optimizer("adam", {"learning_rate": 0.01})
    state = tx.init(params)
    delta, state = tx.update(grads, state, params)
    assert delta["w"].shape == (2, 2) and delta["b"].shape == (2,)
